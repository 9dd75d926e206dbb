"""Vanilla sequential sampler for the affine step family (paper Eq. 5).

The K-model-call baseline that ASD accelerates, and the reference against
which its exactness is checked.  Its K steps are a ``SequentialProgram``:
one step replayed K times (on the card a captured CUDA graph).  ``model_fn(t: f32[m], y: f32[m, *event])
-> f32[m, *event]`` takes any leading batch size m.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.schedules import Schedule
from repro_torch.device import resolve_device
from repro_torch.programs import SuperstepProgram

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def init_y0(schedule: Schedule, event_shape, generator=None,
            dtype=torch.float32, device=None, key=None):
    """The chain's start y0 (*event): zeros, or standard normal drawn from
    ``key`` (``prng.normal``, as the JAX package draws it; it runs on the
    key's device) or else from ``generator``."""
    if schedule.y0_mode == "zeros":
        return torch.zeros(tuple(event_shape), dtype=dtype, device=resolve_device(device))
    if key is not None:
        return prng.normal(key, tuple(event_shape)).to(dtype)
    return torch.randn(tuple(event_shape), generator=generator, dtype=dtype,
                       device=resolve_device(device))


class SequentialProgram:
    """The K steps as a program of one step (``repro_torch.programs``), the
    counterpart of the JAX package's ``lax.scan``: on the card one captured
    CUDA graph replayed K times with no host read, on the CPU the step run
    eagerly through the same code.

    The step index is a 0-d device tensor: the step reads ``t_model``,
    ``A``, ``B``, ``sigma`` and ``xi`` at it with ``index_select`` and
    increments it in place.  The program owns the chains y (m, *event) and,
    with ``keep_trajectory``, the (K+1, m, *event) trajectory, whose row
    i+1 step i writes in place.  ``xi`` (K, m, *event) and ``conds``
    (m, d_cond) are read where they are and must not be rebound; ``load``
    copies a fresh batch into all of them."""

    def __init__(self, model_fn: ModelFn, schedule: Schedule, y0: torch.Tensor,
                 xi: torch.Tensor, conds=None, keep_trajectory: bool = False):
        dev = y0.device
        self.K = schedule.K
        self.y = y0.clone()
        self.xi, self.conds = xi, conds
        self.step = step = torch.zeros((), dtype=torch.int64, device=dev)
        self.trajectory = None
        if keep_trajectory:
            self.trajectory = torch.empty((self.K + 1,) + tuple(y0.shape), dtype=y0.dtype,
                                          device=dev)
            self.trajectory[0] = y0
        m = y0.shape[0]
        y, traj = self.y, self.trajectory

        # locals, not self: no cycle keeps a finished call's graph alive
        def body():
            with torch.no_grad():
                i = step.view(1)
                t = schedule.t_model.index_select(0, i).expand(m)
                g = model_fn(t, y) if conds is None else model_fn(t, y, conds)
                y.copy_(schedule.A.index_select(0, i) * y + schedule.B.index_select(0, i) * g
                        + schedule.sigma.index_select(0, i) * xi.index_select(0, i)[0])
                if traj is not None:
                    traj.index_copy_(0, i + 1, y[None])
                step.add_(1)

        self.program = SuperstepProgram(body, dev)

    def load(self, y0: torch.Tensor, xi: torch.Tensor, conds=None) -> None:
        """Copy a fresh batch of chains, its noises and conditions in."""
        self.y.copy_(y0)
        self.xi.copy_(xi)
        if conds is not None:
            self.conds.copy_(conds)
        if self.trajectory is not None:
            self.trajectory[0] = y0

    def run(self) -> torch.Tensor:
        """The K steps from the loaded chains; returns y (the program's own
        tensor, which the next ``load`` overwrites)."""
        self.step.zero_()
        for _ in range(self.K):
            self.program()
        return self.y


def _run(model_fn: ModelFn, schedule: Schedule, y: torch.Tensor, xi: torch.Tensor,
         keep_trajectory: bool = False, conds=None):
    """K steps on a batch of chains: y (m, *event), xi (K, m, *event);
    ``conds`` (m, d_cond) conditions each chain's calls.  Returns (y, the
    trajectory (K+1, m, *event) or None)."""
    prog = SequentialProgram(model_fn, schedule, y, xi, conds, keep_trajectory)
    return prog.run(), prog.trajectory


def sequential_sample(model_fn: ModelFn, schedule: Schedule, y0: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      return_trajectory: bool = False, device=None):
    """Run the K sequential steps of one chain y0 (*event).

    Returns (final sample, trajectory (K+1, *event) or None).  Model calls:
    exactly K.  The step noises are drawn from ``generator`` (which must live
    on ``device``)."""
    dev = resolve_device(device)
    y0 = y0.to(dev)
    xi = torch.randn((schedule.K,) + tuple(y0.shape), generator=generator,
                     dtype=y0.dtype, device=dev)
    y, traj = _run(model_fn, schedule.to(dev), y0[None], xi[:, None], return_trajectory)
    return y[0], None if traj is None else traj[:, 0]


def sequential_sample_with_noise(model_fn: ModelFn, schedule: Schedule,
                                 y0: torch.Tensor, xi: torch.Tensor,
                                 device=None):
    """Same, with caller-provided per-step noises xi (K, *event)."""
    dev = resolve_device(device)
    return _run(model_fn, schedule.to(dev), y0.to(dev)[None], xi.to(dev)[:, None])[0][0]


def sequential_sample_batched(model_fn: ModelFn, schedule: Schedule,
                              y0: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              xi: Optional[torch.Tensor] = None, device=None,
                              conds: Optional[torch.Tensor] = None):
    """B independent chains y0 (B, *event) stepped together: each of the K
    steps is one model call over all B chains.  ``xi`` (K, B, *event) gives
    the noises; else they are drawn from ``generator``.  ``conds``
    (B, d_cond), one condition row a chain, is passed to every call as
    ``model_fn(t, y, conds)``."""
    dev = resolve_device(device)
    y0 = y0.to(dev)
    if conds is not None:
        conds = conds.to(dev)
        if conds.shape[0] != y0.shape[0]:
            raise ValueError(f"conds: {conds.shape[0]} rows for {y0.shape[0]} chains")
    if xi is None:
        xi = torch.randn((schedule.K,) + tuple(y0.shape), generator=generator,
                         dtype=y0.dtype, device=dev)
    return _run(model_fn, schedule.to(dev), y0, xi.to(dev), conds=conds)[0]
