"""Vanilla sequential sampler for the affine step family (paper Eq. 5).

The K-model-call baseline that ASD accelerates, and the reference against
which its exactness is checked.  ``model_fn(t: f32[m], y: f32[m, *event])
-> f32[m, *event]`` takes any leading batch size m.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.schedules import Schedule
from repro_torch.device import resolve_device

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


def _run(model_fn: ModelFn, schedule: Schedule, y: torch.Tensor,
         xi: torch.Tensor, keep: Optional[list], conds=None):
    """K steps on a batch of chains: y (m, *event), xi (K, m, *event);
    ``conds`` (m, d_cond) conditions each chain's calls."""
    m = y.shape[0]
    for i in range(schedule.K):
        t = schedule.t_model[i].expand(m)
        g = model_fn(t, y) if conds is None else model_fn(t, y, conds)
        y = schedule.A[i] * y + schedule.B[i] * g + schedule.sigma[i] * xi[i]
        if keep is not None:
            keep.append(y)
    return y


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
    keep = [y0[None]] if return_trajectory else None
    y = _run(model_fn, schedule.to(dev), y0[None], xi[:, None], keep)
    return y[0], None if keep is None else torch.cat(keep)


def sequential_sample_with_noise(model_fn: ModelFn, schedule: Schedule,
                                 y0: torch.Tensor, xi: torch.Tensor,
                                 device=None):
    """Same, with caller-provided per-step noises xi (K, *event)."""
    dev = resolve_device(device)
    return _run(model_fn, schedule.to(dev), y0.to(dev)[None],
                xi.to(dev)[:, None], None)[0]


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
    return _run(model_fn, schedule.to(dev), y0, xi.to(dev), None, conds)
