"""Train-step factory: gradient accumulation, the NaN guard, the optimizer
update (the JAX package's ``repro.training.train_step``).

``make_train_step(loss_fn, optimizer, accum)`` builds

    train_step(params, opt_state, batch, generator) -> (params, opt_state, metrics)

with ``loss_fn(params, batch, generator) -> (loss, metrics)``.  The batch's
leading axis is split into ``accum`` microbatches, one backward each (the
peak memory of one microbatch), and the gradients are averaged.  A
microbatch's random draws come from its slice of the batch where the batch
carries them (injected), else from ``generator``, one microbatch after the
other (the reference splits its key per microbatch instead).

The NaN guard: where the loss or any gradient is not finite, params and
optimizer state pass through unchanged (``metrics["finite"]`` is False);
the rollback after repeated bad steps lives in ``repro_torch.training.loop``.
Params come back updated in place; they never require grad outside a step.
``pre_split``: the batch's leaves already carry the (accum, micro, ...)
leading axes (the JAX launcher's microbatches, laid out before the step).

With a ``MeshLayout`` the step runs on one rank of a mesh of ranks (the
JAX package's step under ``jit`` with shardings, which computes the same
function as the unsharded step):

  * the rank takes its (pod, data) block of each microbatch; the loss
    takes its statistics of the whole batch (a mask's count, the MoE's
    routing fractions) over those ranks (``MeshLayout.batch_group``);
  * the leaves its layout shards are gathered whole, once a step before
    the forward, except those the blocks compute tensor-parallel on
    (``sharding.tp_paths``: a rank's head and hidden blocks, with the
    Megatron pair over the ``model`` group inside the blocks);
  * each leaf's gradient is averaged over the batch axes into the rank's
    block of AdamW's layout (``reduce_scatter`` where that layout cuts an
    axis, psum where it does not; a dim the layout cuts over ``model`` is
    replicated there and is sliced);
  * the clip's norm is the whole gradient's (``mesh_global_norm``), the
    NaN guard's flag and the loss are agreed over every rank before any
    rank skips, the update runs on the shards, and the slices a ZeRO-1
    state cuts finer than the params are all-gathered over ``data``.

Every rank's replicated leaves keep the same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import pytree
from repro_torch.distributed import sharding
from repro_torch.training.optimizer import Optimizer, global_norm, mesh_global_norm

BATCH_AXES = sharding.BATCH_AXES


def _split_micro(batch, accum: int) -> list:
    for x in pytree.leaves(batch):
        if x.shape[0] % accum:
            raise ValueError(f"batch of {x.shape[0]} does not split into {accum} "
                             "microbatches")
    return [pytree.map(lambda x: x.chunk(accum)[i], batch) for i in range(accum)]


def _microbatches(batch, accum: int, pre_split: bool) -> list:
    if accum == 1:
        return [batch]
    if not pre_split:
        return _split_micro(batch, accum)
    for x in pytree.leaves(batch):
        if x.shape[0] != accum:
            raise ValueError(f"a pre-split batch leads with {x.shape[0]} microbatches, "
                             f"not {accum}")
    return [pytree.map(lambda x: x[i], batch) for i in range(accum)]


def _grads_of(loss_fn, params, batch, generator):
    ps = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(pytree.unflatten(params, ps), batch, generator)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
    return loss.detach(), metrics, grads


def _accumulated(loss_fn, params, micro: list, generator):
    """(loss, metrics, grads) averaged over the microbatches, the gradients
    summed in float32."""
    if len(micro) == 1:
        return _grads_of(loss_fn, params, micro[0], generator)
    grads, loss, ms = None, 0.0, []
    for mb in micro:
        l, m, g = _grads_of(loss_fn, params, mb, generator)
        grads = [x.float() for x in g] if grads is None else torch._foreach_add(grads, g)
        loss, ms = loss + l, ms + [m]
    torch._foreach_div_(grads, len(micro))
    metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms]).mean() for k in ms[0]}
    return loss / len(micro), metrics, grads


def make_train_step(loss_fn: Callable, optimizer: Optimizer, accum: int = 1,
                    pre_split: bool = False, layout: "MeshLayout | None" = None):
    """The step; with ``layout`` a ``MeshStep`` on this rank of its mesh."""
    if layout is not None:
        return MeshStep(loss_fn, optimizer, accum, pre_split, layout)

    def train_step(params, opt_state, batch, generator=None):
        loss, metrics, grads = _accumulated(loss_fn, params,
                                            _microbatches(batch, accum, pre_split), generator)
        finite = bool(torch.stack([torch.isfinite(loss)]
                                  + [torch.isfinite(g).all() for g in grads]).all())
        grads = pytree.unflatten(params, grads)
        if finite:
            params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
        else:
            opt_metrics = {"grad_norm": global_norm(grads),
                           "lr": optimizer.schedule(opt_state["step"] + 1)}
        return params, opt_state, dict(metrics, loss=loss, finite=finite, **opt_metrics)

    return train_step


# ------------------------------------------------------------------- meshes


@dataclasses.dataclass
class MeshLayout:
    """A mesh trainer's layout on one rank: the ``MeshGroups`` (its
    ``model`` group the blocks' ``tp_axis``), the params' specs, AdamW's
    (``{"mu", "nu", "step"}``, each of mu / nu naming at least the axes of
    the param's spec on each dim) and the paths computed tensor-parallel."""

    mesh: object
    params: dict
    opt: dict
    tp: frozenset = frozenset()

    @property
    def tp_group(self):
        """The ``model`` group where some leaf is computed tensor-parallel."""
        if not self.tp or "model" not in self.mesh.axis_names:
            return None
        return self.mesh.group("model")

    @property
    def batch_group(self):
        """The (pod, data) ranks that split the batch, where there are
        several: the loss's mean and the MoE's aux loss span them."""
        axes = tuple(a for a in BATCH_AXES if a in self.mesh.axis_names)
        return self.mesh.group(axes) if self.mesh.size(axes) > 1 else None

    def shard(self, params):
        return sharding.shard_params(params, self.params, self.mesh)

    def gather(self, params, opt_state):
        """The whole params and AdamW state from every rank's blocks (a
        collective)."""
        return (sharding.gather_params(params, self.params, self.mesh),
                {"mu": sharding.gather_params(opt_state["mu"], self.opt["mu"], self.mesh),
                 "nu": sharding.gather_params(opt_state["nu"], self.opt["nu"], self.mesh),
                 "step": opt_state["step"]})

    def specs(self) -> dict:
        """The layout of ``{"params": ..., "opt": ...}``, as a checkpoint
        holds them."""
        return {"params": self.params, "opt": self.opt}

    def resident_bytes(self, shapes, specs, itemsize: int = 4) -> int:
        """What a rank holds of a tree of ``shapes`` under ``specs``."""
        return sharding.local_bytes(shapes, specs, self.mesh, itemsize)


def _extra_dims(param_spec, opt_spec, path) -> list:
    """(dim, axes) where AdamW's spec cuts a dim the param's does not."""
    out = []
    for dim in range(max(len(param_spec), len(opt_spec))):
        p = param_spec[dim] if dim < len(param_spec) else None
        o = opt_spec[dim] if dim < len(opt_spec) else None
        if p == o:
            continue
        if p is not None:
            raise ValueError(f"{'.'.join(path)}: AdamW's spec {opt_spec} does not refine "
                             f"the param's {param_spec}")
        out.append((dim, o))
    return out


class MeshStep:
    """The train step on one rank of a mesh (see the module docstring):
    ``step(params, opt_state, batch, generator)`` with this rank's blocks
    of the params and of AdamW's state, and the whole global batch."""

    def __init__(self, loss_fn, optimizer: Optimizer, accum: int, pre_split: bool,
                 layout: MeshLayout):
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.accum, self.pre_split, self.layout = accum, pre_split, layout
        mesh = layout.mesh
        self.mesh = mesh
        self.batch_axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
        self.n_batch = mesh.size(self.batch_axes)
        paths = [p for p, _ in pytree.paths(layout.params)]
        self._pspecs = pytree.leaves(layout.params)
        self._ospecs = pytree.leaves(layout.opt["mu"])
        # the dim of each tensor-parallel leaf its layout cuts over "model"
        self._tp_dim = sharding.tp_dims(layout.params, layout.tp)
        self._extra = [_extra_dims(ps, os_, p)
                       for p, ps, os_ in zip(paths, self._pspecs, self._ospecs)]
        # the axes each leaf's gradient block is cut on (the clip's psums)
        self._grad_axes = [tuple(a for a in mesh.axis_names
                                 if a in sharding.spec_axes(o) and mesh.size(a) > 1)
                           for o in self._ospecs]

    # -- pieces -----------------------------------------------------------

    def local_batches(self, batch) -> list:
        """This rank's (pod, data) block of each microbatch."""
        micro = _microbatches(batch, self.accum, self.pre_split)
        if self.n_batch == 1:
            return micro
        idx = self.mesh.index(self.batch_axes)

        def block(x):
            if x.shape[0] % self.n_batch:
                raise ValueError(f"a microbatch of {x.shape[0]} does not split over the "
                                 f"{self.n_batch} ranks of {self.batch_axes}")
            n = x.shape[0] // self.n_batch
            return x[idx * n:(idx + 1) * n]

        return [pytree.map(block, mb) for mb in micro]

    def compute_params(self, params):
        """The leaves the forward reads: gathered whole, or this rank's
        block where the blocks compute tensor-parallel on it
        (``sharding.gather_at_use``, which the server takes too)."""
        return sharding.gather_at_use(params, self.layout.params, self.layout.tp, self.mesh)

    def _reduce(self, g, i):
        """Leaf i's gradient (whole, or its tensor-parallel block) ->
        this rank's block of AdamW's layout of the mean over the batch
        axes."""
        mesh, sizes = self.mesh, self.mesh.sizes()
        scattered = set()
        for dim, entry in enumerate(self._ospecs[i]):
            if entry is None or dim == self._tp_dim[i]:
                continue
            axes = sharding.entry_mesh_axes(mesh, entry)
            if mesh.size(axes) == 1:
                continue
            lead, rest = g.shape[:dim], g.shape[dim + 1:]
            k = [sizes[a] for a in axes]
            v = g.reshape(lead + tuple(k) + (g.shape[dim] // math.prod(k),) + rest)
            for j in reversed(range(len(axes))):  # replicated axes: this rank's block
                if axes[j] not in BATCH_AXES:
                    v = v.select(dim + j, mesh.coords[axes[j]])
            g = v.reshape(lead + (-1,) + rest)
            over = tuple(a for a in axes if a in BATCH_AXES and sizes[a] > 1)
            if over:
                g = mesh.group(over).reduce_scatter(g.contiguous(), dim)
                scattered.update(over)
        rest_axes = tuple(a for a in self.batch_axes if a not in scattered and sizes[a] > 1)
        if rest_axes:
            g = mesh.group(rest_axes).psum(g.contiguous())
        return g / self.n_batch if self.n_batch > 1 else g

    def gradients(self, params, batch, generator=None):
        """(loss, metrics, gradient blocks): the rank's blocks of the mean
        gradient, in AdamW's layout, and the loss and metrics of its own
        batch block."""
        loss, metrics, grads = _accumulated(self.loss_fn, self.compute_params(params),
                                            self.local_batches(batch), generator)
        blocks = [self._reduce(g.float(), i) for i, g in enumerate(grads)]
        return loss, metrics, pytree.unflatten(params, blocks)

    def _agreed(self, loss, metrics, blocks):
        """The loss and metrics averaged over the batch blocks, and whether
        every rank's loss and gradient blocks are finite: one psum over
        every rank (each value is the same on a batch block's model
        ranks)."""
        keys = sorted(k for k, v in metrics.items() if torch.as_tensor(v).numel() == 1)
        bad = ~torch.stack([torch.isfinite(loss)]
                           + [torch.isfinite(g).all() for g in pytree.leaves(blocks)]).all()
        vec = torch.stack([loss.float().reshape(())]
                          + [torch.as_tensor(metrics[k], device=loss.device).float().reshape(())
                             for k in keys] + [bad.float()])
        world = self.mesh.world
        if world > 1:
            vec = self.mesh.group(self.mesh.axis_names).psum(vec)
        mean = vec[:-1] / world
        out = {k: mean[1 + j] * (self.n_batch if k == "tokens" else 1)
               for j, k in enumerate(keys)}
        return mean[0], out, bool(vec[-1] == 0)

    def __call__(self, params, opt_state, batch, generator=None):
        return self.apply(params, opt_state, *self.gradients(params, batch, generator))

    def apply(self, params, opt_state, loss, metrics, blocks):
        """The rest of the step after ``gradients``: the agreed loss and
        NaN guard, the clip's norm, the update on the shards."""
        loss, metrics, finite = self._agreed(loss, metrics, blocks)
        gnorm = mesh_global_norm(blocks, self._grad_axes, self.mesh)
        if finite:
            views = list(pytree.leaves(params))
            for i, extra in enumerate(self._extra):
                for dim, entry in extra:
                    axes = sharding.entry_mesh_axes(self.mesh, entry)
                    n = views[i].shape[dim] // self.mesh.size(axes)
                    views[i] = views[i].narrow(dim, self.mesh.index(axes) * n, n)
            _, opt_state, opt_metrics = self.optimizer.update(
                blocks, opt_state, pytree.unflatten(params, views), gnorm=gnorm)
            for leaf, view, extra in zip(pytree.leaves(params), views, self._extra):
                for dim, entry in extra:  # ZeRO-1: the data ranks' updated slices
                    axes = sharding.entry_mesh_axes(self.mesh, entry)
                    leaf.copy_(self.mesh.group(axes).all_gather(view, dim))
        else:
            opt_metrics = {"grad_norm": gnorm,
                           "lr": self.optimizer.schedule(opt_state["step"] + 1)}
        return params, opt_state, dict(metrics, loss=loss, finite=finite, **opt_metrics)
