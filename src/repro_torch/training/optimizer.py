"""AdamW, learning-rate schedules and global-norm clipping, with the JAX
package's functional interface (``repro.training.optimizer``):

    opt = adamw(schedule, ...)
    state = opt.init(params)
    params, state, metrics = opt.update(grads, state, params)

Params (float32) and state are nested dicts of tensors; ``update``
changes them in place (``torch._foreach_*``, a group of leaves at a time,
so its temporaries stay small beside the params) and returns them.  The arithmetic is the
reference's: clipping by the float32 global norm, bias correction, and
decoupled weight decay on every leaf with ndim >= 2 -- on the stacked
layer tree that includes the (n, d) norm scales, as in the reference.
On a mesh (``repro_torch.training.train_step``) ``update`` runs on a
rank's shards, which keep their leaf's ndim, with the clip's norm of the
whole gradient from ``mesh_global_norm``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import pytree


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    schedule: Callable  # step -> learning rate (what a skipped step reports)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` * peak
    at ``total``: step (int32 tensor) -> float32 tensor."""
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return lr


def constant_schedule(lr_val: float):
    return lambda step: torch.tensor(lr_val, dtype=torch.float32, device=step.device)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = torch._foreach_norm([x.float() for x in pytree.leaves(tree)])
    return torch.sqrt(sum(n * n for n in sq))


def mesh_global_norm(tree, leaf_axes, mesh) -> torch.Tensor:
    """The global norm of a tree whose leaves are a mesh's blocks of the
    whole (a ZeRO-1 or FSDP shard of the averaged gradient): each leaf's
    local sum of squares is psummed over exactly the axes its block is cut
    on (``leaf_axes``, one tuple a leaf in leaf order; a replicated leaf's
    is empty and counts once), the leaves with the same axes in one psum,
    then the leaves are added in leaf order.  Every rank gets the same
    bits."""
    flat = pytree.leaves(tree)
    sq = torch.stack([n * n for n in torch._foreach_norm([x.float() for x in flat])])
    by_axes = {}
    for i, axes in enumerate(leaf_axes):
        by_axes.setdefault(tuple(axes), []).append(i)
    whole = [None] * len(flat)
    for axes, idx in by_axes.items():
        part = sq[idx]
        if axes:
            part = mesh.group(axes).psum(part)
        for j, i in enumerate(idx):
            whole[i] = part[j]
    return torch.sqrt(sum(whole))


# the float32 bytes of a group of leaves ``update`` takes at once: its
# temporaries (the clipped gradient, the denominator, the step) hold three
# groups, not three copies of the params (a leaf larger than this is a group)
_GROUP_BYTES = 1 << 30


def _groups(leaves):
    """Consecutive runs of (grad, mu, nu, param) tuples of at most
    ``_GROUP_BYTES`` float32 bytes of params each."""
    group, size = [], 0
    for leaf in leaves:
        n = leaf[3].numel() * 4
        if group and size + n > _GROUP_BYTES:
            yield group
            group, size = [], 0
        group.append(leaf)
        size += n
    if group:
        yield group


def adamw(schedule: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        step = torch.zeros((), dtype=torch.int32, device=pytree.leaves(params)[0].device)
        mu, nu = (pytree.map(lambda x: torch.zeros_like(x, dtype=torch.float32), params)
                  for _ in range(2))
        return {"mu": mu, "nu": nu, "step": step}

    @torch.no_grad()
    def update(grads, state, params, gnorm=None):
        """``gnorm``: the whole gradient's global norm, where ``grads`` are
        a mesh rank's shards of it (``mesh_global_norm``); else the norm
        of ``grads``."""
        step = state["step"] + 1
        gnorm = global_norm(grads) if gnorm is None else gnorm
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        t = step.float()
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
        lr = schedule(step)
        leaves = list(zip(*(pytree.leaves(t) for t in (grads, state["mu"], state["nu"],
                                                        params))))
        for group in _groups(leaves):
            g, mu, nu, ps = (list(x) for x in zip(*group))
            g = torch._foreach_mul([x.float() for x in g], scale)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            del g
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            delta = torch._foreach_div(mu, bc1)
            torch._foreach_div_(delta, denom)
            del denom
            mats = [i for i, p in enumerate(ps) if p.ndim >= 2]
            if weight_decay and mats:
                torch._foreach_add_([delta[i] for i in mats], [ps[i].float() for i in mats],
                                    alpha=weight_decay)
            torch._foreach_mul_(delta, lr)
            torch._foreach_sub_(ps, delta)
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update, schedule)
