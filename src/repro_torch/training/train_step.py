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
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import pytree
from repro_torch.training.optimizer import Optimizer, global_norm


def _split_micro(batch, accum: int) -> list:
    for x in pytree.leaves(batch):
        if x.shape[0] % accum:
            raise ValueError(f"batch of {x.shape[0]} does not split into {accum} "
                             "microbatches")
    return [pytree.map(lambda x: x.chunk(accum)[i], batch) for i in range(accum)]


def make_train_step(loss_fn: Callable, optimizer: Optimizer, accum: int = 1):
    def grads_of(params, batch, generator):
        ps = [p.detach().requires_grad_() for p in pytree.leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(pytree.unflatten(params, ps), batch, generator)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]
        return loss.detach(), metrics, grads

    def train_step(params, opt_state, batch, generator=None):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch, generator)
        else:
            grads, loss, ms = None, 0.0, []
            for mb in _split_micro(batch, accum):
                l, m, g = grads_of(params, mb, generator)
                grads = [x.float() for x in g] if grads is None else \
                    torch._foreach_add(grads, g)
                loss, ms = loss + l, ms + [m]
            torch._foreach_div_(grads, accum)
            loss = loss / accum
            metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms]).mean()
                       for k in ms[0]}
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
