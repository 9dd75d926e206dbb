"""Group-loop decoder: ``n_repeats`` iterations of the layer group
(cfg.group).  Each group member's params (and caches) are stacked over
repeats with a leading ``layers`` axis, as in the JAX package; its
``lax.scan`` over that axis is a Python loop here.  Per-repeat windows
(``window_per_repeat``, hymba's three full-attention layers) are Python
ints, so the flash kernel gets a static window in every layer.

The ``ctx`` the forward hands every block carries the serving forward's
model parallelism (``tp_axis``, ``ep_axis``, ``sp_axis``: see
``models/blocks.py``); its collectives run inside the layers.  The JAX
package's GSPMD ``sp`` sharding constraint has no counterpart.

Where ``cfg.remat`` is set and autograd records through a layer, the
layer runs under ``torch.utils.checkpoint``: its activations are recomputed
in the backward instead of kept (the JAX package wraps its group body in
``jax.checkpoint``).  The values are the same either way; only memory
differs."""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.models.blocks import BLOCKS
from repro_torch.pytree import leaves


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _windows(cfg: ModelConfig, desc: BlockDesc) -> tuple:
    if desc.window_per_repeat is None:
        return (int(desc.window),) * cfg.n_repeats
    if len(desc.window_per_repeat) != cfg.n_repeats:
        raise ValueError(f"{cfg.name}: {len(desc.window_per_repeat)} per-repeat windows "
                         f"for {cfg.n_repeats} repeats")
    return tuple(int(w) for w in desc.window_per_repeat)


def _layers(cfg: ModelConfig, part: str):
    """(repeat, group key, the block's ``part`` function, desc, window) for
    every layer in order; raises where a block has no such function, or has
    a MoE FFN in another block than ``attn`` (no arch has one)."""
    fns = []
    for desc in cfg.group:
        if desc.moe and desc.kind != "attn":
            raise NotImplementedError(f"block {desc.kind!r} with a MoE FFN: the port runs "
                                      "the MoE in attn blocks only")
        block = BLOCKS.get(desc.kind)
        fn = getattr(block, part) if block is not None else None
        if fn is None:
            raise NotImplementedError(f"block {desc.kind!r} has no ported {part}")
        fns.append((fn, desc, _windows(cfg, desc)))
    for r in range(cfg.n_repeats):
        for gi, (fn, desc, windows) in enumerate(fns):
            yield r, f"g{gi}", fn, desc, windows[r]


def _records(x, layer) -> bool:
    """Whether autograd records through a layer of input x and params
    ``layer``."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves(layer)))


def decoder_fwd(params, x, cfg: ModelConfig, ctx):
    """x: (B, L, d_model) -> ((B, L, d_model), aux): aux the float32 0-d
    sum of every MoE layer's load-balancing loss (0 without MoE), as the
    JAX package's decoder sums it over the group and the layers.  Under
    remat each layer's checkpointed function returns its own aux, so the
    recompute in the backward adds nothing twice."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r, g, fwd, desc, window in _layers(cfg, "fwd"):
        layer = _layer(params[g], r)
        if cfg.remat and _records(x, layer):
            x, a = checkpoint(functools.partial(fwd, layer), x, cfg, desc, ctx, window,
                              use_reentrant=False)
        else:
            x, a = fwd(layer, x, cfg, desc, ctx, window)
        if "moe_aux_loss" in a:
            aux = aux + a["moe_aux_loss"]
    return x, aux


def decoder_cache_init(params, cfg: ModelConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16):
    """Every layer's cache, stacked over repeats per group member."""
    per = {}
    for r, g, init, desc, _ in _layers(cfg, "cache_init"):
        per.setdefault(g, []).append(init(_layer(params[g], r), cfg, desc, batch, max_len,
                                          dtype))
    return {g: _stack(caches) for g, caches in per.items()}


def decoder_prefill(params, x, caches, cfg: ModelConfig, ctx):
    """Full-sequence forward that fills every cache in place."""
    for r, g, prefill, desc, window in _layers(cfg, "prefill"):
        x, _ = prefill(_layer(params[g], r), x, _layer(caches[g], r), cfg, desc, ctx,
                       window)
    return x, caches


def decoder_step(params, x1, caches, pos, cfg: ModelConfig):
    """Single-token decode through the whole stack at ``pos`` (a 0-d
    integer tensor, or a Python int), caches updated in place."""
    for r, g, step, desc, window in _layers(cfg, "step"):
        x1, _ = step(_layer(params[g], r), x1, _layer(caches[g], r), pos, cfg, desc, window)
    return x1, caches
