"""Group-loop decoder: ``n_repeats`` iterations of the layer group
(cfg.group).  Each group member's params are stacked over repeats with a
leading ``layers`` axis, as in the JAX package; its ``lax.scan`` over that
axis is a Python loop here."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import BLOCKS


def _layer(tree, r: int):
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    return tree[r]


def decoder_fwd(params, x, cfg: ModelConfig, ctx):
    """x: (B, L, d_model) -> (B, L, d_model)."""
    for desc in cfg.group:
        if desc.kind not in BLOCKS or desc.window_per_repeat is not None:
            raise NotImplementedError(f"block {desc} is not ported yet")
    for r in range(cfg.n_repeats):
        for gi, desc in enumerate(cfg.group):
            x = BLOCKS[desc.kind](_layer(params[f"g{gi}"], r), x, cfg, desc, ctx)
    return x
