"""Residual blocks.  Only the ``attn`` block with the dense FFN is ported:
pre-norm attention, then a pre-norm SwiGLU FFN, each added to the stream."""

from __future__ import annotations

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.nn import attention as attn
from repro_torch.nn.ffn import ffn_apply
from repro_torch.nn.layers import rmsnorm_apply


def attn_block_fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx):
    """x: (B, L, d) -> (B, L, d).  ``ctx``: dict(causal, impl)."""
    if desc.moe:
        raise NotImplementedError("MoE blocks are not ported yet")
    h = rmsnorm_apply(params["attn_norm"], x)
    x = x + attn.attn_fwd(params["attn"], h, cfg, window=desc.window,
                          causal=ctx.get("causal", True),
                          impl=ctx.get("impl", "flash"))
    if "ffn" in params:
        x = x + ffn_apply(params["ffn"], rmsnorm_apply(params["ffn_norm"], x))
    return x


BLOCKS = {"attn": attn_block_fwd}
