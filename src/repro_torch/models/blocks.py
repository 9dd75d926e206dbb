"""Residual blocks, each a ``Block`` of up to four functions:

    fwd(params, x, cfg, desc, ctx, window)               -> x
    cache_init(params, cfg, desc, batch, max_len, dtype) -> cache
    prefill(params, x, cache, cfg, desc, ctx, window)    -> (x, cache)
    step(params, x1, cache, pos, cfg, desc, window)      -> (x1, cache)

``ctx``: dict(causal, impl).  ``window`` is the layer's Python
int window (0 = full); ``pos`` is a 0-d integer tensor or a Python int.  ``prefill`` and ``step`` update the cache in place
and return it.  Ported: the ``attn`` block (forward only; the denoiser's
block) and the ``hymba`` block (all four).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import ssm
from repro_torch.nn.ffn import ffn_apply
from repro_torch.nn.layers import rmsnorm_apply


class Block(NamedTuple):
    fwd: Callable
    cache_init: Optional[Callable] = None
    prefill: Optional[Callable] = None
    step: Optional[Callable] = None


def _maybe_ffn(params, x):
    """The pre-norm SwiGLU FFN added to the stream, where the block has one."""
    if "ffn" in params:
        x = x + ffn_apply(params["ffn"], rmsnorm_apply(params["ffn_norm"], x))
    return x


def attn_block_fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
    """Pre-norm self-attention, then the FFN: x (B, L, d) -> (B, L, d)."""
    if desc.moe:
        raise NotImplementedError("MoE blocks are not ported yet")
    h = rmsnorm_apply(params["attn_norm"], x)
    x = x + attn.attn_fwd(params["attn"], h, cfg, window=window,
                          causal=ctx.get("causal", True), impl=ctx.get("impl", "flash"))
    return _maybe_ffn(params, x)


# ------------------------------------------------------------------ hymba
# parallel attention and mamba heads on one normed input, mean-fused:
# x + 0.5 * (attn + mamba), then the FFN


def hymba_block_fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
    h = rmsnorm_apply(params["mix_norm"], x)
    a = attn.attn_fwd(params["attn"], h, cfg, window=window,
                      causal=ctx.get("causal", True), impl=ctx.get("impl", "flash"))
    m = ssm.mamba_fwd(params["mamba"], h, cfg)
    return _maybe_ffn(params, x + 0.5 * (a + m))


def hymba_block_cache_init(params, cfg: ModelConfig, desc: BlockDesc, batch: int,
                           max_len: int, dtype):
    return {"kv": attn.init_kv_cache(cfg, batch, max_len, dtype,
                                     device=params["mix_norm"]["scale"].device),
            "ssm": ssm.mamba_init_state(params["mamba"], cfg, batch)}


def _set_state(cache, state):
    for name, t in state.items():
        cache[name].copy_(t)


def hymba_block_prefill(params, x, cache, cfg: ModelConfig, desc: BlockDesc, ctx,
                        window: int):
    h = rmsnorm_apply(params["mix_norm"], x)
    a, _ = attn.attn_prefill(params["attn"], h, cache["kv"], cfg, window=window)
    m, state = ssm.mamba_fwd(params["mamba"], h, cfg, return_state=True)
    _set_state(cache["ssm"], state)
    return _maybe_ffn(params, x + 0.5 * (a + m)), cache


def hymba_block_step(params, x1, cache, pos, cfg: ModelConfig, desc: BlockDesc,
                     window: int):
    """One decode step at ``pos`` (a 0-d integer tensor, or a Python int):
    the attention half writes its cache at ``pos``; the mamba half takes no
    position."""
    h = rmsnorm_apply(params["mix_norm"], x1)
    a, _ = attn.attn_step(params["attn"], h, cache["kv"], pos, cfg, window=window)
    m, state = ssm.mamba_step(params["mamba"], h, cache["ssm"], cfg)
    _set_state(cache["ssm"], state)
    return _maybe_ffn(params, x1 + 0.5 * (a + m)), cache


BLOCKS = {
    "attn": Block(attn_block_fwd),
    "hymba": Block(hymba_block_fwd, hymba_block_cache_init, hymba_block_prefill,
                   hymba_block_step),
}
