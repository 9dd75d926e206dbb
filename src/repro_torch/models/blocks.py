"""Residual blocks, each a ``Block`` of up to four functions:

    fwd(params, x, cfg, desc, ctx, window)               -> (x, aux)
    cache_init(params, cfg, desc, batch, max_len, dtype) -> cache
    prefill(params, x, cache, cfg, desc, ctx, window)    -> (x, cache)
    step(params, x1, cache, pos, cfg, desc, window)      -> (x1, cache)

``ctx``: dict(causal, impl, vision, tp_axis, sp_axis, ep_axis,
batch_axis).  The axes carry model parallelism into the ``fwd``
functions, each a ``repro_torch.distributed.group`` ``ModelGroup`` or
absent (the JAX package's mesh axis names): ``tp_axis`` tensor
parallelism in attention and the dense FFN, ``ep_axis`` expert
parallelism in the MoE FFN, ``sp_axis`` Ulysses sequence parallelism (x
is the rank's sequence slice, and the MoE keeps its output local), and
``batch_axis`` the mesh trainer's data-parallel ranks (the MoE's aux
loss is the whole batch's).
``window`` is the layer's Python
int window (0 = full); ``pos`` is a 0-d integer tensor or a Python int.
``aux`` is the MoE FFN's ``{"moe_aux_loss": ()}`` where the block has
one, else ``{}`` (as the JAX package's blocks).  ``prefill`` and ``step``
update the cache in place and return it; they drop ``aux``, as the
JAX package's decoder does.  Ported, all four functions each: the
``attn`` block (the dense archs' and the denoiser's), the ``xattn`` block
(llama-3.2-vision's cross-attention to the vision stub), the ``hymba``
block, and xlstm's ``mlstm`` and ``slstm`` blocks.  The attn block's FFN
may be the MoE (``BlockDesc.moe``: qwen3-moe's and dbrx's, with every
expert on the device); no arch has one elsewhere, and the decoder refuses
it elsewhere.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from repro_torch.configs.base import BlockDesc, ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.nn import attention as attn
from repro_torch.nn import ssm
from repro_torch.nn.ffn import ffn_apply
from repro_torch.nn.layers import rmsnorm_apply
from repro_torch.nn.moe import moe_apply


class Block(NamedTuple):
    fwd: Callable
    cache_init: Optional[Callable] = None
    prefill: Optional[Callable] = None
    step: Optional[Callable] = None


def _maybe_ffn(params, x, cfg: ModelConfig, ctx=None):
    """The pre-norm FFN (SwiGLU or GELU, or the MoE where the params have
    ``moe``) added to the stream, where the block has one: (x, aux), aux
    the MoE's ``{"moe_aux_loss": ()}`` or ``{}``.  ``ctx`` carries the
    model-parallel axes (the forward's; prefill and step pass none)."""
    ctx = ctx or {}
    if "moe" in params:
        h, aux = moe_apply(params["moe"], rmsnorm_apply(params["ffn_norm"], x), cfg,
                           ep_axis=ctx.get("ep_axis"),
                           seq_sharded=ctx.get("sp_axis") is not None,
                           batch_axis=ctx.get("batch_axis"))
        return x + h, aux
    if "ffn" in params:
        x = x + ffn_apply(params["ffn"], rmsnorm_apply(params["ffn_norm"], x),
                          d_ff=cfg.d_ff, tp_axis=ctx.get("tp_axis"))
    return x, {}


def attn_block_fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
    """Pre-norm self-attention, then the FFN: x (B, L, d) -> ((B, L, d), aux)."""
    h = rmsnorm_apply(params["attn_norm"], x)
    x = x + attn.attn_fwd(params["attn"], h, cfg, window=window,
                          causal=ctx.get("causal", True), impl=ctx.get("impl", "flash"),
                          tp_axis=ctx.get("tp_axis"), sp_axis=ctx.get("sp_axis"))
    return _maybe_ffn(params, x, cfg, ctx)


def attn_block_cache_init(params, cfg: ModelConfig, desc: BlockDesc, batch: int,
                          max_len: int, dtype):
    return attn.init_kv_cache(cfg, batch, max_len, dtype,
                              device=params["attn_norm"]["scale"].device)


def attn_block_prefill(params, x, cache, cfg: ModelConfig, desc: BlockDesc, ctx,
                       window: int):
    h = rmsnorm_apply(params["attn_norm"], x)
    a, _ = attn.attn_prefill(params["attn"], h, cache, cfg, window=window)
    return _maybe_ffn(params, x + a, cfg)[0], cache


def attn_block_step(params, x1, cache, pos, cfg: ModelConfig, desc: BlockDesc,
                    window: int):
    h = rmsnorm_apply(params["attn_norm"], x1)
    a, _ = attn.attn_step(params["attn"], h, cache, pos, cfg, window=window)
    return _maybe_ffn(params, x1 + a, cfg)[0], cache


# ------------------------------------------------------------------ xattn
# gated cross-attention to the vision stub's patch embeddings (B, Nv, d),
# then the FFN.  The three paths reproduce the JAX package's blocks, quirks
# included: the forward ropes q at 0..L-1 and the vision keys at 0..Nv-1;
# the prefill and the step rope neither (its ``positions=None``), so the
# forward and prefill + decode give different logits.


def _vision(ctx):
    vision = ctx.get("vision")
    if vision is None:
        raise ValueError("an xattn block needs the vision embeddings (B, Nv, d_model): "
                         "pass vision= to lm_fwd or lm_prefill")
    return vision


def xattn_block_fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
    h = rmsnorm_apply(params["attn_norm"], x)
    x = x + attn.attn_fwd(params["attn"], h, cfg, causal=False,
                          impl=ctx.get("impl", "flash"), kv_x=_vision(ctx).to(x.dtype),
                          tp_axis=ctx.get("tp_axis"))
    return _maybe_ffn(params, x, cfg, ctx)


def xattn_block_cache_init(params, cfg: ModelConfig, desc: BlockDesc, batch: int,
                           max_len: int, dtype):
    """The vision tokens' KV (n_vision_tokens rows, whatever ``max_len``)."""
    return attn.init_kv_cache(cfg, batch, max(cfg.n_vision_tokens, 1), dtype,
                              device=params["attn_norm"]["scale"].device)


def xattn_block_prefill(params, x, cache, cfg: ModelConfig, desc: BlockDesc, ctx,
                        window: int):
    """Writes the vision tokens' raw KV heads into the cache once; the core
    (non-causal, no RoPE) is the flash kernel on KV repeated to all heads."""
    h = rmsnorm_apply(params["attn_norm"], x)
    q, k_raw, v_raw = attn._project_qkv(params["attn"], h, cfg, repeat_kv=False,
                                        kv_x=_vision(ctx).to(x.dtype), rope=False)
    cache["k"].copy_(k_raw)
    cache["v"].copy_(v_raw)
    reps = cfg.n_heads // cfg.n_kv_heads
    o = flash_mha(q, attn._repeat_heads(k_raw, reps), attn._repeat_heads(v_raw, reps),
                  causal=False, softcap=cfg.attn_softcap)
    x = x + attn._out(params["attn"], o, x.dtype)
    return _maybe_ffn(params, x, cfg)[0], cache


def xattn_block_step(params, x1, cache, pos, cfg: ModelConfig, desc: BlockDesc,
                     window: int):
    """Reads the vision KV and writes nothing: q without RoPE against every
    cached key, in the naive core (as the JAX package's step)."""
    h = rmsnorm_apply(params["attn_norm"], x1)
    p = params["attn"]
    cdt = x1.dtype
    B, _, d = h.shape
    q = (h @ p["wq"].reshape(d, -1).to(cdt)).view(B, 1, cfg.n_heads, -1)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    reps = cfg.n_heads // cfg.n_kv_heads
    k = attn._repeat_heads(cache["k"].to(cdt), reps)
    v = attn._repeat_heads(cache["v"].to(cdt), reps)
    o = attn.attn_core_naive(q, k, v, None, cfg.attn_softcap)
    return _maybe_ffn(params, x1 + attn._out(p, o, cdt), cfg)[0], cache


# ------------------------------------------------------------------ hymba
# parallel attention and mamba heads on one normed input, mean-fused:
# x + 0.5 * (attn + mamba), then the FFN


def hymba_block_fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
    h = rmsnorm_apply(params["mix_norm"], x)
    a = attn.attn_fwd(params["attn"], h, cfg, window=window,
                      causal=ctx.get("causal", True), impl=ctx.get("impl", "flash"),
                      tp_axis=ctx.get("tp_axis"))
    m = ssm.mamba_fwd(params["mamba"], h, cfg)
    return _maybe_ffn(params, x + 0.5 * (a + m), cfg, ctx)


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
    return _maybe_ffn(params, x + 0.5 * (a + m), cfg)[0], cache


def hymba_block_step(params, x1, cache, pos, cfg: ModelConfig, desc: BlockDesc,
                     window: int):
    """One decode step at ``pos`` (a 0-d integer tensor, or a Python int):
    the attention half writes its cache at ``pos``; the mamba half takes no
    position."""
    h = rmsnorm_apply(params["mix_norm"], x1)
    a, _ = attn.attn_step(params["attn"], h, cache["kv"], pos, cfg, window=window)
    m, state = ssm.mamba_step(params["mamba"], h, cache["ssm"], cfg)
    _set_state(cache["ssm"], state)
    return _maybe_ffn(params, x1 + 0.5 * (a + m), cfg)[0], cache


# ------------------------------------------------------------ mlstm/slstm
# xlstm's blocks: a pre-norm recurrent cell added to the stream, no FFN
# (the cells carry their own projections) and no window.  The cache is the
# cell's recurrent state, written in place (the decoder hands each layer a
# view of the caches stacked over repeats).


def _xlstm_block(cell_fwd, cell_init_state, cell_step):
    def fwd(params, x, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
        return x + cell_fwd(params["cell"], rmsnorm_apply(params["norm"], x), cfg), {}

    def cache_init(params, cfg: ModelConfig, desc: BlockDesc, batch: int, max_len: int,
                   dtype):
        return cell_init_state(params["cell"], cfg, batch)

    def prefill(params, x, cache, cfg: ModelConfig, desc: BlockDesc, ctx, window: int):
        y, state = cell_fwd(params["cell"], rmsnorm_apply(params["norm"], x), cfg,
                            return_state=True)
        _set_state(cache, state)
        return x + y, cache

    def step(params, x1, cache, pos, cfg: ModelConfig, desc: BlockDesc, window: int):
        y, state = cell_step(params["cell"], rmsnorm_apply(params["norm"], x1), cache, cfg)
        _set_state(cache, state)
        return x1 + y, cache

    return Block(fwd, cache_init, prefill, step)


BLOCKS = {
    "attn": Block(attn_block_fwd, attn_block_cache_init, attn_block_prefill,
                  attn_block_step),
    "xattn": Block(xattn_block_fwd, xattn_block_cache_init, xattn_block_prefill,
                   xattn_block_step),
    "hymba": Block(hymba_block_fwd, hymba_block_cache_init, hymba_block_prefill,
                   hymba_block_step),
    "mlstm": _xlstm_block(ssm.mlstm_fwd, ssm.mlstm_init_state, ssm.mlstm_step),
    "slstm": _xlstm_block(ssm.slstm_fwd, ssm.slstm_init_state, ssm.slstm_step),
}
