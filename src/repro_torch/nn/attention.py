"""Self- and cross-attention with the JAX package's weight layout at the
boundary: ``wq``, ``wk``, ``wv`` are (d, heads, head_dim) and ``wo`` is
(heads, head_dim, d); optional QKV biases ``bq``, ``bk``, ``bv`` (qwen2.5)
and a scalar ``gate`` whose tanh scales the output (the xattn layers of
llama-3.2-vision).  GQA, rotary positions, sliding windows, logit softcap
and a KV cache of the raw KV heads.

Two cores for the full-sequence forms: ``impl="flash"`` routes to
``repro_torch.kernels.flash_attention`` (the CUDA kernel on the card, its
plain version on the CPU), and ``impl="naive"`` materializes the (L, S)
scores in the compute dtype, as the JAX package's ``attn_core_naive``
does.  ``attn_prefill`` always takes the flash core (the JAX package takes
its chunked core there, which computes the same function).  ``attn_step``
is grouped-query attention against the cache in plain PyTorch.

``attn_fwd`` takes the serving forward's model parallelism, each a
``repro_torch.distributed.group`` ``ModelGroup`` (the JAX package's mesh
axis name): ``tp_axis`` (tensor parallelism: this rank's head block of
``wq`` / ``bq`` / ``wo``, the repeated K/V sliced to it, the row-parallel
``wo`` psummed; under autograd the Megatron pair of
``repro_torch.distributed.group`` makes the psum after ``wo`` identity
backward, and psums the gradients of the input and of the K/V before
their slice, so the replicated ``wk`` / ``wv`` and the norm before them
get their whole gradient on every rank) and ``sp_axis`` (Ulysses sequence parallelism: x is the
rank's sequence slice, and two tiled all-to-alls trade it for a head
slice around the core, which then sees the whole sequence on H/mp heads).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.group import psum_bwd, psum_fwd
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.nn.layers import apply_rope, softcap

NEG_INF = -1e30


def _repeat_heads(t, reps: int):
    return torch.repeat_interleave(t, reps, dim=2) if reps > 1 else t


def _project_qkv(params, x, cfg: ModelConfig, start=0, repeat_kv: bool = True,
                 kv_x=None, rope: bool = True, tp_axis=None):
    """x: (B, L, d) at positions start..start+L-1 -> q (B, L, H, hd); k, v
    (B, S, H or KV, hd) from ``kv_x`` (B, S, d) at positions start..start+S-1
    (x where None).  RoPE where the config has it and ``rope`` is set (the
    xattn prefill and step pass False, as the JAX package's
    ``positions=None`` does), KV repeated to all heads unless ``repeat_kv``
    is False (the caches keep the raw KV heads).  ``start`` is a Python int
    or a 0-d integer tensor on x's device.  Under ``tp_axis`` ``wq`` / ``bq``
    are this rank's block of H/mp heads, so q has them already, and the
    repeated K/V (``wk`` / ``wv`` stay replicated) are sliced to the same
    contiguous block; replicated params leave the shapes as they are."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    cdt = x.dtype
    xkv = x if kv_x is None else kv_x
    # a rank's head block: the replicated input's gradient through it, and
    # through the K/V slice below, is the rank's part of the whole (f)
    tp = tp_axis is not None and params["wq"].shape[1] != h
    if tp:
        x = psum_bwd(x, tp_axis)

    def proj(inp, w, bias):
        B, n_in, d = inp.shape
        n, hd = w.shape[1], w.shape[2]
        y = (inp @ w.reshape(d, n * hd).to(cdt)).view(B, n_in, n, hd)
        if bias is not None:
            y = y + bias.to(cdt)
        return y

    q = proj(x, params["wq"], params.get("bq"))
    k = proj(xkv, params["wk"], params.get("bk"))
    v = proj(xkv, params["wv"], params.get("bv"))
    if rope and cfg.pos_embed == "rope":
        q = apply_rope(q, start + torch.arange(q.shape[1], device=x.device), cfg.rope_theta)
        k = apply_rope(k, start + torch.arange(k.shape[1], device=x.device), cfg.rope_theta)
    if tp:
        # every rank keeps another head block of the replicated K/V: their
        # gradients add up to K's and V's whole gradient (f), so wk, wv and
        # the input get it on every rank
        k, v = psum_bwd(k, tp_axis), psum_bwd(v, tp_axis)
    if repeat_kv:
        k, v = _repeat_heads(k, h // kv), _repeat_heads(v, h // kv)
        h_local = q.shape[2]
        if tp:
            lo = tp_axis.axis_index() * h_local
            k, v = k[:, :, lo:lo + h_local], v[:, :, lo:lo + h_local]
    return q, k, v


def attn_mask(L: int, S: int, causal: bool, window: int, device):
    """bool (L, S): True = attend; ``window`` <= 0 means full."""
    qp = torch.arange(L, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    m = torch.ones((L, S), dtype=torch.bool, device=device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return m


def attn_core_naive(q, k, v, mask, cap: float):
    """q: (B, L, H, hd); k, v: (B, S, H, hd); mask: (L, S) or None."""
    hd = q.shape[-1]
    scores = torch.einsum("blhk,bshk->bhls", q, k) / torch.tensor(
        math.sqrt(hd), dtype=q.dtype)
    scores = softcap(scores, cap)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshk->blhk", probs, v)


def _out(params, o, dtype, tp_axis=None, n_heads: int = 0):
    """The output projection of o (B, L, H, hd) -> (B, L, d), psummed over
    ``tp_axis`` where H is a rank's block of ``n_heads`` (row-parallel
    ``wo``), times tanh(gate) (in float32, cast to ``dtype``) where the
    params have a gate."""
    B, L, H, hd = o.shape
    out = o.reshape(B, L, H * hd) @ params["wo"].reshape(H * hd, -1).to(dtype)
    if tp_axis is not None and H != n_heads:
        out = psum_fwd(out, tp_axis)  # row-parallel wo partial sums (g)
    if "gate" in params:
        out = torch.tanh(params["gate"].float()).to(dtype) * out
    return out


def attn_fwd(params, x, cfg: ModelConfig, *, window: int = 0,
             causal: bool = True, impl: str = "flash", kv_x=None, tp_axis=None,
             sp_axis=None):
    """Full-sequence attention over positions 0..L-1: x (B, L, d) -> (B, L,
    d).  ``window`` is a Python int (0 = full).  With ``kv_x`` (B, S, d) it
    is cross-attention to kv_x, non-causal and unmasked, with RoPE (where
    the config has it) on q at 0..L-1 and on k at 0..S-1, as the JAX
    package's ``attn_fwd`` applies it.

    ``tp_axis``: tensor parallelism (see ``_project_qkv``); the output
    projection's partial sums are psummed only where the local head count
    differs from ``n_heads``.  ``sp_axis``: x is this rank's (B, L/mp, d)
    slice of the sequence, at positions r * L/mp onwards, and every weight
    is replicated; q, k and v are projected on the slice, a tiled
    all-to-all trades the sequence axis for the head axis (the core then
    sees the whole sequence on H/mp heads: exact, not blockwise), and a
    second one trades back before ``wo``, so the output is the rank's
    slice again, with no psum.  The two are mutually exclusive, and SP is
    self-attention only."""
    if sp_axis is not None:
        assert tp_axis is None, "sp_axis and tp_axis are mutually exclusive"
        assert kv_x is None, "Ulysses sequence parallelism is self-attn only"
    B, L, _ = x.shape
    start = sp_axis.axis_index() * L if sp_axis is not None else 0
    q, k, v = _project_qkv(params, x, cfg, start=start, kv_x=kv_x, tp_axis=tp_axis)
    if sp_axis is not None:
        # seq -> head: rank s keeps heads [s H/mp, (s+1) H/mp); the sequence
        # concatenates sender-major, which is global order
        q, k, v = (sp_axis.all_to_all(t, 2, 1) for t in (q, k, v))
        L = q.shape[1]
    cross = kv_x is not None
    if impl == "flash":
        o = flash_mha(q, k, v, causal=causal and not cross, window=window,
                      softcap=cfg.attn_softcap)
    elif impl == "naive":
        mask = attn_mask(L, L, causal, window, x.device) if (
            not cross and (causal or window > 0)) else None
        o = attn_core_naive(q, k, v, mask, cfg.attn_softcap)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    if sp_axis is not None:
        o = sp_axis.all_to_all(o, 1, 2)  # head -> seq, the exact inverse
    return _out(params, o, x.dtype, tp_axis, cfg.n_heads)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None):
    """Zero K and V caches (batch, max_len, n_kv_heads, head_dim)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(params, x, cache, cfg: ModelConfig, *, window: int = 0):
    """Causal forward over x (B, L, d) that writes the raw KV heads of
    positions 0..L-1 into ``cache`` in place.  The core is the flash kernel
    (causal, ``window``) on KV repeated to all heads.  Returns (out, cache)."""
    B, L, _ = x.shape
    q, k_raw, v_raw = _project_qkv(params, x, cfg, repeat_kv=False)
    cache["k"][:, :L] = k_raw
    cache["v"][:, :L] = v_raw
    reps = cfg.n_heads // cfg.n_kv_heads
    o = flash_mha(q, _repeat_heads(k_raw, reps), _repeat_heads(v_raw, reps), causal=True,
                  window=window, softcap=cfg.attn_softcap)
    return _out(params, o, x.dtype), cache


def attn_step(params, x1, cache, pos, cfg: ModelConfig, *, window: int = 0):
    """One-token decode at position ``pos``: grouped-query attention
    against the raw KV-head cache (written in place at ``pos``), keys at or
    before ``pos`` and, for ``window`` > 0, within the window.  Scores and
    probabilities are in the compute dtype, the softmax in float32, as in
    the JAX package.  ``pos`` is a 0-d integer tensor on x1's device (the
    JAX package's ``pos: () int32``; a Python int is made one), never read
    on the host, so a decode step can be captured.  x1: (B, 1, d).
    Returns (out (B, 1, d), cache)."""
    B = x1.shape[0]
    S = cache["k"].shape[1]
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // kv
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x1.device)
    q, k, v = _project_qkv(params, x1, cfg, pos, repeat_kv=False)
    at = pos.view(1)
    cache["k"].index_copy_(1, at, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, at, v.to(cache["v"].dtype))
    kv_pos = torch.arange(S, device=x1.device)
    valid = kv_pos <= pos
    if window > 0:
        valid = valid & ((pos - kv_pos) < window)
    kf = cache["k"].to(q.dtype)
    vf = cache["v"].to(q.dtype)
    qg = q[:, 0].reshape(B, kv, G, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, kf) / torch.tensor(
        math.sqrt(hd), dtype=q.dtype)
    scores = softcap(scores, cfg.attn_softcap)
    scores = torch.where(valid, scores, NEG_INF)  # NEG_INF in scores' dtype
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", probs, vf).reshape(B, 1, kv * G, hd)
    return _out(params, o, x1.dtype), cache
