"""Self-attention with the JAX package's weight layout at the boundary:
``wq``, ``wk``, ``wv`` are (d, heads, head_dim) and ``wo`` is (heads,
head_dim, d).

Two cores: ``impl="flash"`` routes to ``repro_torch.kernels.flash_attention``
(the CUDA kernel on the card, its plain version on the CPU), and
``impl="naive"`` materializes the (L, S) scores in the compute dtype, as the
JAX package's ``attn_core_naive`` does.  Tensor and sequence parallelism
and rotary positions are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_mha

NEG_INF = -1e30


def _project_qkv(params, x, cfg: ModelConfig):
    """x: (B, L, d) -> q, k, v: (B, L, H, hd), KV repeated to all heads."""
    B, L, d = x.shape
    h, kv = cfg.n_heads, cfg.n_kv_heads
    cdt = x.dtype

    def proj(w, bias):
        n, hd = w.shape[1], w.shape[2]
        y = (x @ w.reshape(d, n * hd).to(cdt)).view(B, L, n, hd)
        if bias is not None:
            y = y + bias.to(cdt)
        return y

    q = proj(params["wq"], params.get("bq"))
    k = proj(params["wk"], params.get("bk"))
    v = proj(params["wv"], params.get("bv"))
    reps = h // kv
    if reps > 1:
        k = torch.repeat_interleave(k, reps, dim=2)
        v = torch.repeat_interleave(v, reps, dim=2)
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


def _softcap(x, cap: float):
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def attn_core_naive(q, k, v, mask, cap: float):
    """q: (B, L, H, hd); k, v: (B, S, H, hd); mask: (L, S) or None."""
    hd = q.shape[-1]
    scores = torch.einsum("blhk,bshk->bhls", q, k) / torch.tensor(
        math.sqrt(hd), dtype=q.dtype)
    scores = _softcap(scores, cap)
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.tensor(NEG_INF, dtype=scores.dtype,
                                          device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhls,bshk->blhk", probs, v)


def attn_fwd(params, x, cfg: ModelConfig, *, window: int = 0,
             causal: bool = True, impl: str = "flash"):
    """Full-sequence self-attention: x (B, L, d) -> (B, L, d)."""
    if cfg.pos_embed == "rope":
        raise NotImplementedError("rotary positions are not ported yet")
    B, L, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    if impl == "flash":
        o = flash_mha(q, k, v, causal=causal, window=window,
                      softcap=cfg.attn_softcap)
    elif impl == "naive":
        mask = attn_mask(L, L, causal, window, x.device) if (
            causal or window > 0) else None
        o = attn_core_naive(q, k, v, mask, cfg.attn_softcap)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    H, hd = o.shape[2], o.shape[3]
    return o.reshape(B, L, H * hd) @ params["wo"].reshape(H * hd, -1).to(x.dtype)
