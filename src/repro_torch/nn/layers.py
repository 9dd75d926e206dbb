"""Basic layers: RMSNorm, dense projection, token embedding and its
transpose, rotary and sinusoidal positions, logit softcap; the cast of a
params tree to the compute dtype.

Functional, on plain dicts of tensors in the JAX package's layout.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def cast_leaves(tree, names, dtype):
    """The params tree with every leaf whose key is in ``names`` cast to
    ``dtype`` (the others as they are)."""
    def cast(t, name=None):
        if isinstance(t, dict):
            return {k: cast(v, k) for k, v in t.items()}
        return t.to(dtype) if name in names else t

    return cast(tree)


def rmsnorm_apply(params, x, eps: float = 1e-6):
    """RMSNorm in float32 with the (1 + scale) parametrization."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def dense_apply(params, x):
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def sinusoidal_embed(positions, dim: int, max_period: float = 1e4):
    """Absolute positions / diffusion time embedding: (...,) -> (..., dim)
    float32, [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    args = positions[..., None].float() * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def embedding_apply(params, ids, compute_dtype=torch.bfloat16):
    """Rows of the (vocab, dim) table, in the compute dtype."""
    return params["table"][ids].to(compute_dtype)


def unembed_apply(params, x):
    """Logits from a (vocab, dim) table (tied embeddings)."""
    return x @ params["table"].to(x.dtype).T


def rope_freqs(head_dim: int, theta: float = 1e4):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as float32 on ``device``, made once: a captured
    decode step reads it where it is (a copy from the host cannot be
    captured)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x, positions, theta: float = 1e4):
    """Rotary positions in float32, split-halves layout, cast back.
    x: (..., L, n_heads, head_dim); positions: (..., L) int."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., L, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(x, cap: float):
    """Gemma-2 style logit soft-capping (``cap`` 0 means none)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
