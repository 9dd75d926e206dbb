"""Basic layers: RMSNorm, dense projection, sinusoidal embeddings.

Functional, on plain dicts of tensors in the JAX package's layout.
"""

from __future__ import annotations

import math

import torch


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
