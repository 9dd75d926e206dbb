"""Dense FFNs: SwiGLU (the LLaMA family's) and GELU (musicgen's), told
apart by their params, as in the JAX package.  The products are plain
matrix products (``torch.matmul``), as the JAX package leaves them to XLA."""

from __future__ import annotations

import torch.nn.functional as F


def ffn_apply(params, x):
    """SwiGLU where the params have ``w_gate``: silu of the gate in float32,
    cast back, times the up path.  Else GELU (tanh form, ``jax.nn.gelu``'s
    default) of the up path in float32, cast back."""
    cdt = x.dtype
    u = x @ params["w_up"].to(cdt)
    if "w_gate" in params:
        g = x @ params["w_gate"].to(cdt)
        h = F.silu(g.float()).to(cdt) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(cdt)
    return h @ params["w_down"].to(cdt)
