"""Dense SwiGLU FFN.  The products are plain matrix products
(``torch.matmul``), as the JAX package leaves them to XLA."""

from __future__ import annotations

import torch.nn.functional as F


def ffn_apply(params, x):
    """SwiGLU: silu of the gate in float32, cast back, times the up path."""
    cdt = x.dtype
    u = x @ params["w_up"].to(cdt)
    g = x @ params["w_gate"].to(cdt)
    return (F.silu(g.float()).to(cdt) * u) @ params["w_down"].to(cdt)
