"""Dense FFNs: SwiGLU (the LLaMA family's) and GELU (musicgen's), told
apart by their params, as in the JAX package.  The products are plain
matrix products (``torch.matmul``), as the JAX package leaves them to XLA.

Tensor parallelism (``tp_axis``, a ``repro_torch.distributed.group``
``ModelGroup``): the hidden dim may be this rank's column-parallel block
of ``w_gate`` / ``w_up`` and row-parallel block of ``w_down``, and the
partial sums are psummed (under autograd the Megatron pair of
``repro_torch.distributed.group``: the psum is identity backward, and the
input's gradient is psummed).  Local against global is read from the param
shape against the declared ``d_ff``, as in the JAX package, so replicated
params run the unsharded code with no collective."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.distributed.group import psum_bwd, psum_fwd


def ffn_apply(params, x, *, d_ff: int = 0, tp_axis=None):
    """SwiGLU where the params have ``w_gate``: silu of the gate in float32,
    cast back, times the up path.  Else GELU (tanh form, ``jax.nn.gelu``'s
    default) of the up path in float32, cast back."""
    cdt = x.dtype
    tp = tp_axis is not None and d_ff and params["w_down"].shape[0] != d_ff
    if tp:
        x = psum_bwd(x, tp_axis)  # the column-parallel input's gradient (f)
    u = x @ params["w_up"].to(cdt)
    if "w_gate" in params:
        g = x @ params["w_gate"].to(cdt)
        h = F.silu(g.float()).to(cdt) * u
    else:
        h = F.gelu(u.float(), approximate="tanh").to(cdt)
    out = h @ params["w_down"].to(cdt)
    if tp:
        out = psum_fwd(out, tp_axis)  # row-parallel partial sums (g)
    return out
