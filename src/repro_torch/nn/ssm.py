"""The mamba mixer (selective SSM): full-sequence form and single-step
recurrent form, with the JAX package's casts (``repro/nn/ssm.py``).

``mamba_fwd`` runs the diagonal recurrence over the whole sequence through
``kernels.ssm_scan.linear_scan`` (kernel B7 on the card, its plain version
on the CPU): one launch per call, no chunking.  It computes what the JAX
package's chunked associative scan computes.  mLSTM and sLSTM are not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan.ops import linear_scan


def _dt_rank(params) -> int:
    return params["dt_proj"].shape[0]


def mamba_fwd(params, x_in, cfg: ModelConfig, return_state: bool = False):
    """x_in: (B, L, d_model) -> (B, L, d_model) [, final recurrent state
    {"conv": (B, ck-1, din), "ssm": (B, din, N)}, both float32].

    in_proj and the causal conv run in the compute dtype; SiLU, dt, B, C
    and the scan in float32; out_proj in the compute dtype.  The scan's
    inputs are laid out (B, L, din * N), d-major then n.
    """
    B, L, _ = x_in.shape
    cdt = x_in.dtype
    ck, N = cfg.ssm_conv, cfg.ssm_state
    dt_rank = _dt_rank(params)
    xz = x_in @ params["in_proj"].to(cdt)
    x_raw, z = xz.chunk(2, dim=-1)  # (B, L, din) each
    din = x_raw.shape[-1]

    # causal depthwise conv along L
    xp = F.pad(x_raw, (0, 0, ck - 1, 0))
    conv_w = params["conv_w"].to(cdt)  # (ck, din)
    x = sum(xp[:, i: i + L] * conv_w[i] for i in range(ck))
    x = F.silu((x + params["conv_b"].to(cdt)).float())

    proj = x.to(cdt) @ params["x_proj"].to(cdt)
    dt, Bm, Cm = proj.float().split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"].float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())  # (din, N)

    # the (B, L, din, N) scan inputs are the layer's largest tensors: exp
    # runs in place to hold one fewer of them
    decay = torch.exp_(dt[..., None] * A).view(B, L, din * N)
    drive = ((dt * x)[..., None] * Bm[:, :, None, :]).view(B, L, din * N)
    h = linear_scan(decay, drive).view(B, L, din, N)
    del decay, drive
    y = torch.einsum("bldn,bln->bld", h, Cm)
    y = y + x * params["D"].float()
    y = y * F.silu(z.float())
    out = y.to(cdt) @ params["out_proj"].to(cdt)
    if not return_state:
        return out
    xr = x_raw.float()
    if L >= ck - 1:
        conv_state = xr[:, L - (ck - 1):]
    else:
        conv_state = F.pad(xr, (0, 0, ck - 1 - L, 0))
    return out, {"conv": conv_state.contiguous(), "ssm": h[:, -1].contiguous()}


def mamba_init_state(params, cfg: ModelConfig, batch: int):
    din = params["dt_bias"].shape[-1]
    dev = params["dt_bias"].device
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, din), dtype=torch.float32, device=dev),
        "ssm": torch.zeros((batch, din, cfg.ssm_state), dtype=torch.float32, device=dev),
    }


def mamba_step(params, x1, state, cfg: ModelConfig):
    """x1: (B, 1, d_model); the O(1) recurrent update in float32 (conv,
    projections after in_proj, and the state).  Returns (out (B, 1,
    d_model), new state)."""
    cdt = x1.dtype
    N = cfg.ssm_state
    dt_rank = _dt_rank(params)
    xz = x1 @ params["in_proj"].to(cdt)
    x, z = xz.chunk(2, dim=-1)
    x = x[:, 0].float()  # (B, din)
    z = z[:, 0].float()

    hist = torch.cat([state["conv"], x[:, None]], dim=1)  # (B, ck, din)
    xc = torch.einsum("bkd,kd->bd", hist, params["conv_w"].float()) + params["conv_b"].float()
    xc = F.silu(xc)
    new_conv = hist[:, 1:]

    proj = xc @ params["x_proj"].float()
    dt, Bm, Cm = proj.split([dt_rank, N, N], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"].float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt[..., None] * A)  # (B, din, N)
    h = decay * state["ssm"] + (dt * xc)[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + xc * params["D"].float()
    y = y * F.silu(z)
    out = y.to(cdt) @ params["out_proj"].to(cdt)
    return out[:, None], {"conv": new_conv, "ssm": h}
