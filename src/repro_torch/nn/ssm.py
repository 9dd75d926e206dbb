"""The recurrent mixers, each in a full-sequence form and a single-step
recurrent form, with the JAX package's casts (``repro/nn/ssm.py``): mamba
(hymba's selective SSM), and xLSTM's mLSTM (matrix memory) and sLSTM
(scalar memory with recurrent gates).

``mamba_fwd`` runs the diagonal recurrence in chunks of ``chunk``
positions (1024, the JAX package's default), each through
``kernels.ssm_scan.linear_scan`` (kernel B7 on the card, its plain version
on the CPU): one launch a chunk, with the state carried between chunks.
It computes what the JAX package's chunked associative scan computes, and
no tensor of the scan grows with L.  mLSTM and sLSTM reach no
kernel in the JAX package (einsums, and a ``lax.scan`` over time); here
they are plain PyTorch: ``mlstm_fwd`` loops over chunks, ``slstm_fwd``
over positions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan.ops import linear_scan
from repro_torch.nn.layers import rmsnorm_apply

NEG_INF = -1e30  # the JAX package's: a finite "minus infinity" for masks and pads


def _dt_rank(params) -> int:
    return params["dt_proj"].shape[0]


def _conv_state(x, ck: int):
    """The last ck - 1 positions of the conv's input x (B, L, din) in
    float32, left-padded with zeros where L < ck - 1: the decode step's
    conv history."""
    L = x.shape[1]
    xr = x.float()
    if L >= ck - 1:
        return xr[:, L - (ck - 1):].contiguous()
    return F.pad(xr, (0, 0, ck - 1 - L, 0))


def mamba_fwd(params, x_in, cfg: ModelConfig, return_state: bool = False,
              chunk: int = 1024):
    """x_in: (B, L, d_model) -> (B, L, d_model) [, final recurrent state
    {"conv": (B, ck-1, din), "ssm": (B, din, N)}, both float32].

    in_proj and the causal conv run in the compute dtype; SiLU, dt, B, C
    and the scan in float32; out_proj in the compute dtype.  The scan runs
    in chunks of ``chunk`` positions (the last may be shorter), its inputs
    laid out (B, chunk, N * din), n-major then d: the decay, the drive and
    h exist for one chunk at a time.  The state h_prev carried into a chunk
    is folded into its first drive as b_0 + a_0 * h_prev, the plain loop's
    two roundings in its order.  The C readout runs a chunk at a time too,
    as a product and a sum over n, each element's sum in one order
    whatever the chunk (a batched matmul's order changes with its batch
    count): so any ``chunk`` gives the bits of one scan over all of L.
    """
    if chunk < 1:
        raise ValueError(f"mamba_fwd: chunk must be at least 1, got {chunk}")
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
    A = -torch.exp(params["A_log"].float()).t().contiguous()  # (N, din)

    ys, h_prev = [], None
    for s in range(0, L, chunk):
        at = slice(s, s + chunk)
        n = dt[:, at].shape[1]
        # the (B, chunk, N, din) scan inputs are the layer's largest
        # tensors: exp runs in place to hold one fewer of them
        decay = torch.exp_(dt[:, at, None, :] * A).view(B, n, N * din)
        drive = ((dt[:, at] * x[:, at])[:, :, None, :] * Bm[:, at, :, None]).view(B, n, N * din)
        if h_prev is not None:
            drive[:, 0] = drive[:, 0] + decay[:, 0] * h_prev
        h = linear_scan(decay, drive)
        del decay, drive
        ys.append((h.view(B, n, N, din) * Cm[:, at, :, None]).sum(2))
        h_prev = h[:, -1]
        del h
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    y = y + x * params["D"].float()
    y = y * F.silu(z.float())
    out = y.to(cdt) @ params["out_proj"].to(cdt)
    if not return_state:
        return out
    return out, {"conv": _conv_state(x_raw, ck),
                 "ssm": h_prev.view(B, N, din).transpose(1, 2).contiguous()}


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


# ------------------------------------------------------------------ mLSTM


def _mlstm_qkv(params, x_in, cfg: ModelConfig):
    """The up-projection split into the memory path xm and the gate z, the
    causal conv and SiLU of xm, q and k from the conv's output and v from
    xm in the compute dtype, and the input and forget pre-activations in
    float32: (q, k, v (B, L, H, dh), i_pre, f_pre (B, L, H), z, xm)."""
    B, L, _ = x_in.shape
    cdt = x_in.dtype
    ck, H = cfg.ssm_conv, cfg.n_heads
    up = x_in @ params["up_proj"].to(cdt)
    xm, z = up.chunk(2, dim=-1)  # (B, L, din) each
    din = xm.shape[-1]
    xp = F.pad(xm, (0, 0, ck - 1, 0))
    conv_w = params["conv_w"].to(cdt)
    xc = sum(xp[:, i: i + L] * conv_w[i] for i in range(ck))
    xc = F.silu((xc + params["conv_b"].to(cdt)).float()).to(cdt)

    def heads(x, name):
        return (x @ params[name].reshape(din, -1).to(cdt)).view(B, L, H, -1)

    q, k, v = heads(xc, "wq"), heads(xc, "wk"), heads(xm, "wv")
    xm32 = xm.float()
    i_pre = xm32 @ params["w_i"].float() + params["b_i"].float()
    f_pre = xm32 @ params["w_f"].float() + params["b_f"].float()
    return q, k, v, i_pre, f_pre, z, xm


def mlstm_fwd(params, x_in, cfg: ModelConfig, return_state: bool = False,
              chunk: int = 1024):
    """Chunkwise stabilized mLSTM: x_in (B, L, d_model) -> (B, L, d_model)
    [, final state {"conv": (B, ck-1, din), "C": (B, H, dh, dh), "n": (B,
    H, dh), "m": (B, H)}, float32].

    Within a chunk of ``chunk`` positions, the decay-masked quadratic form;
    across chunks, the carried (C, n, m) state, in float32.  L need not
    divide the chunk: the last chunk is padded with steps that leave the
    state as it is (input gate NEG_INF: nothing written; forget gate +40:
    no decay).  ``chunk`` >= L is the full parallel form."""
    B, L, _ = x_in.shape
    cdt = x_in.dtype
    H = cfg.n_heads
    q, k, v, i_pre, f_pre, z, xm = _mlstm_qkv(params, x_in, cfg)
    dh = q.shape[-1]
    din = H * dh

    C = min(chunk, L)
    pad = (-L) % C
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=NEG_INF)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=40.0)
    nC = (L + pad) // C
    scale = 1.0 / math.sqrt(dh)
    dev = x_in.device
    causal = torch.ones((C, C), dtype=torch.bool, device=dev).tril()
    C_st = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n_st = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m_st = torch.full((B, H), -math.inf, dtype=torch.float32, device=dev)
    hs = []
    for c in range(nC):
        at = slice(c * C, (c + 1) * C)
        q32, k32, v32 = q[:, at].float(), k[:, at].float() * scale, v[:, at].float()
        i_c = i_pre[:, at]
        Lam = torch.cumsum(F.logsigmoid(f_pre[:, at]), dim=1)  # (B, C, H): decay to t
        # D[t, s] = Lam_t - Lam_s + i_s for s <= t
        Dmat = Lam[:, :, None, :] - Lam[:, None, :, :] + i_c[:, None, :, :]
        Dmat = Dmat.masked_fill(~causal[None, :, :, None], NEG_INF)
        m_inter = Lam + m_st[:, None, :]
        m_t = torch.maximum(Dmat.amax(dim=2), m_inter)
        Ct = torch.einsum("bchk,bshk->bcsh", q32, k32) * torch.exp(Dmat - m_t[:, :, None, :])
        inter_w = torch.exp(m_inter - m_t)
        num = torch.einsum("bcsh,bshv->bchv", Ct, v32) + inter_w[..., None] * torch.einsum(
            "bchk,bhkv->bchv", q32, C_st)
        den = Ct.sum(dim=2) + inter_w * torch.einsum("bchk,bhk->bch", q32, n_st)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        hs.append(num / den[..., None])

        # the state at the chunk's end, stabilized by m at its last position
        m_last = m_t[:, -1]
        w_end = torch.exp(Lam[:, -1:, :] - Lam + i_c - m_last[:, None, :])
        carry = torch.exp(Lam[:, -1] + m_st - m_last)
        C_st = carry[:, :, None, None] * C_st + torch.einsum("bch,bchk,bchv->bhkv", w_end,
                                                             k32, v32)
        n_st = carry[:, :, None] * n_st + torch.einsum("bch,bchk->bhk", w_end, k32)
        m_st = m_last
    h = torch.cat(hs, dim=1)[:, :L].reshape(B, L, din).to(cdt)
    h = rmsnorm_apply(params["out_norm"], h) * F.silu(z.float()).to(cdt)
    out = h @ params["down_proj"].to(cdt)
    if not return_state:
        return out
    return out, {"conv": _conv_state(xm, cfg.ssm_conv), "C": C_st, "n": n_st, "m": m_st}


def mlstm_init_state(params, cfg: ModelConfig, batch: int):
    """The empty state on the params' device: zeros, and m = -inf."""
    din = params["conv_b"].shape[-1]
    H = cfg.n_heads
    dh = din // H
    dev = params["conv_b"].device
    zeros = lambda *s: torch.zeros((batch,) + s, dtype=torch.float32, device=dev)  # noqa: E731
    return {"conv": zeros(cfg.ssm_conv - 1, din), "C": zeros(H, dh, dh), "n": zeros(H, dh),
            "m": torch.full((batch, H), -math.inf, dtype=torch.float32, device=dev)}


def mlstm_step(params, x1, state, cfg: ModelConfig):
    """x1: (B, 1, d_model); the O(1) recurrent update in float32 from the
    float32 conv history (the up- and down-projections in the compute
    dtype).  Returns (out (B, 1, d_model), new state)."""
    B = x1.shape[0]
    cdt = x1.dtype
    H = cfg.n_heads
    up = x1 @ params["up_proj"].to(cdt)
    xm, z = up.chunk(2, dim=-1)
    xm, z = xm[:, 0].float(), z[:, 0].float()
    din = xm.shape[-1]
    dh = din // H

    hist = torch.cat([state["conv"], xm[:, None]], dim=1)  # (B, ck, din)
    xc = torch.einsum("bkd,kd->bd", hist, params["conv_w"].float()) + params["conv_b"].float()
    xc = F.silu(xc)

    def heads(x, name):
        return (x @ params[name].reshape(din, -1).float()).view(B, H, dh)

    q, k, v = heads(xc, "wq"), heads(xc, "wk") / math.sqrt(dh), heads(xm, "wv")
    i_pre = xm @ params["w_i"].float() + params["b_i"].float()  # (B, H)
    f_pre = xm @ params["w_f"].float() + params["b_f"].float()

    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_s = torch.exp(logf + state["m"] - m_new)
    i_s = torch.exp(i_pre - m_new)
    C = f_s[..., None, None] * state["C"] + i_s[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, din)

    h = rmsnorm_apply(params["out_norm"], h.to(cdt)) * F.silu(z).to(cdt)
    out = h @ params["down_proj"].to(cdt)
    return out[:, None], {"conv": hist[:, 1:], "C": C, "n": n, "m": m_new}


# ------------------------------------------------------------------ sLSTM


def _slstm_cell(rg, b_gates, wx_t, carry):
    """One sLSTM step in float32.  rg: the recurrent gates (4, H, dh, dh);
    wx_t: (B, 4, H, dh) input pre-activations; carry (h, c, n, m), each
    (B, H, dh).  Returns the new carry."""
    h_prev, c_prev, n_prev, m_prev = carry
    rec = torch.einsum("bhk,ghkv->bghv", h_prev, rg)
    pre = wx_t + rec + b_gates
    i_pre, f_pre, z_pre, o_pre = pre.unbind(1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m_prev, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + m_prev - m_new)
    c = f_s * c_prev + i_s * torch.tanh(z_pre)
    n = f_s * n_prev + i_s
    h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def _slstm_out(params, h, cdt):
    """The cell's output h (..., d_model) float32 in the compute dtype,
    normed, through the GELU-gated FFN."""
    h = rmsnorm_apply(params["out_norm"], h.to(cdt))
    u = h @ params["up_proj"].to(cdt)
    g = h @ params["gate_proj"].to(cdt)
    return (F.gelu(u.float(), approximate="tanh").to(cdt) * g) @ params["down_proj"].to(cdt)


def slstm_fwd(params, x_in, cfg: ModelConfig, return_state: bool = False):
    """x_in (B, L, d_model) -> (B, L, d_model) [, final state {"h", "c",
    "n", "m"}, each (B, H, dh) float32]: the input pre-activations for all
    positions in one product, then the cell once a position (a Python loop
    over L)."""
    B, L, d = x_in.shape
    H = cfg.n_heads
    dh = d // H
    wx = torch.einsum("bld,dghk->blghk", x_in.float(), params["w_gates"].float())
    rg, bg = params["r_gates"].float(), params["b_gates"].float()
    zeros = lambda: torch.zeros((B, H, dh), dtype=torch.float32, device=x_in.device)  # noqa: E731
    carry = (zeros(), zeros(), zeros(), torch.full((B, H, dh), -math.inf,
                                                   dtype=torch.float32, device=x_in.device))
    hs = []
    for t in range(L):
        carry = _slstm_cell(rg, bg, wx[:, t], carry)
        hs.append(carry[0])
    out = _slstm_out(params, torch.stack(hs, dim=1).reshape(B, L, d), x_in.dtype)
    if not return_state:
        return out
    return out, dict(zip(("h", "c", "n", "m"), carry))


def slstm_init_state(params, cfg: ModelConfig, batch: int):
    """The empty state on the params' device: zeros, and m = -inf."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    dev = params["b_gates"].device
    state = {k: torch.zeros((batch, H, dh), dtype=torch.float32, device=dev)
             for k in ("h", "c", "n")}
    state["m"] = torch.full((batch, H, dh), -math.inf, dtype=torch.float32, device=dev)
    return state


def slstm_step(params, x1, state, cfg: ModelConfig):
    """x1: (B, 1, d_model) -> (out (B, 1, d_model), new state): one cell
    step in float32, the output path in the compute dtype."""
    B = x1.shape[0]
    wx = torch.einsum("bd,dghk->bghk", x1[:, 0].float(), params["w_gates"].float())
    carry = _slstm_cell(params["r_gates"].float(), params["b_gates"].float(), wx,
                        (state["h"], state["c"], state["n"], state["m"]))
    out = _slstm_out(params, carry[0].reshape(B, cfg.d_model), x1.dtype)
    return out[:, None], dict(zip(("h", "c", "n", "m"), carry))
