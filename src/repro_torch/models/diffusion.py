"""Diffusion denoiser head: a backbone run non-causally as a DDPM mean
oracle.  The model predicts x0_hat = E[x0 | y_t], the ``g`` that ASD
consumes (paper Remark 2 / Eq. 4).

Params are a plain dict of tensors in the JAX package's tree layout (see
``repro_torch.weights``).  ``sl_denoiser_loss`` and ``ddpm_denoiser_loss``
are the training losses, with their random draws injectable.  A MoE
backbone (qwen3-moe-a3b-smoke) runs with every expert on the device, in
blocks of ``_POINT_ROWS`` points (see ``denoiser_fwd``).  Tensor, sequence
and expert parallelism are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import decoder_fwd
from repro_torch.nn.layers import cast_leaves, rmsnorm_apply, sinusoidal_embed

# leaves that enter a product in the compute dtype (everything else -- the
# time MLP and the norm scales -- is used in float32)
_COMPUTE_LEAVES = frozenset(
    {"in_proj", "cond_proj", "out_proj", "wq", "wk", "wv", "wo", "bq", "bk",
     "bv", "w_gate", "w_up", "w_down", "router"})


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    backbone: ModelConfig
    seq_len: int  # number of data tokens (action steps / latent patches)
    d_data: int  # channels per token
    d_cond: int = 0  # conditioning vector dim (diffusion-policy observations)
    time_log: bool = False  # log-transform t before embedding (SL time)
    time_dim: int = 256


# the row block of the per-point products (one row a point)
_POINT_ROWS = 16


def _point_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (points, k), in blocks of ``_POINT_ROWS`` rows (the
    last padded with zeros): every block is one product of one shape, so a
    point's row is the same bits whatever batch it rides in.  cuBLAS picks
    its kernel, and with it the order of the k-sum, by the number of rows,
    and at 36 points the time MLP's rows differ from those at 18.  The
    token products (points x tokens rows) showed no such dependence."""
    lead = tuple(x.shape[:-1])
    x = x.reshape(-1, x.shape[-1])
    pad = -x.shape[0] % _POINT_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    out = torch.cat([blk @ w for blk in x.split(_POINT_ROWS)])
    return out[:out.shape[0] - pad].reshape(lead + (w.shape[-1],))


def _in_point_blocks(fn, t, y, cond):
    """``fn(t, y, cond)`` on blocks of ``_POINT_ROWS`` points, the last
    padded with zero points, and the real rows of the results: every
    product, attention call and expert product then has one shape,
    whatever the number of points."""
    n, R = t.shape[0], _POINT_ROWS
    pad = -n % R

    def padded(a):
        return None if a is None or not pad else torch.cat(
            [a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    if pad:
        t, y, cond = padded(t), padded(y), padded(cond)
    outs = [fn(t[i:i + R], y[i:i + R], None if cond is None else cond[i:i + R])
            for i in range(0, n + pad, R)]
    out = torch.cat(outs) if len(outs) > 1 else outs[0]
    return out[:n]


def compute_dtype(dc: DenoiserConfig) -> torch.dtype:
    return getattr(torch, dc.backbone.compute_dtype)


def compute_params(params, dc: DenoiserConfig):
    """The params with every product weight cast once to the compute dtype.
    ``denoiser_fwd`` casts each use to that dtype anyway, so the result is
    the same; casting once saves a pass over the weights per call."""
    return cast_leaves(params, _COMPUTE_LEAVES, compute_dtype(dc))


def denoiser_fwd(params, t, y, dc: DenoiserConfig, cond=None, attn_impl=None):
    """t: (B,) noise level / step; y: (B, L, d_data) -> x0_hat (B, L, d_data)
    float32.  cond: optional (B, d_cond).  ``attn_impl``: "flash" (default;
    the CUDA kernel on the card, its plain version on the CPU) or "naive".

    A point's output depends on that point alone, and must be the same
    bits whatever batch the point rides in (the sharded engine's rule, see
    ``_point_product``).  A MoE layer's expert products have rows in
    proportion to the points, and cuBLAS picks its kernel, with the order
    of a sum, by the row count: so a MoE backbone runs in blocks of
    ``_POINT_ROWS`` points, where every product has one shape."""
    if any(d.moe for d in dc.backbone.group) and t.shape[0] != _POINT_ROWS:
        return _in_point_blocks(
            lambda tb, yb, cb: denoiser_fwd(params, tb, yb, dc, cb, attn_impl), t, y, cond)
    cfg = dc.backbone
    cdt = compute_dtype(dc)
    tf = t.float()
    if dc.time_log:
        tf = torch.log1p(torch.clamp(tf, min=0.0))
    temb = sinusoidal_embed(tf * 100.0, dc.time_dim)
    temb = torch.tanh(_point_product(temb, params["t_mlp1"].float()))
    temb = _point_product(temb, params["t_mlp2"].float())  # (B, d_model)

    x = y.to(cdt) @ params["in_proj"].to(cdt)
    pos = torch.arange(dc.seq_len, device=y.device)
    x = x + sinusoidal_embed(pos, cfg.d_model).to(cdt)
    x = x + temb[:, None, :].to(cdt)
    if cond is not None:
        x = x + _point_product(cond.to(cdt), params["cond_proj"].to(cdt))[..., None, :]
    ctx = dict(causal=False, impl=attn_impl or "flash")
    x, _ = decoder_fwd(params["decoder"], x, cfg, ctx)
    x = rmsnorm_apply(params["final_norm"], x)
    return (x @ params["out_proj"].to(cdt)).float()


def _bcast_cond(cond, m):
    return None if cond is None else cond.expand((m,) + tuple(cond.shape[-1:]))


def make_sl_model_fn(params, dc: DenoiserConfig, cond=None, attn_impl=None):
    """ASD / sequential-sampler oracle for the SL parametrization: the net
    sees y / sqrt(t^2 + t) and returns E[x0 | y_t].

    The weights are cast to the compute dtype once, here.  The returned
    ``model_fn(t, y, cond=None)`` conditions on its own ``cond`` (m, d_cond)
    rows where given, else on the ``cond`` it was made with: a server builds
    one function and conditions each batched call, one row per point."""
    cp = compute_params(params, dc)

    def model_fn(t, y, cond_rows=None):
        t32 = torch.clamp(t.float(), min=1e-6)
        scale = torch.sqrt(t32**2 + t32)
        y_in = y / scale.reshape(tuple(t.shape) + (1,) * (y.ndim - t.ndim))
        c = cond if cond_rows is None else cond_rows
        return denoiser_fwd(cp, t32, y_in, dc, cond=_bcast_cond(c, y.shape[0]),
                            attn_impl=attn_impl)

    return model_fn


def make_ddpm_model_fn(params, dc: DenoiserConfig, cond=None, attn_impl=None):
    """x0-predicting oracle in the DDPM parametrization (t = step index);
    ``model_fn(t, y, cond=None)`` as in ``make_sl_model_fn``."""
    cp = compute_params(params, dc)

    def model_fn(t, y, cond_rows=None):
        c = cond if cond_rows is None else cond_rows
        return denoiser_fwd(cp, t.float(), y, dc, cond=_bcast_cond(c, y.shape[0]),
                            attn_impl=attn_impl)

    return model_fn


def ddpm_denoiser_loss(params, dc: DenoiserConfig, x0, abar, generator=None, cond=None,
                       s=None, eps=None):
    """The DDPM x0-prediction loss, mean((pred - x0)^2).  x0: (B, L, d_data);
    abar: (K,).  The step indices ``s`` (B,) int and the noise ``eps`` (like
    x0) are injected where given, else drawn from ``generator`` in that
    order (s uniform on 0..K-1, eps standard normal).  Trains through the
    naive attention, as the JAX package does: the flash kernel has no
    backward."""
    B, K = x0.shape[0], abar.shape[0]
    if s is None:
        s = torch.randint(0, K, (B,), generator=generator, device=x0.device)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=x0.device)
    s = s.to(x0.device)
    ab = abar.to(x0.device)[s][:, None, None]
    y = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    pred = denoiser_fwd(params, s.float(), y, dc, cond=cond, attn_impl="naive")
    return torch.mean((pred - x0) ** 2)


def sl_denoiser_loss(params, dc: DenoiserConfig, x0, generator=None, t_min=1e-2,
                     t_max=100.0, cond=None, t=None, xi=None):
    """The SL-parametrized x0-prediction loss: y_t = t x0 + sqrt(t) xi, the
    net sees y_t / sqrt(t^2 + t) and log1p(t).  The noise levels ``t`` (B,)
    and the noise ``xi`` (like x0) are injected where given, else drawn from
    ``generator`` in that order (t log-uniform on [t_min, t_max], xi
    standard normal).  Trains through the naive attention."""
    B = x0.shape[0]
    if t is None:
        u = torch.rand(B, generator=generator, device=x0.device)
        lo, hi = math.log(t_min), math.log(t_max)
        t = torch.exp(lo + (hi - lo) * u)
    if xi is None:
        xi = torch.randn(x0.shape, generator=generator, device=x0.device)
    t = t.to(x0.device)
    y = t[:, None, None] * x0 + torch.sqrt(t)[:, None, None] * xi
    scale = torch.sqrt(t**2 + t)[:, None, None]
    pred = denoiser_fwd(params, t, y / scale, dc, cond=cond, attn_impl="naive")
    return torch.mean((pred - x0) ** 2)
