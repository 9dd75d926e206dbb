"""Diffusion denoiser head: a backbone run non-causally as a DDPM mean
oracle.  The model predicts x0_hat = E[x0 | y_t], the ``g`` that ASD
consumes (paper Remark 2 / Eq. 4).

Params are a plain dict of tensors in the JAX package's tree layout (see
``repro_torch.weights``).  ``sl_denoiser_loss`` and ``ddpm_denoiser_loss``
are the training losses, with their random draws injectable.  A MoE
backbone (qwen3-moe-a3b-smoke) runs with every expert on the device, in
blocks of ``_POINT_ROWS`` points (see ``denoiser_fwd``).

Model parallelism (the JAX package's ``tp_axis``, ``sp_axis`` / ``sp_size``
and ``ep_axis``, each a ``repro_torch.distributed.group`` ``ModelGroup``
here): ``denoiser_fwd`` and the model functions take them, params sharded
by ``repro_torch.distributed.sharding.shard_params`` under
``mp_param_pspecs``; ``sp_compatible`` says whether a config can run
sequence parallelism, and ``tp_collective_payloads`` /
``mp_collective_payloads`` give the collectives' payload schedule that the
serving worker calibrates ``collective_s`` from.
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


def denoiser_fwd(params, t, y, dc: DenoiserConfig, cond=None, attn_impl=None,
                 tp_axis=None, sp_axis=None, sp_size: int = 1, ep_axis=None):
    """t: (B,) noise level / step; y: (B, L, d_data) -> x0_hat (B, L, d_data)
    float32.  cond: optional (B, d_cond).  ``attn_impl``: "flash" (default;
    the CUDA kernel on the card, its plain version on the CPU) or "naive".

    A point's output depends on that point alone, and must be the same
    bits whatever batch the point rides in (the sharded engine's rule, see
    ``_point_product``).  A MoE layer's expert products have rows in
    proportion to the points, and cuBLAS picks its kernel, with the order
    of a sum, by the row count: so a MoE backbone runs in blocks of
    ``_POINT_ROWS`` points, where every product has one shape.

    Model parallelism, each axis a ``ModelGroup`` whose every rank makes
    the same call: ``tp_axis`` (params from ``mp_param_pspecs(tensor=True)``
    sharded by ``shard_params``: the blocks compute on their head and
    hidden blocks and psum), ``ep_axis`` (the MoE expert stacks, from
    ``mp_param_pspecs(expert=True)``; composes with either), and
    ``sp_axis`` / ``sp_size`` (Ulysses: every weight replicated, so the
    caller states the factor; see ``sp_compatible``): the embedded input is
    sliced to the rank's L/sp rows here, the stream runs sequence-sharded
    through the blocks, and the output is re-replicated by one psum of the
    zero-padded slices after ``out_proj``.  SP and TP are mutually
    exclusive."""
    if any(d.moe for d in dc.backbone.group) and t.shape[0] != _POINT_ROWS:
        return _in_point_blocks(
            lambda tb, yb, cb: denoiser_fwd(params, tb, yb, dc, cb, attn_impl, tp_axis,
                                            sp_axis, sp_size, ep_axis), t, y, cond)
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
    sp = sp_axis if sp_axis is not None and sp_size > 1 else None
    if sp is not None:
        assert tp_axis is None, "sp_axis and tp_axis are mutually exclusive"
        Lc = dc.seq_len // sp_size
        lo = sp.axis_index() * Lc
        x = x[:, lo:lo + Lc]
    ctx = dict(causal=False, impl=attn_impl or "flash", tp_axis=tp_axis, sp_axis=sp,
               ep_axis=ep_axis)
    x, _ = decoder_fwd(params["decoder"], x, cfg, ctx)
    x = rmsnorm_apply(params["final_norm"], x)
    out = (x @ params["out_proj"].to(cdt)).float()
    if sp is not None:
        full = out.new_zeros((out.shape[0], dc.seq_len) + tuple(out.shape[2:]))
        full[:, lo:lo + Lc] = out
        out = sp.psum(full)  # re-replicate the denoised x0
    return out


def _bcast_cond(cond, m):
    return None if cond is None else cond.expand((m,) + tuple(cond.shape[-1:]))


def make_sl_model_fn(params, dc: DenoiserConfig, cond=None, attn_impl=None,
                     tp_axis=None, sp_axis=None, sp_size: int = 1, ep_axis=None,
                     at_use=None):
    """ASD / sequential-sampler oracle for the SL parametrization: the net
    sees y / sqrt(t^2 + t) and returns E[x0 | y_t].

    The weights are cast to the compute dtype once, here.  The returned
    ``model_fn(t, y, cond=None)`` conditions on its own ``cond`` (m, d_cond)
    rows where given, else on the ``cond`` it was made with: a server builds
    one function and conditions each batched call, one row per point.
    ``tp_axis`` / ``sp_axis`` / ``sp_size`` / ``ep_axis``: model parallelism
    (see ``denoiser_fwd``).  ``at_use``: the params are a rank's blocks of
    a serve mesh's layout (see ``_mesh_call``)."""
    cp = compute_params(params, dc)
    mp = dict(tp_axis=tp_axis, sp_axis=sp_axis, sp_size=sp_size, ep_axis=ep_axis)

    def model_fn(t, y, cond_rows=None):
        t32 = torch.clamp(t.float(), min=1e-6)
        scale = torch.sqrt(t32**2 + t32)
        y_in = y / scale.reshape(tuple(t.shape) + (1,) * (y.ndim - t.ndim))
        c = _bcast_cond(cond if cond_rows is None else cond_rows, y.shape[0])
        if at_use is not None:
            return _mesh_call(at_use(cp), t32, y_in, c, dc, attn_impl, mp)
        return denoiser_fwd(cp, t32, y_in, dc, cond=c, attn_impl=attn_impl, **mp)

    return model_fn


def _mesh_call(params, t, y, cond, dc, attn_impl, mp):
    """The model call on a rank of a serve mesh, over ``params`` as the
    forward reads them (``ServeLayout.at_use`` of the rank's blocks, read
    once a call): in blocks of ``_POINT_ROWS`` points, the last padded
    with zero points, so every product and attention call has one shape.
    A rank holds a block of the slots, and its calls carry fewer points
    than a rank of a mesh with fewer batch ranks; on the card cuBLAS picks
    a product's kernel, and with it the order of a sum, by its rows (a
    tensor-parallel ``wo`` block of 16 rows takes another kernel than one
    of 32), so without the blocks ``DxM`` would not give ``1xM``'s bits."""
    return _in_point_blocks(lambda tb, yb, cb: denoiser_fwd(params, tb, yb, dc, cond=cb,
                                                            attn_impl=attn_impl, **mp),
                            t, y, cond)


def make_ddpm_model_fn(params, dc: DenoiserConfig, cond=None, attn_impl=None,
                       tp_axis=None, sp_axis=None, sp_size: int = 1, ep_axis=None,
                       at_use=None):
    """x0-predicting oracle in the DDPM parametrization (t = step index);
    ``model_fn(t, y, cond=None)``, the model-parallel axes and ``at_use``
    as in ``make_sl_model_fn``."""
    cp = compute_params(params, dc)
    mp = dict(tp_axis=tp_axis, sp_axis=sp_axis, sp_size=sp_size, ep_axis=ep_axis)

    def model_fn(t, y, cond_rows=None):
        c = _bcast_cond(cond if cond_rows is None else cond_rows, y.shape[0])
        if at_use is not None:
            return _mesh_call(at_use(cp), t.float(), y, c, dc, attn_impl, mp)
        return denoiser_fwd(cp, t.float(), y, dc, cond=c, attn_impl=attn_impl, **mp)

    return model_fn


def sp_compatible(dc: DenoiserConfig, sp_size: int) -> tuple[bool, str]:
    """Can this denoiser run Ulysses sequence parallelism at ``sp_size``?
    SP slices the sequence through the whole block stack: recurrences
    (ssm, mamba, xlstm) scan the whole sequence and cross-attention mixes
    a second stream, so only attn blocks qualify; the two all-to-alls need
    the head and sequence axes to divide the shard count."""
    cfg = dc.backbone
    if sp_size <= 1:
        return True, "sp_size <= 1 (no sequence sharding)"
    bad = [d.kind for d in cfg.group if d.kind != "attn"]
    if bad:
        return False, f"non-attn blocks in group: {sorted(set(bad))}"
    if cfg.n_heads % sp_size:
        return False, f"n_heads={cfg.n_heads} not divisible by sp={sp_size}"
    if dc.seq_len % sp_size:
        return False, f"seq_len={dc.seq_len} not divisible by sp={sp_size}"
    return True, "ok"


def tp_collective_payloads(params, specs, dc: DenoiserConfig) -> list[int]:
    """Per-point all-reduce payload schedule (bytes) of ONE denoiser call
    under the tensor-parallel layout ``specs`` (``tp_param_pspecs``): each
    model-sharded row-parallel leaf (attention ``wo``, FFN ``w_down``)
    contributes one (L, d_model) activation psum per stacked layer."""
    # here, not at the top: sharding -> nn.param -> weights imports this module
    from repro_torch.distributed.sharding import leaf_shape, mentions_model, zip_specs
    cfg = dc.backbone
    row_bytes = dc.seq_len * cfg.d_model * compute_dtype(dc).itemsize
    payloads: list[int] = []
    for path, leaf, spec in zip_specs(params, specs):
        name, shape = path[-1], leaf_shape(leaf)
        if name not in ("wo", "w_down") or not mentions_model(spec):
            continue
        base_ndim = 3 if name == "wo" else 2
        rows = shape[0] if len(shape) > base_ndim else 1
        payloads.extend([int(row_bytes)] * rows)
    return payloads


def mp_collective_payloads(params, specs, dc: DenoiserConfig, *, mp_size: int = 1,
                           sp_size: int = 1) -> dict:
    """Per-point collective payload schedule (bytes), per kind, of one
    denoiser call under the model-parallel layout ``specs``
    (``mp_param_pspecs``) at ``mp_size`` model shards / ``sp_size``
    sequence shards, the JAX package's:

      psum        TP row-parallel wo / w_down all-reduces; the EP combine
                  (one per MoE layer, none when the stream is sequence
                  sharded); the one SP output re-replication.
      all_to_all  the EP token exchange (2 per MoE layer) and the Ulysses
                  q / k / v and output exchanges (4 per attention layer)."""
    from repro_torch.distributed.sharding import leaf_shape, mentions_model, zip_specs
    cfg = dc.backbone
    itemsize = compute_dtype(dc).itemsize
    row_bytes = int(dc.seq_len * cfg.d_model * itemsize)
    psum: list[int] = []
    a2a: list[int] = []
    seq_sharded = sp_size > 1
    ep_exchanges = mp_size > 1 and (seq_sharded or dc.seq_len % mp_size == 0)
    Lt = dc.seq_len // mp_size if ep_exchanges else dc.seq_len
    E, k = cfg.n_experts, cfg.top_k
    cap = min(int(max(1, -(-k * Lt * cfg.capacity_factor // E))), Lt) if E else 0
    for path, leaf, spec in zip_specs(params, specs):
        name, in_moe, shape = path[-1], "moe" in path, leaf_shape(leaf)
        model_sharded = mentions_model(spec)
        if name == "wo" and not in_moe:
            rows = shape[0] if len(shape) > 3 else 1
            if model_sharded:  # TP row-parallel wo
                psum.extend([row_bytes] * rows)
            if seq_sharded:  # Ulysses: q / k / v out and o back a core
                xch = int((dc.seq_len // sp_size) * cfg.n_heads * cfg.resolved_head_dim
                          * itemsize)
                a2a.extend([xch] * (4 * rows))
        elif name == "w_down" and not in_moe and model_sharded:
            rows = shape[0] if len(shape) > 2 else 1
            psum.extend([row_bytes] * rows)  # TP row-parallel FFN
        elif name == "w_gate" and in_moe and model_sharded:
            rows = shape[0] if len(shape) > 3 else 1
            if ep_exchanges:  # capacity rows out and expert outputs back
                a2a.extend([int(E * cap * cfg.d_model * itemsize)] * (2 * rows))
            if not seq_sharded:  # EP row-parallel combine
                psum.extend([row_bytes] * rows)
    if seq_sharded:
        psum.append(int(dc.seq_len * dc.d_data * 4))  # f32 x0 re-replication
    return {"psum": psum, "all_to_all": a2a}


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
