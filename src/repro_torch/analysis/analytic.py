"""First-principles FLOP and memory-traffic model of each (arch x shape)
cell: the port's copy of the JAX package's ``analysis/analytic.py``, over
the port's configs.

The counts are the model's work, whatever runs it: forward flops of each
block, a decode step's flops, the KV cache's bytes, and a whole step's
flops and idealised memory traffic (``analyze_cell``).  They give a run
on the card the least time it could take (flops over the peak rate, or
bytes over the memory rate).  All counts are global (the whole step, every
device); 2 flops a multiply-add; bf16 is 2 bytes unless stated.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import BlockDesc, InputShape, ModelConfig

BF16 = 2
F32 = 4


def _attn_core_ctx(L: int, window: int) -> float:
    """Average attended context length per query token (causal)."""
    if window and window < L:
        # token i attends min(i+1, w); average ~ w - w^2/(2L)
        return window - window * window / (2.0 * L)
    return (L + 1) / 2.0


def block_fwd_flops(cfg: ModelConfig, desc: BlockDesc, L: int, window: int) -> float:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ff = cfg.d_ff
    fl = 0.0
    if desc.kind in ("attn", "hymba", "xattn"):
        if desc.kind == "xattn":
            Nv = cfg.n_vision_tokens
            fl += 2 * L * d * H * hd  # q
            fl += 2 * 2 * Nv * d * KV * hd  # k,v over vision tokens
            fl += 2 * 2 * L * Nv * H * hd  # scores + pv
            fl += 2 * L * H * hd * d  # o
        else:
            ctx = _attn_core_ctx(L, window)
            fl += 2 * L * d * H * hd + 2 * 2 * L * d * KV * hd
            fl += 2 * 2 * L * ctx * H * hd
            fl += 2 * L * H * hd * d
    if desc.kind == "hymba":
        fl += mamba_fwd_flops(cfg, L)
    if desc.kind == "mlstm":
        din = 2 * d
        fl += 2 * L * d * 2 * din  # up_proj
        fl += 2 * L * din * cfg.ssm_conv  # conv
        fl += 3 * 2 * L * din * din  # q,k,v
        fl += 2 * 2 * L * ((L + 1) / 2.0) * din  # quadratic decay-masked core
        fl += 2 * L * din * d  # down
    if desc.kind == "slstm":
        dh = d // H
        dff = int(d * 4 / 3)
        fl += 2 * L * d * 4 * d  # input gates
        fl += 2 * L * 4 * H * dh * dh  # recurrent gates
        fl += 2 * L * (2 * d * dff + dff * d)  # glu-ish tail
    # FFN
    if ff:
        if desc.moe:
            E, k = cfg.n_experts, cfg.top_k
            fl += 2 * L * d * E  # router
            fl += 2 * L * k * 3 * d * ff  # top-k expert swiglu
        else:
            n_mats = 2 if cfg.ffn_kind == "gelu" else 3
            fl += 2 * L * n_mats * d * ff
    return fl


def mamba_fwd_flops(cfg: ModelConfig, L: int) -> float:
    d = cfg.d_model
    din = cfg.d_inner
    N, ck = cfg.ssm_state, cfg.ssm_conv
    dtr = max(1, d // 16)
    fl = 2 * L * d * 2 * din  # in_proj
    fl += 2 * L * din * ck  # conv
    fl += 2 * L * din * (dtr + 2 * N)  # x_proj
    fl += 2 * L * dtr * din  # dt_proj
    fl += 8 * L * din * N  # scan (decay, drive, combine) elementwise
    fl += 2 * L * din * N  # C contraction
    fl += 2 * L * din * d  # out_proj
    return fl


def model_fwd_flops(cfg: ModelConfig, L: int) -> float:
    """Forward flops for one sequence of length L (batch row)."""
    fl = 0.0
    for gi, desc in enumerate(cfg.group):
        wins = (
            desc.window_per_repeat
            if desc.window_per_repeat is not None
            else [desc.window] * cfg.n_repeats
        )
        for w in wins:
            fl += block_fwd_flops(cfg, desc, L, w)
    fl += 2 * L * cfg.d_model * cfg.vocab_size  # head
    return fl


def decode_step_flops(cfg: ModelConfig, S: int) -> float:
    """One new token against a context of S (per batch row)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    fl = 0.0
    for desc in cfg.group:
        wins = (
            desc.window_per_repeat
            if desc.window_per_repeat is not None
            else [desc.window] * cfg.n_repeats
        )
        for w in wins:
            if desc.kind in ("attn", "hymba"):
                ctx = min(S, w) if w else S
                fl += 2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d
                fl += 2 * 2 * ctx * H * hd
            if desc.kind == "xattn":
                Nv = cfg.n_vision_tokens
                fl += 2 * d * H * hd + 2 * H * hd * d + 2 * 2 * Nv * H * hd
            if desc.kind == "hymba":
                fl += mamba_fwd_flops(cfg, 1)
            if desc.kind == "mlstm":
                din = 2 * d
                fl += 2 * d * 2 * din + 3 * 2 * din * din + 2 * 2 * din * (din // H) + 2 * din * d
            if desc.kind == "slstm":
                dh = d // H
                dff = int(d * 4 / 3)
                fl += 2 * d * 4 * d + 2 * 4 * H * dh * dh + 2 * (2 * d * dff + dff * d)
            if cfg.d_ff:
                if desc.moe:
                    fl += 2 * d * cfg.n_experts + 2 * cfg.top_k * 3 * d * cfg.d_ff
                else:
                    n_mats = 2 if cfg.ffn_kind == "gelu" else 3
                    fl += 2 * n_mats * d * cfg.d_ff
    fl += 2 * d * cfg.vocab_size
    return fl


def kv_cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    """Total KV-cache (+ recurrent state) bytes for the whole stack."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    total = 0.0
    for desc in cfg.group:
        n = cfg.n_repeats
        if desc.kind in ("attn", "hymba"):
            total += n * B * S * KV * hd * 2 * BF16
        if desc.kind == "xattn":
            total += n * B * cfg.n_vision_tokens * KV * hd * 2 * BF16
        if desc.kind == "hymba":
            total += n * B * (cfg.d_inner * cfg.ssm_state + cfg.d_inner * cfg.ssm_conv) * F32
        if desc.kind == "mlstm":
            din = 2 * cfg.d_model
            total += n * B * (din * (din // cfg.n_heads) + 2 * din) * F32
        if desc.kind == "slstm":
            total += n * B * 4 * cfg.d_model * F32
    return total


@dataclasses.dataclass
class CellCost:
    flops: float  # global executed flops per step
    hbm_bytes: float  # global idealized HBM traffic per step
    model_flops: float  # 6*N_active*tokens (train) / 2*N_active (serve)
    notes: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


def params_active(cfg: ModelConfig, total: int) -> int:
    if not cfg.n_experts:
        return total
    # expert weights are 3*d*ff*E per moe layer
    moe_layers = sum(
        cfg.n_repeats for d in cfg.group if d.moe
    )
    expert_p = moe_layers * 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
    return total - expert_p + expert_p * cfg.top_k // cfg.n_experts


def analyze_cell(cfg: ModelConfig, shape: InputShape, n_params: int,
                 accum: int = 8, remat: bool = True) -> CellCost:
    B, L = shape.global_batch, shape.seq_len
    p_bytes = n_params * F32
    n_active = params_active(cfg, n_params)

    if shape.kind == "train":
        fwd = B * model_fwd_flops(cfg, L)
        factor = 4.0 if remat else 3.0  # fwd + 2x bwd (+1 remat re-fwd)
        flops = fwd * factor
        act_tok_bytes = cfg.n_layers * cfg.d_model * BF16 * 4  # saved per token
        hbm = (
            accum * 3 * p_bytes / 2  # weight reads (fwd+bwd), bf16 casts
            + accum * 2 * p_bytes  # grad accumulate read+write (f32)
            + 6 * p_bytes  # adam: read/write p, mu, nu
            + B * L * act_tok_bytes * 2  # activation save + re-read
        )
        mf = 6.0 * n_active * B * L
        return CellCost(flops, hbm, mf, f"accum={accum} remat={remat}")

    if shape.kind == "prefill":
        flops = B * model_fwd_flops(cfg, L)
        n_qblocks = max(1, L // 2048)
        hbm = (
            p_bytes / 2  # one bf16 weight pass
            + kv_cache_bytes(cfg, B, L)  # cache write
            + kv_cache_bytes(cfg, B, L) * n_qblocks / 2  # chunked re-reads (causal avg)
            + B * L * cfg.n_layers * cfg.d_model * BF16 * 2  # stream activations
        )
        mf = 2.0 * n_active * B * L
        return CellCost(flops, hbm, mf, f"chunk=2048 qblocks={n_qblocks}")

    # decode: one token per row against an S-long cache
    S = L
    flops = B * decode_step_flops(cfg, S)
    # every weight is touched once; the whole (windowed) cache is read once
    eff_cache = 0.0
    for desc in cfg.group:
        n = cfg.n_repeats
        if desc.kind in ("attn", "hymba"):
            wins = (
                desc.window_per_repeat
                if desc.window_per_repeat is not None
                else [desc.window] * cfg.n_repeats
            )
            for w in wins:
                ctx = min(S, w) if w else S
                eff_cache += B * ctx * cfg.n_kv_heads * cfg.resolved_head_dim * 2 * BF16
        elif desc.kind == "xattn":
            eff_cache += (n * B * cfg.n_vision_tokens * cfg.n_kv_heads
                          * cfg.resolved_head_dim * 2 * BF16)
        else:
            eff_cache += kv_cache_bytes(cfg, B, 0)
    active_bytes = params_active(cfg, n_params) * BF16
    hbm = active_bytes + eff_cache
    mf = 2.0 * n_active * B
    return CellCost(flops, hbm, mf, f"ctx={S}")
