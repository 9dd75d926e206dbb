"""The arithmetic of B2's wgmma kernel (``csrc/flash_attention_wgmma.cu``),
emulated in plain PyTorch on the CPU and held against the plain version and
the JAX package's reference.

The emulation follows the kernel step by step: 128-row query tiles in two
64-row halves (the consumer warpgroups; above dh 192 64-row tiles, whose
warpgroups split O's columns and compute the same rows), BK-key tiles (128
for dh <= 64, else 64) visited by the TPU kernel's band rule, scores moved to the base-2
domain (the scale folded into the exponent on interior tiles, the mask
applied only on tiles that cut the band edge, seq_k or the ragged end),
the online softmax with the -1e30 mask and the -inf starting max, and
P = P_hi + P_lo (p truncated to bf16, and the remainder rounded to bf16)
in the P V product.  The card runs the kernel itself
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention.ops import attention_plain

BQ = 128
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MASKED_LOG2 = torch.tensor(-1e30, dtype=torch.float32) * LOG2E


def _keys_per_tile(dh):
    return 128 if dh <= 64 else 64


def _query_rows(dh):
    """Query rows a block: 128 (two 64-row halves), 64 above dh 192."""
    return 64 if dh > 192 else BQ


def _tile_range(q0, S, BK, causal, window, rows=BQ):
    """The kernel's kv_tile_range: tiles [lo, hi) a query tile of ``rows``
    rows at q0 visits."""
    hi = -(-S // BK)
    if causal:
        hi = min(hi, (q0 + rows - 1) // BK + 1)
    lo = 0
    if window:
        first_key = q0 - window - BK + 2
        if first_key > 0:
            lo = -(-first_key // BK)
    return lo, hi


def _is_edge(k0, BK, qw0, seq_k, causal, window):
    """Whether a key tile needs the element mask for the 64 rows at qw0."""
    return ((k0 + BK > seq_k) or (causal and k0 + BK - 1 > qw0)
            or bool(window and (qw0 + 63) - k0 >= window))


def _pair_mask(rows, cols, seq_k, causal, window):
    r, c = rows[:, None], cols[None, :]
    ok = c < seq_k
    if causal:
        ok = ok & (c <= r)
    if window:
        ok = ok & ((r - c) < window)
    return ok


def _split(p):
    """P_hi: p's top 16 bits (truncated to bf16); P_lo: p - P_hi, exact in
    float32, rounded to bf16."""
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).float()


def emulate(q, k, v, *, causal, window=0, softcap=0.0, true_seq_k=None):
    """The wgmma kernel's arithmetic on q (B, Lq, H, dh), k, v (B, S, H, dh)
    in bf16; returns float32 (B, Lq, H, dh) before the final bf16 rounding."""
    B, Lq, H, dh = q.shape
    S = k.shape[1]
    seq_k = S if true_seq_k is None else true_seq_k
    BK, rows_a_block = _keys_per_tile(dh), _query_rows(dh)
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))  # (B, H, n, dh)
    sqrt_dh = torch.tensor(math.sqrt(dh), dtype=torch.float32)
    pow2 = dh in (16, 64, 256)
    scale_log2 = LOG2E / sqrt_dh
    out = torch.zeros(B, H, Lq, dh)

    def rows_of(x, start, n):  # zero-filled past the end, as TMA fills
        part = x[:, :, start:start + n]
        return torch.nn.functional.pad(part, (0, 0, 0, n - part.shape[2]))

    for q0 in range(0, Lq, rows_a_block):
        lo, hi = _tile_range(q0, S, BK, causal, window, rows_a_block)
        for qw0 in range(q0, q0 + rows_a_block, 64):
            rows = torch.arange(qw0, qw0 + 64)
            Q = rows_of(qf, qw0, 64)
            m = torch.full((B, H, 64, 1), -math.inf)
            l = torch.zeros(B, H, 64, 1)
            acc = torch.zeros(B, H, 64, dh)
            for t in range(lo, hi):
                k0 = t * BK
                K, V = rows_of(kf, k0, BK), rows_of(vf, k0, BK)
                s = Q @ K.transpose(-1, -2)
                edge = _is_edge(k0, BK, qw0, seq_k, causal, window)
                folded = not edge and softcap == 0.0 and pow2
                c = scale_log2 if folded else torch.tensor(1.0)
                if not folded:
                    x = s * (1.0 / sqrt_dh) if pow2 else s / sqrt_dh
                    if softcap:
                        s = softcap * torch.tanh(x / softcap) * LOG2E
                    else:
                        s = s * scale_log2 if pow2 else x * LOG2E
                    if edge:
                        ok = _pair_mask(rows, torch.arange(k0, k0 + BK), seq_k, causal,
                                        window)
                        s = torch.where(ok, s, MASKED_LOG2)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
                alpha = torch.exp2(m - m_new)
                # fma(s, c, -m): one rounding of the exact s * c - m
                p = torch.exp2((s.double() * c.double() - m_new.double()).float())
                l = l * alpha + p.sum(-1, keepdim=True)
                p_hi, p_lo = _split(p)
                acc = acc * alpha + (p_hi @ V + p_lo @ V)
                m = m_new
            n = min(64, Lq - qw0)
            if n > 0:
                out[:, :, qw0:qw0 + n] = (acc / torch.clamp(l, min=1e-30))[:, :, :n]
    return out.permute(0, 2, 1, 3)


# name: (B, Lq, S, H, dh, options)
CASES = {
    "non-causal": (2, 256, 256, 2, 64, dict(causal=False)),
    "causal": (2, 300, 300, 2, 64, dict(causal=True)),
    "causal window 48 (cuts tiles)": (1, 300, 300, 2, 64, dict(causal=True, window=48)),
    "causal window 130": (1, 400, 400, 1, 64, dict(causal=True, window=130)),
    "softcap 5": (2, 200, 200, 2, 64, dict(causal=False, softcap=5.0)),
    "ragged L=129 S=255": (2, 129, 255, 2, 64, dict(causal=False)),
    "ragged causal L=S=130": (1, 130, 130, 3, 64, dict(causal=True)),
    "true_seq_k 100 of 255": (2, 128, 255, 2, 64, dict(causal=False, true_seq_k=100)),
    "dh=16": (2, 150, 150, 2, 16, dict(causal=True)),
    "dh=72": (2, 150, 150, 2, 72, dict(causal=False)),
    "dh=72 causal window 40": (1, 200, 200, 2, 72, dict(causal=True, window=40)),
    "dh=136 causal window 40": (1, 200, 200, 2, 136, dict(causal=True, window=40)),
    "dh=192 causal softcap 50": (1, 150, 150, 2, 192, dict(causal=True, softcap=50.0)),
    "dh=256 causal window 70 softcap 50 (64-row tiles)": (
        1, 200, 200, 2, 256, dict(causal=True, window=70, softcap=50.0)),
    "dh=256 ragged causal L=S=130": (1, 130, 130, 2, 256, dict(causal=True)),
}


def _inputs(case):
    B, L, S, H, dh, opts = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H, dh)).astype(np.float32))
               .to(torch.bfloat16) for n in (L, S, S))
    return q, k, v, opts


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_holds_the_gate_against_the_plain_version(case):
    """The bf16 output within 1e-4 + 2^-7 |plain| per element: chip_smoke's
    gate for the kernel on the card."""
    q, k, v, opts = _inputs(case)
    got = emulate(q, k, v, **opts).to(torch.bfloat16).float()
    plain = attention_plain(q, k, v, **opts).float()
    used = ((got - plain).abs() / (1e-4 + 2.0 ** -7 * plain.abs())).max().item()
    assert used <= 1.0, f"{used} of the gate"


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_the_jax_reference(case):
    """Before the output rounding, the emulation against the JAX package's
    attention_ref in float32 on the same bf16 values, within the 1e-5 of
    tests/test_torch_attention.py; above 128 columns, where more elements
    come near it, plus the P split's own bound, 2^-16 max |v| (P_hi + P_lo
    is p within 2^-16 p).  Keys past true_seq_k are cut off for the
    reference, which has no such option."""
    q, k, v, opts = _inputs(case)
    got = emulate(q, k, v, **opts)
    B, L, H, dh = q.shape
    seq_k = opts.get("true_seq_k", k.shape[1])
    flat = lambda x: jnp.asarray(x.float().permute(0, 2, 1, 3).reshape(B * H, -1, dh).numpy())  # noqa: E731
    ref = j_attention_ref(flat(q), flat(k[:, :seq_k]), flat(v[:, :seq_k]),
                          causal=opts["causal"], window=opts.get("window", 0),
                          softcap=opts.get("softcap", 0.0))
    ref = np.asarray(ref).reshape(B, H, L, dh).transpose(0, 2, 1, 3)
    atol = 1e-5 if dh <= 128 else 1e-5 + 2.0 ** -16 * v.float().abs().max().item()
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_schedule_visits_every_unmasked_pair(case):
    """Every (q, k) pair the mask keeps lies in a visited tile; a skipped
    tile holds masked pairs only; a tile taken without the element mask
    holds no masked pair in its 64 rows."""
    B, L, S, H, dh, opts = CASES[case]
    causal, window = opts["causal"], opts.get("window", 0)
    seq_k = opts.get("true_seq_k", S)
    BK, rows_a_block = _keys_per_tile(dh), _query_rows(dh)
    n_kv = -(-S // BK)
    for q0 in range(0, L, rows_a_block):
        lo, hi = _tile_range(q0, S, BK, causal, window, rows_a_block)
        rows = torch.arange(q0, min(q0 + rows_a_block, L))
        for t in range(n_kv):
            cols = torch.arange(t * BK, min((t + 1) * BK, S))
            kept = _pair_mask(rows, cols, seq_k, causal, window)
            if not lo <= t < hi:
                assert not kept.any(), (q0, t)
                continue
            for qw0 in range(q0, q0 + rows_a_block, 64):
                if not _is_edge(t * BK, BK, qw0, seq_k, causal, window):
                    wg_rows = torch.arange(qw0, qw0 + 64)
                    assert _pair_mask(wg_rows, torch.arange(t * BK, (t + 1) * BK), seq_k,
                                      causal, window).all(), (q0, qw0, t)


def test_split_of_p_is_within_2_to_the_minus_16():
    p = torch.rand(100_000) ** 3
    hi, lo = _split(p)
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert ((hi + lo - p).abs() <= 2.0 ** -16 * p).all()


def test_a_single_bf16_p_would_break_the_gate():
    """Why the kernel splits P: with P rounded once to bf16 the causal
    window case moves outputs by more than the gate."""
    q, k, v, opts = _inputs("causal window 48 (cuts tiles)")
    s = torch.einsum("blhk,bshk->bhls", q.float(), k.float()) / 8.0
    L = q.shape[1]
    i = torch.arange(L)
    mask = (i[None, :] <= i[:, None]) & ((i[:, None] - i[None, :]) < 48)
    p = torch.softmax(torch.where(mask, s, torch.tensor(-1e30)), dim=-1)
    single = torch.einsum("bhls,bshk->blhk", p.to(torch.bfloat16).float(), v.float())
    plain = attention_plain(q, k, v, **opts).float()
    used = ((single.to(torch.bfloat16).float() - plain).abs()
            / (1e-4 + 2.0 ** -7 * plain.abs())).max().item()
    assert used > 1.0
