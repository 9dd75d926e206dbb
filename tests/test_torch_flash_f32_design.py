"""The arithmetic of B2's float32 kernel (``csrc/flash_attention.cu``),
emulated in plain PyTorch on the CPU and held against the plain version
and the JAX package's reference and Pallas kernel (interpret mode).

Two designs, picked by ``f32_design``:

- tensor cores: 64-row query tiles, 64-key tiles visited by the TPU
  kernel's band rule, the online softmax with the -1e30 mask and the -inf
  starting max, and both products in 3xTF32: every operand split into
  hi = tf32(x) and lo = tf32(x - hi) (``cvt.rna``: round to nearest, ties
  away from zero, 10 mantissa bits, done here on int32 views), each product
  a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in float32 over k-steps of
  8 as ``mma.sync.m16n8k8`` takes them;
- packed: a (batch, head) pair's whole problem is one tile; 4-warp blocks
  hold 4 // ceil(Lq / 16) pairs, a warp 16 query rows; float32 products and
  a one-tile softmax over the pair's keys.

The card runs the kernel itself (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention.ops import (PACKED_MAX_SEQ, attention_plain,
                                                      f32_design, vec_loads)

TILE = 64  # query rows a block and keys a tile (tensor-core design)
WARP_ROWS = 16
MASKED = torch.tensor(-1e30, dtype=torch.float32)
# chip_smoke.py's and tests/test_torch_cuda.py's float32 gate
ATOL = RTOL = 2e-5


def tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 mantissa bits, ties away from zero
    (adding half of the 13 dropped bits to the magnitude, then truncating)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _padded_width(dh):
    return next(p for p in (16, 32, 64, 96, 128) if dh <= p)


def mma_product(a, b, passes=3):
    """a (..., m, kk) @ b (..., kk, n) on the tensor cores: k-steps of 8, each
    accumulating a_lo b_hi, a_hi b_lo, then a_hi b_hi (3xTF32), or a_hi b_hi
    alone (passes=1, one TF32 pass) into a float32 sum."""
    ah, al = split(a)
    bh, bl = split(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ka, kb = (slice(None),) * (a.dim() - 1) + (slice(k0, k0 + 8),), slice(k0, k0 + 8)
        if passes == 3:
            acc = acc + al[ka] @ bh[..., kb, :]
            acc = acc + ah[ka] @ bl[..., kb, :]
        acc = acc + ah[ka] @ bh[..., kb, :]
    return acc


def tile_range(q0, S, causal, window):
    """The key tiles [lo, hi) a 64-row query tile at q0 visits: the TPU
    kernel's rule (causal: k0 <= q0 + 63; window: q0 - (k0 + 63) < window)."""
    hi = -(-S // TILE)
    if causal:
        hi = min(hi, (q0 + TILE - 1) // TILE + 1)
    lo = 0
    if window:
        first_key = q0 - window - TILE + 2
        if first_key > 0:
            lo = -(-first_key // TILE)
    return lo, hi


def is_edge(k0, qw0, seq_k, causal, window):
    """Whether a warp (16 rows from qw0) applies the element mask to the
    key tile at k0: the kernel's test."""
    return (k0 + TILE > seq_k or (causal and k0 + TILE - 1 > qw0)
            or bool(window and qw0 + WARP_ROWS - 1 - k0 >= window))


def pair_mask(rows, cols, seq_k, causal, window):
    r, c = rows[:, None], cols[None, :]
    ok = c < seq_k
    if causal:
        ok = ok & (c <= r)
    if window:
        ok = ok & ((r - c) < window)
    return ok


def _logits(s, dh, softcap):
    """softcap(s / sqrt(dh)): the kernel's quotient is the float32 division's
    (test_logit_quotient_is_the_float32_division)."""
    x = s / math.sqrt(dh)
    return softcap * torch.tanh(x / softcap) if softcap else x


def emulate_tensor_core(q, k, v, *, causal, window=0, softcap=0.0, true_seq_k=None,
                        passes=3):
    """The tensor-core design on float32 q (B, Lq, H, dh), k, v (B, S, H, dh)."""
    B, Lq, H, dh = q.shape
    S = k.shape[1]
    seq_k = S if true_seq_k is None else true_seq_k
    hdp = _padded_width(dh)

    def pad(x, n):  # (B, H, n rounded up to 64, hdp), zero-filled as the copies fill
        x = x.permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, hdp - dh, 0, -(-n // TILE) * TILE - n))

    qp, kp, vp = pad(q, Lq), pad(k, S), pad(v, S)
    out = torch.zeros(B, H, Lq, dh)
    for q0 in range(0, Lq, TILE):
        rows = torch.arange(q0, q0 + TILE)
        Q = qp[:, :, q0:q0 + TILE]
        m = torch.full((B, H, TILE, 1), -math.inf)
        l = torch.zeros(B, H, TILE, 1)
        acc = torch.zeros(B, H, TILE, hdp)
        lo, hi = tile_range(q0, S, causal, window)
        for t in range(lo, hi):
            K, V = kp[:, :, t * TILE:(t + 1) * TILE], vp[:, :, t * TILE:(t + 1) * TILE]
            s = _logits(mma_product(Q, K.transpose(-1, -2), passes), dh, softcap)
            ok = pair_mask(rows, torch.arange(t * TILE, (t + 1) * TILE), seq_k, causal, window)
            s = torch.where(ok, s, MASKED)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + mma_product(p, V, passes)
            m = m_new
        n = min(TILE, Lq - q0)
        out[:, :, q0:q0 + n] = (acc / torch.clamp(l, min=1e-30))[:, :, :n, :dh]
    return out.permute(0, 2, 1, 3)


def packed_schedule(BH, Lq):
    """(block, warp) -> (pair, 16-row chunk) of the packed design: a block of
    4 warps, ceil(Lq / 16) warps a pair, 4 // that many pairs a block."""
    qc = -(-Lq // WARP_ROWS)
    pb = 4 // qc
    for block in range(-(-BH // pb)):
        for warp in range(4):
            lp, chunk = divmod(warp, qc)
            pair = block * pb + lp
            if lp < pb and pair < BH and chunk * WARP_ROWS < Lq:
                yield block, warp, pair, chunk


def emulate_packed(q, k, v, *, causal, window=0, softcap=0.0, true_seq_k=None):
    """The packed design on float32 q (B, Lq, H, dh), k, v (B, S, H, dh),
    Lq and S at most 64: each warp's rows over all S keys in one tile."""
    B, Lq, H, dh = q.shape
    S = k.shape[1]
    seq_k = S if true_seq_k is None else true_seq_k
    qf, kf, vf = (x.permute(0, 2, 1, 3).reshape(B * H, -1, dh) for x in (q, k, v))
    out = torch.full((B * H, Lq, dh), math.nan)
    for _, _, pair, chunk in packed_schedule(B * H, Lq):
        rows = torch.arange(chunk * WARP_ROWS, min((chunk + 1) * WARP_ROWS, Lq))
        s = _logits(qf[pair, rows] @ kf[pair].T, dh, softcap)
        s = torch.where(pair_mask(rows, torch.arange(S), seq_k, causal, window), s, MASKED)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        out[pair, rows] = (p @ vf[pair]) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.reshape(B, H, Lq, dh).permute(0, 2, 1, 3)


def emulate(q, k, v, **opts):
    design = f32_design(q.shape[1], k.shape[1])
    fn = emulate_packed if design == "packed" else emulate_tensor_core
    return design, fn(q, k, v, **opts)


# name: (B, Lq, S, H, dh, options, design)
CASES = {
    "tc non-causal L=S=130": (1, 130, 130, 2, 64, dict(causal=False), "tensor_core"),
    "tc causal dh=32": (1, 200, 200, 2, 32, dict(causal=True), "tensor_core"),
    "tc causal window 48 (cuts tiles)": (1, 300, 300, 2, 64,
                                         dict(causal=True, window=48), "tensor_core"),
    "tc window 70 non-causal": (1, 260, 260, 1, 64, dict(causal=False, window=70),
                                "tensor_core"),
    "tc softcap 5": (2, 100, 100, 2, 64, dict(causal=False, softcap=5.0), "tensor_core"),
    "tc ragged L=65 S=200 dh=24": (2, 65, 200, 2, 24, dict(causal=False), "tensor_core"),
    "tc true_seq_k 100 of 255 dh=72": (1, 129, 255, 2, 72,
                                       dict(causal=False, true_seq_k=100), "tensor_core"),
    "tc dh=16 causal": (1, 150, 150, 2, 16, dict(causal=True), "tensor_core"),
    "tc dh=128 L=70 S=90": (1, 70, 90, 2, 128, dict(causal=False), "tensor_core"),
    "tc boundary S=65": (2, 64, 65, 2, 32, dict(causal=False), "tensor_core"),
    "packed policy (L 16, dh 32)": (6, 16, 16, 4, 32, dict(causal=False), "packed"),
    "packed pixel (L 64, dh 24)": (2, 64, 64, 4, 24, dict(causal=False), "packed"),
    "packed causal L=40 S=63 dh=16": (3, 40, 63, 3, 16, dict(causal=True), "packed"),
    "packed window 5 L=33 dh=72": (2, 33, 64, 2, 72, dict(causal=True, window=5), "packed"),
    "packed softcap 3 dh=128": (1, 20, 50, 3, 128, dict(causal=False, softcap=3.0),
                                "packed"),
    "packed true_seq_k 10 of 30": (5, 30, 30, 1, 32, dict(causal=False, true_seq_k=10),
                                   "packed"),
}


def _inputs(case):
    B, L, S, H, dh, opts, _ = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, n, H, dh)).astype(np.float32))
               for n in (L, S, S))
    return q, k, v, opts


def _gate_used(got, ref):
    """max |got - ref| / (ATOL + RTOL |ref|): at most 1 passes."""
    ref = torch.from_numpy(np.array(ref))
    return ((got - ref).abs() / (ATOL + RTOL * ref.abs())).max().item()


def _flat(x):
    B, n, H, dh = x.shape
    return jnp.asarray(x.permute(0, 2, 1, 3).reshape(B * H, n, dh).numpy())


def _unflat(x, B, H):
    x = np.asarray(x)
    return x.reshape(B, H, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_holds_the_gate_against_the_plain_version(case):
    q, k, v, opts = _inputs(case)
    design, got = emulate(q, k, v, **opts)
    assert design == CASES[case][-1]
    used = _gate_used(got, attention_plain(q, k, v, **opts))
    assert used <= 1.0, f"{used} of the gate"


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_the_jax_reference(case):
    """Against attention_ref at the same gate; keys past true_seq_k are cut
    off for the reference, which has no such option."""
    q, k, v, opts = _inputs(case)
    _, got = emulate(q, k, v, **opts)
    B, _, H, _ = q.shape
    seq_k = opts.get("true_seq_k", k.shape[1])
    ref = j_attention_ref(_flat(q), _flat(k[:, :seq_k]), _flat(v[:, :seq_k]),
                          causal=opts["causal"], window=opts.get("window", 0),
                          softcap=opts.get("softcap", 0.0))
    used = _gate_used(got, _unflat(ref, B, H))
    assert used <= 1.0, f"{used} of the gate"


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernel_matches_the_pallas_kernel(case):
    """Against the TPU kernel itself in interpret mode (64-row blocks, q and
    k padded to them, keys past true_seq_k masked by the kernel), as the JAX
    package's own tests run it on the CPU."""
    q, k, v, opts = _inputs(case)
    _, got = emulate(q, k, v, **opts)
    B, Lq, H, _ = q.shape
    S = k.shape[1]
    pad = lambda x, n: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, -(-n // 64) * 64 - n))  # noqa: E731
    out = j_flash_attention(_flat(pad(q, Lq)), _flat(pad(k, S)), _flat(pad(v, S)),
                            causal=opts["causal"], window=opts.get("window", 0),
                            softcap=opts.get("softcap", 0.0), block_q=64, block_k=64,
                            true_seq_k=opts.get("true_seq_k", S), interpret=True)
    used = _gate_used(got, _unflat(out, B, H)[:, :Lq])
    assert used <= 1.0, f"{used} of the gate"


@pytest.mark.parametrize("case", ["tc causal window 48 (cuts tiles)", "tc softcap 5",
                                  "tc ragged L=65 S=200 dh=24"])
def test_one_tf32_pass_breaks_the_gate(case):
    """Why the kernel takes three products: one TF32 pass (hi x hi) moves the
    output past the float32 gate, so the gate sees that fault."""
    q, k, v, opts = _inputs(case)
    used = _gate_used(emulate_tensor_core(q, k, v, passes=1, **opts),
                      attention_plain(q, k, v, **opts))
    assert used > 1.0, f"one TF32 pass used only {used} of the gate"


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp,
                      -(1 + ulp / 2), 3.0e-30, 1e30])
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0e-30, 1e30])
    got = tf32(x)
    assert torch.equal(got.view(torch.int32) & 0x1FFF, torch.zeros(7, dtype=torch.int32))
    assert torch.allclose(got[:5], want[:5], rtol=0, atol=0)
    assert ((got[5:] - want[5:]).abs() <= 2.0 ** -11 * want[5:].abs()).all()


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32, ties to even, exactly."""
    near = np.float32(float(x))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.array(c).view(np.int32)) & 1))
    return Fraction(float(best))


def _fmaf(a, b, c):
    return _rn32(a * b + c)


@pytest.mark.parametrize("dh", [16, 18, 24, 32, 64, 72, 96, 128])
def test_logit_quotient_is_the_float32_division(dh):
    """The kernel's logit: q = RN(dot r), r = RN(1 / RN(sqrt dh)), then
    RN(q + RN(dot - q sqrt) r) with both steps fused multiply-adds (exact
    here in rationals) equals the float32 division the plain version and
    the JAX reference take, bit for bit."""
    sq = np.sqrt(np.float32(dh))
    assert sq == np.float32(dh ** 0.5)
    inv = Fraction(float(np.float32(1) / sq))
    sq = Fraction(float(sq))
    rng = np.random.default_rng(dh)
    dots = (rng.standard_normal(600) * np.exp(rng.uniform(-8, 8, 600))).astype(np.float32)
    want = (torch.from_numpy(dots) / math.sqrt(dh)).numpy()
    for dot, w in zip(dots, want):
        d = Fraction(float(dot))
        q = _rn32(d * inv)
        got = _fmaf(_fmaf(-q, sq, d), inv, q)
        assert got == Fraction(float(w)), (dh, float(dot))


def test_split_leaves_less_than_2_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(100_000)
                         .astype(np.float32)) * 10
    hi, lo = split(x)
    assert torch.equal(hi, tf32(hi)) and torch.equal(lo, tf32(lo))
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("case", [c for c in sorted(CASES) if CASES[c][-1] == "tensor_core"])
def test_tile_schedule_visits_every_unmasked_pair(case):
    """Every (q, k) pair the mask keeps lies in a visited tile; a skipped
    tile holds masked pairs only; a tile a warp takes without the element
    mask holds no masked pair in the warp's 16 rows."""
    B, L, S, H, dh, opts, _ = CASES[case]
    causal, window = opts["causal"], opts.get("window", 0)
    seq_k = opts.get("true_seq_k", S)
    for q0 in range(0, L, TILE):
        lo, hi = tile_range(q0, S, causal, window)
        rows = torch.arange(q0, min(q0 + TILE, L))
        for t in range(-(-S // TILE)):
            cols = torch.arange(t * TILE, (t + 1) * TILE)
            if not lo <= t < hi:
                assert not pair_mask(rows, cols, seq_k, causal, window).any(), (q0, t)
                continue
            for qw0 in range(q0, q0 + TILE, WARP_ROWS):
                if not is_edge(t * TILE, qw0, seq_k, causal, window):
                    assert pair_mask(torch.arange(qw0, qw0 + WARP_ROWS), cols, seq_k,
                                     causal, window).all(), (q0, qw0, t)


@pytest.mark.parametrize("BH,Lq", [(768, 16), (512, 64), (7, 40), (5, 33), (1, 1), (9, 17)])
def test_packed_schedule_covers_every_row_once(BH, Lq):
    """Each (pair, 16-row chunk) has one warp; blocks hold 4 // ceil(Lq/16)
    pairs (the policy stand-in's 768 pairs in 192 blocks)."""
    got = [(pair, chunk) for _, _, pair, chunk in packed_schedule(BH, Lq)]
    want = [(p, c) for p in range(BH) for c in range(-(-Lq // WARP_ROWS))]
    assert sorted(got) == want
    blocks = {block for block, *_ in packed_schedule(BH, Lq)}
    assert len(blocks) == -(-BH // (4 // -(-Lq // WARP_ROWS)))
    if (BH, Lq) == (768, 16):
        assert len(blocks) == 192


# (Lq, S) -> the design tests/test_torch_cuda.py expects at the boundary
# and at the main paths' shapes
DESIGN_RULE = [
    ((64, 63), "packed"), ((64, 64), "packed"), ((64, 65), "tensor_core"),
    ((63, 64), "packed"), ((65, 64), "tensor_core"), ((1, 1), "packed"),
    ((16, 16), "packed"),            # policy stand-in's verify call
    ((48, 48), "packed"),            # reduced hymba's prefill
    ((4096, 4096), "tensor_core"),   # hymba_f32 prefill
    ((4112, 4112), "tensor_core"),   # hymba_f32 forward
    ((1, 4096), "tensor_core"),
]


@pytest.mark.parametrize("shape,design", DESIGN_RULE)
def test_shape_rule_picks_the_design_the_card_tests_expect(shape, design):
    assert PACKED_MAX_SEQ == 64
    assert f32_design(*shape) == design


def test_vec_loads_rule():
    """16-byte copies only where every row q, k and v start on a 16-byte
    boundary: hd a multiple of 4, aligned bases, stepped strides multiples
    of 4 floats; a view one float into its storage takes the 4-byte path."""
    q = torch.zeros(2, 16, 4, 32)
    assert vec_loads(q, q, q)
    qkv = torch.zeros(2, 16, 3, 4, 32)
    assert vec_loads(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    flat = torch.zeros(q.numel() + 1)
    shifted = flat[1:].view(q.shape)
    assert not vec_loads(shifted, q, q)
    odd = torch.zeros(2, 16, 4, 18)
    assert not vec_loads(odd, odd, odd)
    strided = torch.zeros(2, 16, 4, 34)[..., :32]  # rows 34 floats apart
    assert not vec_loads(q, strided, q)
    one_head = torch.zeros(2, 16, 1, 32)  # a stride never stepped does not count
    assert vec_loads(one_head, one_head, one_head.as_strided(one_head.shape, (512, 32, 3, 1)))
