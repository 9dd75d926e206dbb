"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; where there is none it skips.
Run on the card with:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
This file imports no JAX: the machine with the card has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config, paper_diffusion_policy_smoke
from repro_torch.core import asd as t_asd
from repro_torch.core import schedules as t_sch
from repro_torch.core.grs import grs as grs_plain
from repro_torch.kernels.flash_attention.ops import (attention_plain, f32_design, flash_f32,
                                                      flash_mha, flash_wgmma)
from repro_torch.kernels.grs.ops import grs, grs_cuda
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.ssm_scan.ops import (linear_scan, ssm_scan_backward_cuda,
                                              ssm_scan_backward_plain, ssm_scan_plain)
from repro_torch.kernels.superstep import ops as fused_ops
from repro_torch.models import diffusion as t_diff
from repro_torch.models import lm as t_lm
from repro_torch.models.diffusion import make_sl_model_fn
from repro_torch.serving.engine import ContinuousASDEngine, Request
from repro_torch.serving.packing import WaterfillingAllocator, packed_superstep
from repro_torch.training.optimizer import adamw, constant_schedule
from repro_torch.training.train_step import make_train_step
from repro_torch.weights import init_denoiser_params, init_lm_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grs_inputs(R, D, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(R, generator=g, device=dev)
    xi = torch.randn(R, D, generator=g, device=dev)
    mh = torch.randn(R, D, generator=g, device=dev)
    m = mh + 0.4 * torch.randn(R, D, generator=g, device=dev) / D ** 0.5
    sig = torch.rand(R, generator=g, device=dev) * 0.5 + 0.05
    if R > 2:
        sig[0] = 0.0
        m[1] = mh[1]
        sig[2] = 0.0
        m[2] = mh[2]
    return u, xi, mh, m, sig


def _near_threshold(u, xi, mh, m, sig):
    v = (mh - m).double()
    vv, vx = (v * v).sum(-1), (v * xi.double()).sum(-1)
    s = torch.where(sig > 0, sig, torch.ones_like(sig)).double()
    lr = -(vx / s + vv / (2 * s * s))
    margin = (torch.log(torch.clamp(u.double(), min=1e-20)) - torch.clamp(lr, max=0)).abs()
    return (margin < 1e-5) & (sig > 0)


def _offset_view(t, offset):
    """t's values in a view that starts ``offset`` floats into its storage
    (offset 1: every row pointer 4 bytes past a 16-byte boundary)."""
    base = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    base[offset:].copy_(t.reshape(-1))
    return base[offset:].view(t.shape)


# (R, D, storage offset of xi, m_hat, m): the main path's shape, edges of
# the row geometry, a view one float into its storage (the 4-byte path) and
# rows longer than a cluster holds (196,608 floats), which stream
@pytest.mark.parametrize("R,D,offset", [(1, 1, 0), (6, 5, 0), (9, 4097, 0), (32, 196608, 0),
                                        (32, 196608, 1), (4, 262144, 0), (3, 300001, 1)])
def test_grs_kernel_matches_plain(dev, R, D, offset):
    u, xi, mh, m, sig = _grs_inputs(R, D, R + D, dev)
    args = (u, *(_offset_view(t, offset) for t in (xi, mh, m)), sig)
    before = grs.launches
    zk, ak = grs(*args)
    torch.cuda.synchronize()
    assert grs.launches == before + 1
    zp, ap = grs_plain(*args)
    torch.testing.assert_close(zk, zp, atol=1e-5, rtol=0)
    near = _near_threshold(*args)
    assert torch.equal(ak[~near], ap[~near])
    if R > 2:
        assert not ak[0] and ak[1] and ak[2]


def test_grs_kernel_refuses_what_it_does_not_take(dev):
    u, xi, mh, m, sig = _grs_inputs(4, 8, 0, dev)
    with pytest.raises(ValueError):
        grs(u, xi.double(), mh, m, sig)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,S,H,hd,causal,window,softcap", [
    (2, 1024, 1024, 16, 64, False, 0, 0.0),
    (3, 16, 16, 4, 64, False, 0, 0.0),
    (2, 40, 40, 3, 16, False, 0, 0.0),
    (2, 40, 40, 3, 16, True, 0, 0.0),
    (1, 200, 200, 2, 32, True, 24, 0.0),
    (1, 130, 130, 2, 32, False, 24, 0.0),
    (2, 70, 70, 2, 64, True, 0, 30.0),
    (2, 100, 100, 4, 72, False, 0, 0.0),
    (1, 33, 77, 2, 128, False, 0, 0.0),
])
def test_flash_kernel_matches_plain(dev, dtype, B, L, S, H, hd, causal, window, softcap):
    g = torch.Generator(device=dev).manual_seed(L + S + hd)
    q, k, v = (torch.randn(B, n, H, hd, generator=g, device=dev).to(dtype)
               for n in (L, S, S))
    before = flash_mha.launches
    ok = flash_mha(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    op = attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    _assert_flash_close(ok, op)


# float32 (flash_f32: float32 FMAs in the packed design, 3xTF32 products on
# the tensor cores, which keep ~2^-21 of each product): both sum in float32
# in other orders.  bfloat16
# (the wgmma kernel): both compute in float32 and round the output to bf16
# once, so an element moves by at most one bf16 ulp (2^-7 of its size), plus
# 1e-4 for float32 sums in other orders near zero: chip_smoke.py's gate.
def _assert_flash_close(ok, op):
    if ok.dtype == torch.float32:
        torch.testing.assert_close(ok, op, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(ok.float(), op.float(), atol=1e-4, rtol=2.0 ** -7)


def _flash_inputs(dev, dtype, B, L, S, H, hd, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, n, H, hd, generator=g, device=dev).to(dtype) for n in (L, S, S)]


TILE_EDGES = (1, 127, 128, 129, 255)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S", TILE_EDGES)
@pytest.mark.parametrize("L", TILE_EDGES)
def test_flash_wgmma_tile_edges(dev, L, S, causal):
    """Query and key counts on both sides of the 128-row tiles."""
    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, L, S, 3, 64, 7 * L + S)
    _assert_flash_close(flash_mha(q, k, v, causal=causal),
                        attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_k", [1, 100, 128, 129])
def test_flash_kernel_masks_keys_past_true_seq_k(dev, dtype, seq_k):
    q, k, v = _flash_inputs(dev, dtype, 2, 129, 255, 2, 64, seq_k)
    _assert_flash_close(flash_mha(q, k, v, causal=False, true_seq_k=seq_k),
                        attention_plain(q, k, v, causal=False, true_seq_k=seq_k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 24, 32, 64, 72, 80, 128, 136, 192, 256])
def test_flash_kernel_head_dims(dev, dtype, hd):
    """dh below one 64-column chunk, across two, three and four (bf16, up
    to gemma2's 256; the float32 kernel stops at 128 and refuses above);
    TMA zero-fills the columns past dh."""
    q, k, v = _flash_inputs(dev, dtype, 2, 150, 150, 3, hd, hd)
    if dtype == torch.float32 and hd > 128:
        with pytest.raises(ValueError, match="hd"):
            flash_mha(q, k, v, causal=False)
        return
    for opts in ({"causal": False}, {"causal": True, "window": 40}):
        _assert_flash_close(flash_mha(q, k, v, **opts), attention_plain(q, k, v, **opts))


@pytest.mark.parametrize("causal,window,softcap", [(False, 0, 0.0), (True, 0, 0.0),
                                                   (True, 50, 50.0)])
@pytest.mark.parametrize("L", TILE_EDGES)
def test_flash_wgmma_tile_edges_at_hd_256(dev, L, causal, window, softcap):
    """Four chunks: 64-row query tiles whose two warpgroups split O's
    columns; query and key counts on both sides of the tiles."""
    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, L, L, 3, 256, 3 * L + window)
    opts = dict(causal=causal, window=window, softcap=softcap)
    _assert_flash_close(flash_mha(q, k, v, **opts), attention_plain(q, k, v, **opts))


@pytest.mark.parametrize("window", [4096, 0])
def test_flash_kernel_at_the_gemma2_shape(dev, window):
    """gemma2-9b's prefill: (1, 8192, 16, 256) bf16, causal, softcap 50, the
    local layers' window 4096 and the global layers' full attention."""
    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 8192, 8192, 16, 256, window + 1)
    opts = dict(causal=True, window=window, softcap=50.0)
    ok = flash_mha(q, k, v, **opts)
    torch.cuda.synchronize()
    _assert_flash_close(ok, attention_plain(q, k, v, **opts))


def test_flash_wgmma_instances_do_not_spill(dev):
    """Each instance (one to four 64-column chunks) compiles without local
    memory; four chunks take 64-row query tiles."""
    from repro_torch.kernels.flash_attention.ops import wgmma_launch_info

    infos = {hd: wgmma_launch_info(hd) for hd in (64, 128, 192, 256)}
    assert all(info["local_bytes"] == 0 for info in infos.values()), infos
    assert [info["query_rows"] for info in infos.values()] == [128, 128, 128, 64]


def test_flash_wgmma_reads_qkv_views_in_place(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    qkv = torch.randn(2, 130, 3, 4, 64, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # non-contiguous views
    assert not q.is_contiguous()
    before = flash_wgmma.launches
    ok = flash_mha(q, k, v, causal=True)
    assert flash_wgmma.launches == before + 1
    _assert_flash_close(ok, attention_plain(q, k, v, causal=True))


def test_flash_wgmma_refuses_what_tma_cannot_map(dev):
    q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 32, 32, 2, 64, 0)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)  # 2 bytes past a 16-byte boundary
    shifted.copy_(q)
    with pytest.raises(ValueError):
        flash_mha(shifted, k, v, causal=False)
    for hd in (12, 264):
        q, k, v = _flash_inputs(dev, torch.bfloat16, 1, 32, 32, 2, hd, hd)
        with pytest.raises(ValueError):
            flash_mha(q, k, v, causal=False)


def test_flash_counts_one_launch_per_kernel(dev):
    """bfloat16 launches the wgmma kernel and float32 the float32 kernel,
    each once, and both count in flash_mha.launches."""
    for dtype, kernel, other in ((torch.bfloat16, flash_wgmma, flash_f32),
                                 (torch.float32, flash_f32, flash_wgmma)):
        q, k, v = _flash_inputs(dev, dtype, 1, 64, 64, 2, 64, 3)
        counts = (flash_mha.launches, kernel.launches, other.launches)
        flash_mha(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert (flash_mha.launches, kernel.launches, other.launches) == (
            counts[0] + 1, counts[1] + 1, counts[2])


def test_flash_kernel_reads_strided_heads_in_place(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(2, 50, 3, 4, 32, generator=g, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # non-contiguous views
    torch.testing.assert_close(flash_mha(q, k, v, causal=False),
                               attention_plain(q, k, v, causal=False),
                               atol=2e-5, rtol=2e-5)


# ---- B2's float32 kernel: the tensor-core design (3xTF32 mma.sync) and the
# packed design ((batch, head) pairs packed into blocks, float32 FMAs)


def _f32_launch(q, k, v, design, **opts):
    """flash_mha on float32 inputs, checking that exactly one launch of
    ``design`` ran; returns the kernel's output."""
    before = dict(flash_f32.launches_by_design)
    n = flash_f32.launches
    ok = flash_mha(q, k, v, **opts)
    torch.cuda.synchronize()
    after = dict(before, **{design: before[design] + 1})
    assert (flash_f32.launches, flash_f32.launches_by_design) == (n + 1, after)
    return ok


# the main paths' shapes: hymba_f32's prefill and forward (batch 1 of 2),
# the policy and pixel stand-ins' verify calls
@pytest.mark.parametrize("B,L,H,hd,causal,window,design", [
    (1, 4096, 25, 64, True, 1024, "tensor_core"),
    (1, 4112, 25, 64, True, 0, "tensor_core"),
    (192, 16, 4, 32, False, 0, "packed"),
    (128, 64, 4, 24, False, 0, "packed"),
])
def test_flash_f32_at_the_main_path_shapes(dev, B, L, H, hd, causal, window, design):
    q, k, v = _flash_inputs(dev, torch.float32, B, L, L, H, hd, L + hd)
    ok = _f32_launch(q, k, v, design, causal=causal, window=window)
    _assert_flash_close(ok, attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,S", [(64, 63), (64, 64), (64, 65), (63, 64), (65, 64), (40, 63)])
def test_flash_f32_design_boundary(dev, L, S, causal):
    """Query and key counts on both sides of the packed design's limit of 64:
    each goes to the design tests/test_torch_flash_f32_design.py expects."""
    design = "packed" if L <= 64 and S <= 64 else "tensor_core"
    assert f32_design(L, S) == design
    q, k, v = _flash_inputs(dev, torch.float32, 3, L, S, 3, 32, 11 * L + S)
    opts = dict(causal=causal)
    _assert_flash_close(_f32_launch(q, k, v, design, **opts),
                        attention_plain(q, k, v, **opts))


@pytest.mark.parametrize("opts", [
    dict(causal=False), dict(causal=True), dict(causal=True, window=13),
    dict(causal=False, softcap=4.0), dict(causal=False, true_seq_k=29),
], ids=["full", "causal", "window", "softcap", "true_seq_k"])
@pytest.mark.parametrize("L,design", [(40, "packed"), (150, "tensor_core")])
@pytest.mark.parametrize("hd", [16, 24, 32, 72, 128])
def test_flash_f32_head_dims_and_options(dev, hd, L, design, opts):
    q, k, v = _flash_inputs(dev, torch.float32, 2, L, L, 3, hd, hd * L)
    _assert_flash_close(_f32_launch(q, k, v, design, **opts),
                        attention_plain(q, k, v, **opts))


@pytest.mark.parametrize("L,design", [(50, "packed"), (130, "tensor_core")])
def test_flash_f32_reads_strided_and_misaligned_views(dev, L, design):
    """Views of one qkv projection (16-byte copies), the same one float into
    its storage and a head dim of 18 (4-byte copies): each read in place."""
    g = torch.Generator(device=dev).manual_seed(L)
    qkv = torch.randn(2, L, 3, 4, 32, generator=g, device=dev)
    flat = torch.empty(qkv.numel() + 1, device=dev)
    shifted = flat[1:].view(qkv.shape)
    shifted.copy_(qkv)
    odd = torch.randn(2, L, 3, 4, 18, generator=g, device=dev)
    for src in (qkv, shifted, odd):
        q, k, v = src[:, :, 0], src[:, :, 1], src[:, :, 2]
        assert not q.is_contiguous()
        for opts in (dict(causal=False), dict(causal=True, window=17)):
            _assert_flash_close(_f32_launch(q, k, v, design, **opts),
                                attention_plain(q, k, v, **opts))


def test_flash_f32_refuses_what_it_does_not_take(dev):
    q, k, v = _flash_inputs(dev, torch.float32, 1, 32, 32, 2, 136, 0)
    before = flash_f32.launches
    with pytest.raises(ValueError):
        flash_mha(q, k, v, causal=False)
    with pytest.raises(ValueError):
        flash_f32(q.double(), k.double(), v.double(), causal=False, window=0, softcap=0.0,
                  true_seq_k=32)
    assert flash_f32.launches == before


def test_smoke_slice_on_card_matches_cpu(dev):
    dc = paper_diffusion_policy_smoke()
    params = init_denoiser_params(dc, 0, out_scale=1.0, device="cpu")
    sched = t_sch.sl_geometric(16, 0.05, 50.0)
    K, theta, B = 16, 4, 3
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(B, K + theta + 1, generator=gen)
    xi = torch.randn(B, K + theta + 1, dc.seq_len, dc.d_data, generator=gen)
    y0 = torch.zeros(B, dc.seq_len, dc.d_data)
    cpu = t_asd.asd_sample_batched(make_sl_model_fn(params, dc), sched, y0, theta,
                                   u_buf=u, xi_buf=xi, device="cpu")
    gpu_params = {k: v for k, v in init_denoiser_params(
        dc, 0, out_scale=1.0, device=dev).items()}
    g0, f0 = grs.launches, flash_mha.launches
    card = t_asd.asd_sample_batched(make_sl_model_fn(gpu_params, dc), sched, y0,
                                    theta, u_buf=u, xi_buf=xi, device=dev)
    rounds = int(card.rounds.max())
    assert grs.launches - g0 == rounds
    assert flash_mha.launches - f0 == 2 * rounds * dc.backbone.n_layers
    for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    # float32 products sum in other orders on the card than on the CPU, and
    # the chain feeds each step's output into the next model call, so the
    # last-bit differences grow over the 16 steps (measured 6e-4 at most on
    # an H100 for this seed): samples agree to 2e-3, counters exactly
    torch.testing.assert_close(card.sample.cpu(), cpu.sample, atol=2e-3, rtol=2e-3)
    assert bool((cpu.accepts < cpu.proposals).any())
    assert np.isfinite(card.sample.cpu().numpy()).all()


# ---- the packed round's kernels: B3 gather, B4 scatter, B5 fused gather,
# B6 fused verify-commit (CUDA, csrc/pack.cu and csrc/superstep.cu)

# (table rows N, packed rows M, event shape): the main path's (32 window
# rows, budget 16, 1024 x 192) and edges: D = 1, D not a multiple of 4
# (the scalar path), D = 4097, rank-3 events, one packed row
PACK_SHAPES = [(32, 16, (1024, 192)), (5, 3, ()), (7, 11, (5,)), (9, 4, (4097,)),
               (6, 1, (2, 3, 8)), (12, 13, (3, 7))]


def _pack_idx(N, M, dev, seed, drop=False):
    """Unique in-range rows for the first M - 2 positions, then padding
    (row 0 on gather, N and past on scatter)."""
    g = torch.Generator().manual_seed(seed)
    live = torch.randperm(N, generator=g)[: max(min(M - 2, N), 1)]
    pad = M - live.numel()
    gather = torch.cat([live, torch.zeros(pad, dtype=torch.long)])
    scatter = torch.cat([live, N + torch.arange(pad)])
    if drop:
        scatter = torch.full((M,), N, dtype=torch.long)
    return gather.to(dev), scatter.to(dev)


@pytest.mark.parametrize("N,M,event", PACK_SHAPES)
def test_pack_kernels_equal_plain(dev, N, M, event):
    g = torch.Generator(device=dev).manual_seed(N + M)
    src = torch.randn((N,) + event, generator=g, device=dev)
    vals = torch.randn((M,) + event, generator=g, device=dev)
    gidx, sidx = _pack_idx(N, M, dev, N * M)
    n0, s0 = pack_ops.gather_rows.launches, pack_ops.scatter_rows.launches
    out = pack_ops.gather_rows(src, gidx)
    tbl = pack_ops.scatter_rows(vals, sidx, N)
    torch.cuda.synchronize()
    assert (pack_ops.gather_rows.launches, pack_ops.scatter_rows.launches) == (n0 + 1, s0 + 1)
    assert torch.equal(out, pack_ops.gather_rows_plain(src, gidx))
    assert torch.equal(tbl, pack_ops.scatter_rows_plain(vals, sidx, N))
    # every row dropped: an all-zero table
    _, drop = _pack_idx(N, M, dev, 0, drop=True)
    assert not pack_ops.scatter_rows(vals, drop, N).any()


def test_pack_kernels_read_unaligned_views(dev):
    """A table that starts 4 bytes into its storage takes the scalar path."""
    base = torch.randn(8 * 64 + 1, device=dev)
    src = base[1:].view(8, 64)
    idx = torch.tensor([7, 0, 3], device=dev)
    assert torch.equal(pack_ops.gather_rows(src, idx), src[idx])


def test_pack_kernels_refuse_what_they_do_not_take(dev):
    src = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError):
        pack_ops.gather_rows_cuda(src.double(), torch.zeros(2, dtype=torch.long, device=dev))
    with pytest.raises(ValueError):
        pack_ops.scatter_rows_cuda(src, torch.zeros(4, dtype=torch.int32, device=dev), 4)


def _fvc_inputs(M, event, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    y, gg, xi = r(M, *event), r(M, *event), r(M, *event)
    A = 1.0 + 0.1 * torch.rand(M, generator=g, device=dev)
    B = 0.5 * torch.rand(M, generator=g, device=dev)
    shape = (M,) + (1,) * len(event)
    m = A.reshape(shape) * y + B.reshape(shape) * gg
    d = max(1, int(np.prod(event)))
    mh = m + 0.3 * r(M, *event) / d ** 0.5
    sig = 0.2 + 0.3 * torch.rand(M, generator=g, device=dev)
    u = torch.rand(M, generator=g, device=dev)
    if M > 2:
        sig[0] = 0.0
        sig[1], A[1], B[1] = 0.0, 1.0, 0.0
        mh[1] = y[1]
    return y, gg, xi, mh, A, B, u, sig


# the pack shapes, then the main path's shape with every (M, D) input a view
# one float into its storage (the 4-byte path) and rows longer than a
# cluster holds (196,608 floats), which stream
@pytest.mark.parametrize("N,M,event,offset",
                         [(*shape, 0) for shape in PACK_SHAPES]
                         + [(32, 16, (1024, 192), 1), (6, 4, (262144,), 0),
                            (6, 4, (300001,), 1)])
def test_fused_kernels_match_plain(dev, N, M, event, offset):
    g = torch.Generator(device=dev).manual_seed(M)
    tbls = [torch.randn((N,) + event, generator=g, device=dev) for _ in range(3)]
    sc = torch.randn(N, 5, generator=g, device=dev)
    gidx, sidx = _pack_idx(N, M, dev, N + M)
    k0, c0 = fused_ops.fused_gather.launches, fused_ops.fused_verify_commit.launches
    got = fused_ops.fused_gather(*tbls, sc, gidx)
    for a, b in zip(got, fused_ops.fused_gather_plain(*tbls, sc, gidx)):
        assert torch.equal(a, b)
    args = _fvc_inputs(M, event, dev, N * M)
    args = (*(_offset_view(t, offset) for t in args[:4]), *args[4:])
    zk, ak = fused_ops.fused_verify_commit(*args, sidx, N)
    torch.cuda.synchronize()
    assert (fused_ops.fused_gather.launches, fused_ops.fused_verify_commit.launches) == (
        k0 + 1, c0 + 1)
    zp, ap = fused_ops.fused_verify_commit_plain(*args, sidx, N)
    torch.testing.assert_close(zk, zp, atol=1e-5, rtol=1e-5)
    y, gg, xi, mh, A, B, u, sig = args
    shape = (M,) + (1,) * len(event)
    m = A.reshape(shape) * y + B.reshape(shape) * gg
    near_p = _near_threshold(u, xi.reshape(M, -1), mh.reshape(M, -1), m.reshape(M, -1), sig)
    near = torch.zeros(N, dtype=torch.bool, device=dev)
    live = sidx < N
    near[sidx[live]] = near_p[live]
    assert torch.equal(ak[~near], ap[~near])
    if M - 2 >= 2:  # packed rows 0 and 1 (the sigma 0 rows) are live
        assert not ak[sidx[0]] and ak[sidx[1]]


def test_fused_verify_commit_gives_the_packed_rounds_bits(dev):
    """B6 runs B1's row code on m rounded as torch rounds A y + B g: the
    fused commit equals the torch mean, the GRS kernel and the scatter
    kernel, bit for bit."""
    args = _fvc_inputs(16, (1024, 192), dev, 3)
    y, gg, xi, mh, A, B, u, sig = args
    _, sidx = _pack_idx(32, 16, dev, 4)
    zf, af = fused_ops.fused_verify_commit(*args, sidx, 32)
    m = A[:, None, None] * y + B[:, None, None] * gg
    z, a = grs(u, xi, mh, m, sig, event_ndim=2)
    assert torch.equal(zf, pack_ops.scatter_rows(z, sidx, 32))
    assert torch.equal(af, pack_ops.scatter_rows_plain(a, sidx, 32))


def test_grs_and_fused_commit_run_one_kernel_each(dev):
    """One B1 call and one B6 call at the main path's shapes each run one
    device kernel (a cluster launch: no scratch table, no second pass)."""
    from torch.profiler import ProfilerActivity, profile

    u, xi, mh, m, sig = _grs_inputs(32, 196608, 5, dev)
    y, gg, fxi, fmh, A, B, fu, fsig = (t.reshape(16, -1) if t.ndim > 1 else t
                                       for t in _fvc_inputs(16, (1024, 192), dev, 6))
    _, sidx = _pack_idx(32, 16, dev, 7)
    for call in (lambda: grs_cuda(u, sig, xi, mh, m),
                 lambda: fused_ops.fused_verify_commit_cuda(y, gg, fxi, fmh, A, B, fu, fsig,
                                                            sidx, 32)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        assert sum(e.count for e in kernels) == 1, [(e.key, e.count) for e in kernels]


@pytest.mark.parametrize("round_impl", ["packed", "fused"])
def test_packed_superstep_on_card_matches_cpu(dev, round_impl):
    """The smoke denoiser's packed superstep on the card and on the CPU from
    the same states: counters equal, states close; the kernels were
    launched once a round as the round says."""
    dc = paper_diffusion_policy_smoke()
    K, theta, S, R, budget = 12, 4, 4, 5, 6
    sched = t_sch.sl_geometric(K, 0.05, 10.0)
    gen = torch.Generator().manual_seed(0)
    y0 = torch.randn(S, dc.seq_len, dc.d_data, generator=gen)
    u = torch.rand(S, K + theta + 1, generator=gen)
    xi = torch.randn(S, K + theta + 1, dc.seq_len, dc.d_data, generator=gen)
    out = {}
    for where in ("cpu", dev):
        st = t_asd.init_chain_state(sched.to(where), y0.to(where), theta, False,
                                    u_buf=u.to(where), xi_buf=xi.to(where))
        fn = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=where), dc)
        before = (pack_ops.gather_rows.launches, pack_ops.scatter_rows.launches,
                  fused_ops.fused_gather.launches, fused_ops.fused_verify_commit.launches,
                  grs.launches)
        with torch.no_grad():
            out[str(where)] = packed_superstep(
                fn, sched.to(where), st, None, torch.ones(S, device=where), rounds=R,
                theta=theta, budget=budget, allocator=WaterfillingAllocator(theta_max=theta),
                round_impl=round_impl)
        after = (pack_ops.gather_rows.launches, pack_ops.scatter_rows.launches,
                 fused_ops.fused_gather.launches, fused_ops.fused_verify_commit.launches,
                 grs.launches)
    per_round = (3, 1, 0, 0, 1) if round_impl == "packed" else (0, 0, 1, 1, 0)
    assert tuple(b - a for a, b in zip(before, after)) == tuple(R * n for n in per_round)
    cpu, card = out["cpu"], out[str(dev)]
    for name in ("a", "rounds", "head_calls", "model_evals", "accepts", "proposals",
                 "theta_live", "v_valid"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    torch.testing.assert_close(card.y.cpu(), cpu.y, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("round_impl", ["packed", "fused", "unpacked"])
def test_branched_superstep_on_card_matches_cpu(dev, round_impl):
    """Branched rounds (B 3, gain controller, counter noise) of the smoke
    denoiser on the card and on the CPU from the same keys: counters,
    branch counts and drafted points equal, states close; B1-B6 launched
    once a round as the round says, over (S x B x theta)-row tables."""
    from repro_torch.core import prng
    from repro_torch.core.controller import GainBranches

    dc = paper_diffusion_policy_smoke()
    K, theta, S, R, budget, nb = 12, 4, 4, 5, 20, 3
    sched = t_sch.sl_geometric(K, 0.05, 10.0)
    y0 = torch.randn(S, dc.seq_len, dc.d_data, generator=torch.Generator().manual_seed(1))
    keys = prng.split(prng.PRNGKey(4), S)
    out = {}
    counters = (pack_ops.gather_rows, pack_ops.scatter_rows, fused_ops.fused_gather,
                fused_ops.fused_verify_commit, grs)
    for where in ("cpu", dev):
        st = t_asd.init_chain_state(sched.to(where), y0.to(where), theta, False,
                                    key=keys.to(where), noise_mode="counter",
                                    num_branches=nb, branch_controller=GainBranches())
        fn = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=where), dc)
        before = tuple(c.launches for c in counters)
        with torch.no_grad():
            if round_impl == "unpacked":
                out[str(where)] = t_asd.asd_superstep(
                    fn, sched.to(where), st, theta, R, eager_head=True, keep_trajectory=False,
                    noise_mode="counter", num_branches=nb, branch_controller=GainBranches())
            else:
                out[str(where)] = packed_superstep(
                    fn, sched.to(where), st, None, torch.ones(S, device=where), rounds=R,
                    theta=theta, budget=budget,
                    allocator=WaterfillingAllocator(theta_max=theta * nb),
                    round_impl=round_impl, noise_mode="counter", num_branches=nb,
                    branch_controller=GainBranches())
        after = tuple(c.launches for c in counters)
    per_round = {"packed": (3, 1, 0, 0, 1), "fused": (0, 0, 1, 1, 0),
                 "unpacked": (0, 0, 0, 0, 1)}[round_impl]
    assert tuple(b - a for a, b in zip(before, after)) == tuple(R * n for n in per_round)
    cpu, card = out["cpu"], out[str(dev)]
    for name in ("a", "rounds", "head_calls", "model_evals", "accepts", "proposals",
                 "theta_live", "v_valid", "b_live", "draft_points"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    assert torch.equal(card.bctrl.cpu(), cpu.bctrl)
    assert bool((cpu.draft_points > cpu.proposals).any())
    torch.testing.assert_close(card.y.cpu(), cpu.y, atol=2e-3, rtol=2e-3)


def test_branched_superstep_makes_no_host_sync(dev):
    """A branched superstep (both noise modes' branch draws, the selection,
    the branch controller) reads nothing back on the host."""
    from repro_torch.core import prng
    from repro_torch.core.controller import GainBranches

    dc = paper_diffusion_policy_smoke()
    K, theta, S, nb = 16, 4, 3, 2
    sched = t_sch.sl_geometric(K, 0.05, 50.0).to(dev)
    fn = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=dev), dc)
    st = t_asd.init_chain_state(sched, torch.zeros((S, dc.seq_len, dc.d_data), device=dev),
                                theta, False, key=prng.split(prng.PRNGKey(1), S).to(dev),
                                noise_mode="counter", num_branches=nb,
                                branch_controller=GainBranches())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            t_asd.asd_superstep(fn, sched, st, theta, 2, eager_head=True,
                                keep_trajectory=False, noise_mode="counter",
                                num_branches=nb, branch_controller=GainBranches())
            for impl in ("packed", "fused"):
                packed_superstep(fn, sched, st, None, torch.ones(S, device=dev), rounds=2,
                                 theta=theta, budget=5,
                                 allocator=WaterfillingAllocator(theta_max=theta * nb),
                                 round_impl=impl, noise_mode="counter", num_branches=nb,
                                 branch_controller=GainBranches())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_packed_and_fused_serving_agree_bit_for_bit_on_card(dev):
    """The same requests through the packed and the fused engine on the
    card: the same counters and the same sample bits."""
    dc = paper_diffusion_policy_smoke()
    K, theta = 16, 4
    sched = t_sch.sl_geometric(K, 0.05, 50.0)
    fn = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=dev), dc)
    results = {}
    for impl in ("packed", "fused"):
        eng = ContinuousASDEngine(fn, sched, (dc.seq_len, dc.d_data), num_slots=3,
                                  theta=theta, execution="packed", round_budget=5,
                                  round_impl=impl, rounds_per_sync=2, seed=3, device=dev)
        samples = eng.serve([Request(i) for i in range(5)])
        results[impl] = (samples, {m.rid: (m.rounds, m.accepts, m.proposals)
                                   for m in eng.stats.per_request})
    (sp, cp), (sf, cf) = results["packed"], results["fused"]
    assert cp == cf
    for rid in sp:
        assert np.array_equal(sp[rid], sf[rid]), rid
    assert sum(a for _, a, _ in cp.values()) < sum(p for _, _, p in cp.values())


# ---- the hymba LM path: B7 linear scan (csrc/ssm_scan.cu) and B2 in its
# causal sliding-window form


@pytest.mark.parametrize("B,L,D", [(1, 1, 1), (2, 1, 25600), (1, 100, 70), (3, 17, 130),
                                   (2, 37, 25601), (2, 4096, 25600)])
def test_ssm_scan_kernel_matches_plain(dev, B, L, D):
    g = torch.Generator(device=dev).manual_seed(B * L + D)
    a = 0.5 + 0.499 * torch.rand(B, L, D, generator=g, device=dev)
    b = torch.randn(B, L, D, generator=g, device=dev)
    before = linear_scan.launches
    hk = linear_scan(a, b)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    # both round a * h, then add b, in float32: the kernel does not contract
    # the two into an FMA, so the bits are the plain loop's
    assert torch.equal(hk, ssm_scan_plain(a, b))


def test_ssm_scan_kernel_refuses_what_it_does_not_take(dev):
    a = torch.rand(2, 8, 16, device=dev)
    strided = a.transpose(1, 2).contiguous().transpose(1, 2)
    before = linear_scan.launches
    for x, y in ((a.to(torch.bfloat16), a.to(torch.bfloat16)), (a.double(), a.double()),
                 (strided, a), (a, a.cpu())):
        with pytest.raises(ValueError):
            linear_scan(x, y)
    assert linear_scan.launches == before


@pytest.mark.parametrize("L,window", [(4096, 1024), (4112, 1024), (4112, 0), (1100, 1024)])
def test_flash_kernel_at_the_hymba_shapes(dev, L, window):
    """25 heads, causal, window 1024 or full, the ragged last tile of the
    L + 16 forward; KV tiles outside the band are skipped."""
    g = torch.Generator(device=dev).manual_seed(L + window)
    q, k, v = (torch.randn(2, L, 25, 64, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    ok = flash_mha(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    op = attention_plain(q, k, v, causal=True, window=window)
    # both compute in float32 and round the output to bf16 once: one bf16 ulp
    # (2^-7 of the value) where they round apart, 1e-4 for float32 sums in
    # other orders near zero.  Outputs here are ~0.02-0.04 (averages over
    # 1024-4096 keys), where one key too many or too few moves them by ~1e-3.
    torch.testing.assert_close(ok.float(), op.float(), atol=1e-4, rtol=2.0 ** -7)


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(dev))


def test_small_hymba_on_card_matches_cpu(dev):
    """reduced(hymba-1.5b) in float32 with the same params: forward,
    prefill and greedy decode on the card (B7, B2) against the CPU (plain
    versions) within 2e-4 (float32 sums in other orders)."""
    cfg = reduced(get_config("hymba-1.5b"))
    params = init_lm_params(cfg, 0, device="cpu")
    card = _to(params, dev)
    B, P, T = 2, 48, 6
    tokens = torch.randint(0, cfg.vocab_size, (B, P + T),
                           generator=torch.Generator().manual_seed(1))
    s0, f0 = linear_scan.launches, flash_mha.launches
    out = {}
    for where, p in (("cpu", params), ("card", card)):
        dv = "cpu" if where == "cpu" else dev
        full = t_lm.lm_fwd(p, tokens.to(dv), cfg)
        caches = t_lm.lm_cache_init(p, cfg, B, P + T, dtype=torch.float32)
        lg, caches = t_lm.lm_prefill(p, tokens[:, :P].to(dv), caches, cfg)
        steps = [lg[:, 0]]
        for i in range(P, P + T):
            lg, caches = t_lm.lm_decode_step(p, tokens[:, i].to(dv), caches, i, cfg)
            steps.append(lg[:, 0])
        out[where] = (full.cpu(), torch.stack(steps, 1).cpu())
    assert linear_scan.launches - s0 == 2 * cfg.n_layers
    assert flash_mha.launches - f0 == 2 * cfg.n_layers
    torch.testing.assert_close(out["card"][0], out["cpu"][0], atol=2e-4, rtol=0)
    torch.testing.assert_close(out["card"][1], out["cpu"][1], atol=2e-4, rtol=0)
    torch.testing.assert_close(out["card"][1], out["card"][0][:, P - 1:], atol=2e-4, rtol=0)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "yi-6b", "gemma2-9b", "qwen2.5-14b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_small_lm_archs_on_card_match_cpu(dev, name):
    """reduced(arch) in float32 with the same params: forward, prefill and
    greedy decode on the card (B2's float32 kernel) against the CPU (plain
    versions) within 2e-4; B2 once per attention and xattn layer in the
    forward and the prefill."""
    cfg = reduced(get_config(name))
    params = init_lm_params(cfg, 0, device="cpu")
    card = _to(params, dev)
    B, P, T = 2, 40, 6
    g = torch.Generator().manual_seed(2)
    inputs = (torch.randint(0, cfg.vocab_size, (B, P + T), generator=g) if cfg.embed_inputs
              else torch.randn(B, P + T, cfg.d_model, generator=g))
    vision = (torch.randn(B, cfg.n_vision_tokens, cfg.d_model, generator=g)
              if cfg.n_vision_tokens else None)
    f0 = flash_mha.launches
    out = {}
    for where, p in (("cpu", params), ("card", card)):
        dv = "cpu" if where == "cpu" else dev
        vis = None if vision is None else vision.to(dv)
        full = t_lm.lm_fwd(p, inputs.to(dv), cfg, vision=vis)
        caches = t_lm.lm_cache_init(p, cfg, B, P + T, dtype=torch.float32)
        lg, caches = t_lm.lm_prefill(p, inputs[:, :P].to(dv), caches, cfg, vision=vis)
        steps = [lg[:, 0]]
        for i in range(P, P + T):
            tok = inputs[:, i] if cfg.embed_inputs else inputs[:, i:i + 1]
            lg, caches = t_lm.lm_decode_step(p, tok.to(dv), caches, i, cfg)
            steps.append(lg[:, 0])
        out[where] = (full.cpu(), torch.stack(steps, 1).cpu())
    assert flash_mha.launches - f0 == 2 * cfg.n_layers
    torch.testing.assert_close(out["card"][0], out["cpu"][0], atol=2e-4, rtol=0)
    torch.testing.assert_close(out["card"][1], out["cpu"][1], atol=2e-4, rtol=0)


def test_flash_mha_refuses_autograd_on_the_card(dev):
    """The kernels have no backward: a loss through them would give q, k
    and v a silent zero gradient, so flash_mha raises instead; under
    no_grad, or with inputs that need no grad, it launches as before."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _flash_inputs(dev, dtype, 1, 16, 16, 2, 32, 1)
        for leaf in (q, k, v):
            x = leaf.clone().requires_grad_()
            args = [x if t is leaf else t for t in (q, k, v)]
            before = flash_mha.launches
            with pytest.raises(RuntimeError, match="no backward"):
                flash_mha(*args, causal=False)
            assert flash_mha.launches == before
            with torch.no_grad():
                flash_mha(*args, causal=False)
            assert flash_mha.launches == before + 1
    dc = paper_diffusion_policy_smoke()
    params = _requires_grad(init_denoiser_params(dc, 0, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        t_diff.denoiser_fwd(params, torch.ones(2, device=dev), torch.zeros(2, 8, 4, device=dev),
                            dc, attn_impl="flash")


def _requires_grad(tree):
    return {k: _requires_grad(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.requires_grad_()


def test_train_step_on_card_matches_cpu(dev):
    """Two AdamW steps of the small denoiser (naive attention, float32) on
    the card and on the CPU from the same params and injected draws: losses,
    gradient norms and params within 1e-4."""
    dc = paper_diffusion_policy_smoke()
    opt = adamw(constant_schedule(1e-3))

    def loss_fn(p, batch, gen):
        return t_diff.sl_denoiser_loss(p, dc, batch["x0"], gen, 0.05, 50.0, t=batch["t"],
                                       xi=batch["xi"]), {}

    step = make_train_step(loss_fn, opt)
    g = torch.Generator().manual_seed(3)
    batches = [{"x0": torch.randn(4, 8, 4, generator=g),
                "t": torch.exp(torch.rand(4, generator=g) * 6 - 3),
                "xi": torch.randn(4, 8, 4, generator=g)} for _ in range(2)]
    out = {}
    for where in ("cpu", dev):
        params = init_denoiser_params(dc, 0, out_scale=1.0, device=where)
        st = opt.init(params)
        metrics = []
        for b in batches:
            params, st, m = step(params, st, {k: v.to(where) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[str(where)] = (params, metrics)
    (p_cpu, m_cpu), (p_card, m_card) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(m_card, m_cpu, rtol=1e-4)
    for (a, b) in zip(_leaves_of(p_card), _leaves_of(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


def _leaves_of(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_of(tree[k])
    else:
        yield tree


def test_checkpoint_manifest_codec_round_trips_on_this_machine(dev, tmp_path):
    """The card's machine has no msgpack package: the manifest goes through
    the port's own codec, and a checkpoint of card tensors restores onto the
    card bit for bit."""
    manifest = {"step": 70000, "keys": ["['a']"] * 20, "shapes": [[2, 3]] * 20,
                "dtypes": ["float32"] * 20, "extra": {"data_step": -3, "preempted": True,
                                                      "lr": 1e-4, "note": None}}
    assert _msgpack.unpackb(_msgpack.packb(manifest)) == manifest
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"params": {"w": torch.randn(3, 5, generator=g, device=dev)},
            "opt": {"step": torch.tensor(4, dtype=torch.int32, device=dev)}}
    t_ckpt.save(str(tmp_path), 4, tree, extra={"data_step": 4})
    got, man = t_ckpt.restore(str(tmp_path), target=tree)
    assert man["extra"] == {"data_step": 4} and got["params"]["w"].device.type == "cuda"
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32


# ---- counter noise (core/prng.py) and the serve CLI


@pytest.mark.parametrize("shape", [(), (1,), (5,), (4097,), (1024, 192)], ids=str)
def test_prng_on_card_equals_cpu(dev, shape):
    """Keys, bits and uniforms equal bit for bit; normals within the ulp
    bound (the card's log1p is not the CPU's), for a batch of 3 keys."""
    from repro_torch.core import prng

    keys = prng.split(prng.PRNGKey(17), 3)
    for fn in (lambda k: prng.split(k, 4), lambda k: prng.fold_in(k, 2**31 + 5),
               lambda k: prng.random_bits(k, shape)):
        assert torch.equal(fn(keys.to(dev)).cpu(), fn(keys))
    u_card, u_cpu = prng.uniform(keys.to(dev), shape).cpu(), prng.uniform(keys, shape)
    assert torch.equal(u_card.view(torch.int32), u_cpu.view(torch.int32))
    n_card, n_cpu = prng.normal(keys.to(dev), shape).cpu(), prng.normal(keys, shape)
    ulps = (n_card.view(torch.int32).long() - n_cpu.view(torch.int32).long()).abs()
    assert ulps.max().item() <= prng.NORMAL_ULPS


def test_counter_noise_superstep_makes_no_host_sync(dev):
    """A counter-noise superstep draws its windows on the card and reads
    nothing back on the host, packed and unpacked."""
    from repro_torch.core import prng

    dc = paper_diffusion_policy_smoke()
    K, theta, S = 16, 4, 3
    sched = t_sch.sl_geometric(K, 0.05, 50.0).to(dev)
    fn = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=dev), dc)
    st = t_asd.init_chain_state(sched, torch.zeros((S, dc.seq_len, dc.d_data), device=dev),
                                theta, False, key=prng.split(prng.PRNGKey(1), S).to(dev),
                                noise_mode="counter")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            t_asd.asd_superstep(fn, sched, st, theta, 2, eager_head=True,
                                keep_trajectory=False, noise_mode="counter")
            packed_superstep(fn, sched, st, None, torch.ones(S, device=dev), rounds=2,
                             theta=theta, budget=5,
                             allocator=WaterfillingAllocator(theta_max=theta),
                             round_impl="fused", noise_mode="counter")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_serve_cli_on_card(dev):
    """``python -m repro_torch.launch.serve`` in process on the card (smoke
    model, packed fused rounds): finite samples, B1's work inside B6 and
    B2 launched."""
    from repro_torch.launch import serve

    before = (fused_ops.fused_verify_commit.launches, flash_f32.launches)
    summary = serve.main(["--model", "paper-diffusion-policy-smoke", "--K", "20",
                          "--execution", "packed", "--round-budget", "24",
                          "--round-impl", "fused", "--theta-controller", "aimd"])
    assert summary["finite"] and summary["retired"] == 8
    after = (fused_ops.fused_verify_commit.launches, flash_f32.launches)
    assert after[0] - before[0] == summary["rounds_total"]
    assert after[1] > before[1]


# ---- the worker's superstep programs as captured CUDA graphs


class _Eager:
    """A program's body, run eagerly at every call: the engine the graphs
    are held against."""

    def __init__(self, prog):
        self.prog, self.calls = prog, 0
        self.stage = getattr(prog, "stage", None)

    def __call__(self):
        self.calls += 1
        self.prog.body()
        return self.calls == 1


class EagerEngine(ContinuousASDEngine):
    def _make_superstep(self, R, budget):
        return _Eager(super()._make_superstep(R, budget))

    def _get_admit(self, width):
        prog = self._admit_fns.get(width)
        if prog is None:
            prog = self._admit_fns[width] = _Eager(super()._get_admit(width))
        return prog


def _launch_counts():
    from repro_torch import programs

    return [holder[key] for holder, key in programs._counters()]


def _slot_fields(eng):
    st = eng._states
    return {f: getattr(st, f) for f in st.__dataclass_fields__ if getattr(st, f) is not None}


def _program_engine(dev, cls=ContinuousASDEngine, *, round_impl, noise, branches, controller,
                    R=2, budget=6):
    from repro_torch.core.controller import make_branch_controller, make_controller

    dc = paper_diffusion_policy_smoke()
    fn = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=dev), dc)
    kw = (dict(execution="unpacked") if round_impl == "unpacked" else
          dict(execution="packed", round_impl=round_impl, round_budget=budget))
    return cls(fn, t_sch.sl_geometric(16, 0.05, 50.0), (dc.seq_len, dc.d_data), num_slots=4,
               theta=4, noise_mode=noise, keep_trajectory=False, rounds_per_sync=R,
               controller=make_controller(controller), num_branches=branches,
               branch_controller=make_branch_controller("gain" if branches > 1 else "static"),
               seed=5, device=dev, **kw)


@pytest.mark.parametrize("controller", ["static", "aimd", "accept-rate"])
@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("noise", ["buffer", "counter"])
@pytest.mark.parametrize("round_impl", ["unpacked", "packed", "fused"])
def test_graph_replay_equals_the_eager_body(dev, round_impl, noise, branches, controller):
    """From the same slot states, one replay of a superstep's graph and one
    run of its eager body: the same bits in every field and the same
    launches of every kernel.  The replay makes no host sync."""
    eng = _program_engine(dev, round_impl=round_impl, noise=noise, branches=branches,
                          controller=controller)
    for i in range(5):
        eng.submit(Request(i, key=np.array([0, 40 + i], np.uint32)))
    eng.step()  # the cold dispatch: eager body, then the capture
    ((R, budget), prog), = eng._superstep_fns.items()
    assert prog.graph is not None and prog.calls == 1
    B = eng.round_budget if budget is not None else None
    saved = {k: v.clone() for k, v in _slot_fields(eng).items()}
    torch.cuda.synchronize()
    before = _launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert eng._launch_superstep(R, B) is False  # a warm replay
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    replayed = {k: v.clone() for k, v in _slot_fields(eng).items()}
    graph_launches = [b - a for a, b in zip(before, _launch_counts())]
    for k, v in _slot_fields(eng).items():
        v.copy_(saved[k])
    before = _launch_counts()
    prog.body()
    torch.cuda.synchronize()
    eager_launches = [b - a for a, b in zip(before, _launch_counts())]
    for k, v in _slot_fields(eng).items():
        assert torch.equal(replayed[k], v), k
    assert graph_launches == eager_launches == prog.launches and sum(graph_launches) > 0
    assert not torch.equal(replayed["a"], saved["a"])  # the superstep moved the chains


def test_pipelined_serve_with_graphs_equals_the_eager_engine(dev):
    """Six requests on four slots, one round a superstep, so chains retire
    in consecutive supersteps while the next one is already dispatched:
    the graphs give the eager engine's samples and counters, bit for bit."""
    out, counts = {}, {}
    for name, cls in (("graph", ContinuousASDEngine), ("eager", EagerEngine)):
        eng = _program_engine(dev, cls, round_impl="fused", noise="counter", branches=1,
                              controller="aimd", R=1)
        out[name] = eng.serve([Request(i, key=np.array([0, 7 + i], np.uint32))
                               for i in range(6)])
        counts[name] = {m.rid: (m.rounds, m.accepts, m.proposals)
                        for m in eng.stats.per_request}
    assert counts["graph"] == counts["eager"]
    assert sorted(out["graph"]) == list(range(6))
    for rid in range(6):
        assert np.array_equal(out["graph"][rid], out["eager"][rid]), rid
    assert len({rounds for rounds, _, _ in counts["graph"].values()}) > 1


def test_a_failed_capture_raises(dev):
    """A body that cannot be captured (a host read) raises at its cold
    dispatch, and again at the next call: there is no eager fallback.  In a
    process of its own, since a failed capture may leave the context
    unusable."""
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from repro_torch.programs import SuperstepProgram\n"
        "x = torch.ones(4, device='cuda')\n"
        "prog = SuperstepProgram(lambda: x.add_(x.sum().item()), 'cuda')\n"
        "for _ in range(2):\n"
        "    try:\n"
        "        prog()\n"
        "    except RuntimeError as e:\n"
        "        print('raised', type(e).__name__)\n"
        "print('graph', prog.graph)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.stdout.count("raised") == 2, res.stdout + res.stderr
    assert "graph None" in res.stdout


def test_no_garbage_is_collected_during_a_capture(dev):
    """The cycle collector is held off while a graph is captured (a graph
    it destroyed there would void the capture) and runs again after."""
    import gc

    from repro_torch.programs import SuperstepProgram

    x = torch.zeros(4, device=dev)
    seen = []
    prog = SuperstepProgram(lambda: (seen.append(gc.isenabled()), x.add_(1.0)), dev)
    assert prog() is True and prog() is False
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(x.cpu(), torch.full((4,), 2.0))


def test_one_pool_per_worker(dev):
    """Every graph of a worker, and of a worker that adopted it, captures
    into one memory pool; each key is captured once."""
    eng = _program_engine(dev, round_impl="packed", noise="counter", branches=1,
                          controller="accept-rate", R=1, budget="auto")
    for tier in eng._budget_ladder:
        eng._launch_superstep(1, tier)
        eng._launch_superstep(1, tier)
    progs = list(eng._superstep_fns.values())
    assert len(progs) == len(eng._budget_ladder) > 1
    assert all(p.pool is eng._graph_pool and p.graph is not None and p.calls == 2
               for p in progs)
    sibling = _program_engine(dev, round_impl="packed", noise="counter", branches=1,
                              controller="accept-rate", R=1, budget="auto").adopt_programs(eng)
    sibling._launch_superstep(1, eng._budget_ladder[0])
    (prog,) = sibling._superstep_fns.values()
    assert prog.pool is eng._graph_pool and prog.graph is not None



# ------------------------------------------------ sampler and admission graphs


def _smoke_fn(dev):
    dc = paper_diffusion_policy_smoke()
    return dc, make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=dev), dc)


def _eager_sampler(model_fn, sched, y0, theta, keys, **kw):
    """The loop that checks every round on the host: (state, rounds)."""
    st = t_asd.init_chain_state(sched, y0, theta, kw["keep_trajectory"], key=keys,
                                noise_mode=kw["noise_mode"], num_branches=kw["num_branches"])
    rounds = 0
    while not bool(t_asd.chain_done(st, sched.K).all()):
        st = t_asd.asd_round(model_fn, sched, st, theta, kw["eager_head"], kw["keep_trajectory"],
                             noise_mode=kw["noise_mode"], num_branches=kw["num_branches"])
        rounds += 1
    return st, rounds


@pytest.mark.parametrize("branches", [1, 2])
@pytest.mark.parametrize("noise", ["buffer", "counter"])
def test_sampler_graph_equals_the_eager_loop(dev, noise, branches):
    """``asd_sample_batched`` replays one captured round: the eager loop's
    sample bits, counters, rounds and launches, with host reads at most the
    rounds and a capture time; a warm replay makes no host sync."""
    from repro_torch import programs

    dc, fn = _smoke_fn(dev)
    sched = t_sch.sl_geometric(16, 0.05, 50.0).to(dev)
    y0 = torch.zeros((3, dc.seq_len, dc.d_data), device=dev)
    kw = dict(eager_head=True, keep_trajectory=True, noise_mode=noise, num_branches=branches)
    keys = t_asd.prng.split(t_asd.prng.PRNGKey(8), 3).to(dev)
    with torch.no_grad():
        before = _launch_counts()
        st, rounds = _eager_sampler(fn, sched, y0, 4, keys, **kw)
        torch.cuda.synchronize()
        eager = [b - a for a, b in zip(before, _launch_counts())]
        before = _launch_counts()
        res = t_asd.asd_sample_batched(fn, sched, y0, 4, device=dev, key=t_asd.prng.PRNGKey(8),
                                       **kw)
        torch.cuda.synchronize()
        graph = [b - a for a, b in zip(before, _launch_counts())]
    assert res.loop.rounds == rounds and res.loop.host_reads <= rounds
    assert res.loop.capture_ms is not None and graph == eager and sum(graph) > 0
    for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals",
                 "draft_points"):
        assert torch.equal(getattr(res, name), getattr(st, name)), name
    assert torch.equal(res.trajectory, st.y[:, :17])
    # a warm replay of a fresh loop's round makes no host sync
    loop = t_asd.SamplerLoop(fn, sched, t_asd.init_chain_state(
        sched, y0, 4, key=keys, noise_mode=noise, num_branches=branches), 4, True,
        noise_mode=noise, num_branches=branches)
    loop.program()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop.program()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert loop.program.graph is not None and len(programs._counters()) > 0


def test_sequential_graph_equals_the_eager_steps(dev):
    """The K-step program (one captured step, K replays, the step index on
    the device) gives the eager loop's bits, trajectory included."""
    from repro_torch.core import sequential as t_seq

    dc, fn = _smoke_fn(dev)
    sched = t_sch.sl_geometric(12, 0.05, 50.0).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    y0 = torch.randn((2, dc.seq_len, dc.d_data), generator=g, device=dev)
    xi = torch.randn((12,) + tuple(y0.shape), generator=g, device=dev)
    with torch.no_grad():
        y, traj = y0, [y0]
        for i in range(12):
            y = sched.A[i] * y + sched.B[i] * fn(sched.t_model[i].expand(2), y) \
                + sched.sigma[i] * xi[i]
            traj.append(y)
        prog = t_seq.SequentialProgram(fn, sched, y0, xi, keep_trajectory=True)
        out = prog.run()
        torch.cuda.synchronize()
    assert prog.program.graph is not None and prog.program.calls == 12
    assert torch.equal(out, y) and torch.equal(prog.trajectory, torch.stack(traj))


@pytest.mark.parametrize("mode", ["asd", "ddpm"])
def test_static_engine_captures_once(dev, mode):
    """``ASDServingEngine`` keeps one program across chunks: the second
    serve captures nothing and gives the first's bits."""
    from repro_torch.serving.engine import ASDServingEngine

    dc, fn = _smoke_fn(dev)
    eng = ASDServingEngine(fn, t_sch.sl_geometric(12, 0.05, 50.0), (dc.seq_len, dc.d_data),
                           theta=4, batch_size=3, mode=mode, device=dev)
    reqs = [Request(i) for i in range(5)]
    first = eng.serve(reqs, t_asd.prng.PRNGKey(4))
    prog = eng._program
    second = eng.serve(reqs, t_asd.prng.PRNGKey(4))
    assert eng._program is prog and prog.program.captures == 1
    for rid in range(5):
        assert np.array_equal(first[rid], second[rid])


@pytest.mark.parametrize("noise", ["buffer", "counter"])
def test_admission_and_packet_graphs_equal_the_eager_versions(dev, noise):
    """Admissions at widths 1, 2 and 4 (3 padded) as captured programs,
    against one ``init_chain_state`` a request written field by field; the
    packet each superstep leaves against the eager stack; the packet's
    pinned buffers are the two made at start-up."""
    import dataclasses

    from repro_torch.core.sequential import init_y0
    from repro_torch.serving.worker import _SYNC_ROWS

    eng = _program_engine(dev, round_impl="packed", noise=noise, branches=1,
                          controller="aimd", R=1)
    pinned = [h.data_ptr() for h in eng._info_out]
    assert all(h.is_pinned() for h in eng._info_out)
    rid = 0
    for n in (1, 2, 3, 3):
        placed = [(slot, Request(rid + slot, key=np.array([0, 70 + rid + slot], np.uint32)))
                  for slot in range(n)]
        rid += n
        saved = {k: v.clone() for k, v in _slot_fields(eng).items()}
        eng._admit(placed)
        torch.cuda.synchronize()
        got = {k: v.clone() for k, v in _slot_fields(eng).items()}
        for k, v in _slot_fields(eng).items():
            v.copy_(saved[k])
        for slot, req in placed:
            key, k0 = t_asd.prng.split(t_asd.prng.as_key(req.key), 2).unbind(0)
            y0 = init_y0(eng.schedule, eng.event_shape, device=dev, key=k0.to(dev))
            new = t_asd.init_chain_state(eng.schedule, y0[None], eng.theta, False,
                                         eng.controller, key=key[None].to(dev), noise_mode=noise)
            for f in dataclasses.fields(t_asd.ASDChainState):
                if getattr(new, f.name) is not None:
                    getattr(eng._states, f.name)[slot] = getattr(new, f.name)[0]
        for k, v in _slot_fields(eng).items():
            assert torch.equal(got[k], v), (n, k)
    assert sorted(eng._admit_fns) == [1, 2, 4]
    assert all(p.graph is not None for p in eng._admit_fns.values())
    for _ in range(3):
        eng._launch_superstep(1, eng.round_budget)
        host, ready, samples = eng._sync_packet()
        st = eng._states
        want = torch.stack([getattr(st, n) for n in _SYNC_ROWS]).to(torch.int32)
        ready.synchronize()
        assert torch.equal(host, want.cpu())
        assert torch.equal(samples, t_asd.chain_sample(st, eng.schedule.K, False))
    assert [h.data_ptr() for h in eng._info_out] == pinned


def test_captured_decode_equals_the_eager_decode(dev):
    """reduced(hymba-1.5b), bf16: a greedy ``lm_decode_step`` captured with
    the token and ``pos`` as device tensors, the argmax written into the
    token inside the graph, replayed 6 times: the eager decode's tokens and
    logit bits."""
    from repro_torch.programs import SuperstepProgram

    cfg = reduced(get_config("hymba-1.5b"))
    params = t_lm.lm_compute_params(init_lm_params(cfg, 0, device=dev), cfg)
    B, P, T = 2, 40, 6
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        caches = t_lm.lm_cache_init(params, cfg, B, P + T)
        first, caches = t_lm.lm_prefill(params, tokens.to(dev), caches, cfg)
        start = {g: {k: {n: t.clone() for n, t in v.items()} for k, v in c.items()}
                 for g, c in caches.items()}
        tok, eager = first[:, 0].float().argmax(-1), []
        for i in range(T):
            lg, caches = t_lm.lm_decode_step(params, tok, caches, P + i, cfg)
            eager.append(lg[:, 0].float())
            tok = eager[-1].argmax(-1)
        tok = first[:, 0].float().argmax(-1)
        pos = torch.tensor(P, device=dev)
        out = torch.empty((T, B, cfg.vocab_size), device=dev)

        def body():
            lg, _ = t_lm.lm_decode_step(params, tok, start, pos, cfg)
            out.index_copy_(0, (pos - P).view(1), lg[:, 0].float()[None])
            tok.copy_(lg[:, 0].float().argmax(-1))
            pos.add_(1)

        prog = SuperstepProgram(body, dev)
        for _ in range(T):
            prog()
        torch.cuda.synchronize()
    assert prog.graph is not None and int(pos) == P + T
    assert torch.equal(out, torch.stack(eager))


# ---- B7 under autograd (the LM trainer): its backward is a kernel of its
# own (csrc/ssm_scan_bwd.cu), one reverse-time pass


def _scan_backward_inputs(B, L, D, dev):
    g = torch.Generator(device=dev).manual_seed(B * L + D)
    a = 0.5 + 0.499 * torch.rand(B, L, D, generator=g, device=dev)
    h = ssm_scan_plain(a, torch.randn(B, L, D, generator=g, device=dev))
    return a, h, torch.randn(B, L, D, generator=g, device=dev)


@pytest.mark.parametrize("B,L,D", [(2, 37, 25601), (3, 17, 130), (2, 1, 25600), (2, 50, 1),
                                   (2, 33, 256), (8, 128, 25600)])
def test_ssm_scan_backward_kernel_matches_plain_in_bits(dev, B, L, D):
    """One launch gives the plain reverse loop's da and db bit for bit: the
    same roundings (a_{t+1} g_{t+1}, then + G_t; g_t h_{t-1}), no FMA."""
    a, h, G = _scan_backward_inputs(B, L, D, dev)
    before = linear_scan.launches, linear_scan.backward_launches
    da, db = ssm_scan_backward_cuda(a, h, G)
    torch.cuda.synchronize()
    assert (linear_scan.launches - before[0], linear_scan.backward_launches - before[1]) == \
        (1, 1)
    pa, pb = ssm_scan_backward_plain(a, h, G)
    assert torch.equal(da, pa) and torch.equal(db, pb)


def test_ssm_scan_backward_takes_a_gradient_that_is_not_contiguous(dev):
    """Under autograd a strided upstream gradient is copied once and gives
    the bits of its contiguous copy; the backward is still one launch."""
    a, h, G = _scan_backward_inputs(2, 40, 96, dev)
    b = torch.randn_like(a).requires_grad_()
    a.requires_grad_()
    out = linear_scan(a, b)
    strided = G.transpose(1, 2).contiguous().transpose(1, 2)
    before = linear_scan.backward_launches
    got = torch.autograd.grad(out, (a, b), strided)
    torch.cuda.synchronize()
    assert linear_scan.backward_launches == before + 1
    want = ssm_scan_backward_plain(a.detach(), out.detach(), G)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_ssm_scan_backward_kernel_refuses_what_it_does_not_take(dev):
    a, h, G = _scan_backward_inputs(2, 8, 16, dev)
    strided = G.transpose(1, 2).contiguous().transpose(1, 2)
    before = linear_scan.launches, linear_scan.backward_launches
    for args in ((a, h, G.double()), (a.to(torch.bfloat16), h, G), (a, h.cpu(), G),
                 (a, h, strided), (a[0], h[0], G[0]), (a, h, G[:, :4])):
        with pytest.raises(ValueError):
            ssm_scan_backward_cuda(*args)
    assert (linear_scan.launches, linear_scan.backward_launches) == before


@pytest.mark.parametrize("B,L,D", [(2, 37, 25601), (3, 17, 130)])
def test_ssm_scan_backward_matches_autograd_through_plain(dev, B, L, D):
    """da, db and h of the kernel's autograd Function against autograd
    through the plain loop, within 1e-5 of each tensor's largest magnitude;
    one forward and one backward launch."""
    g = torch.Generator(device=dev).manual_seed(B * L + D)
    a = (0.5 + 0.499 * torch.rand(B, L, D, generator=g, device=dev)).requires_grad_()
    b = torch.randn(B, L, D, generator=g, device=dev).requires_grad_()
    G = torch.randn(B, L, D, generator=g, device=dev)
    before = linear_scan.launches, linear_scan.backward_launches
    h = linear_scan(a, b)
    da, db = torch.autograd.grad(h, (a, b), G)
    torch.cuda.synchronize()
    assert (linear_scan.launches - before[0], linear_scan.backward_launches - before[1]) == \
        (2, 1)
    hp = ssm_scan_plain(a, b)
    rda, rdb = torch.autograd.grad(hp, (a, b), G)
    for got, want in ((h, hp), (da, rda), (db, rdb)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_mamba_input_gets_a_gradient_on_the_card(dev):
    """The mixer's input and every param get a finite, nonzero gradient
    through B7 on the card, equal to the CPU's within 1e-4 of its scale (a
    scan output without a grad_fn would leave the scan's share out)."""
    from repro_torch.nn.ssm import mamba_fwd

    cfg = reduced(get_config("hymba-1.5b"))
    params = init_lm_params(cfg, 0, device="cpu")["decoder"]["g0"]["mamba"]
    layer = {k: v[1] for k, v in params.items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(4))
    grads = {}
    for where in ("cpu", dev):
        p = {k: v.to(where).requires_grad_() for k, v in layer.items()}
        xi = x.to(where).requires_grad_()
        out = mamba_fwd(p, xi, cfg)
        gs = torch.autograd.grad(out.square().sum(), [xi] + [p[k] for k in sorted(p)])
        grads[str(where)] = [t.cpu() for t in gs]
    for card, cpu in zip(grads[str(dev)], grads["cpu"]):
        assert torch.isfinite(card).all() and card.abs().max() > 0
        assert (card - cpu).abs().max() <= 1e-4 * cpu.abs().max()


@pytest.mark.parametrize("name", ["xlstm-125m", "hymba-1.5b"])
def test_lm_training_step_on_card_matches_cpu(dev, name):
    """One lm_loss gradient of the reduced arch in float32 from the same
    params and batch: the loss within 1e-5, every leaf's gradient within
    1e-4 of its largest magnitude (hymba: B7 forward and backward on the
    card)."""
    cfg = reduced(get_config(name))
    params = init_lm_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (4, 32), generator=g)}
    out = {}
    b0 = linear_scan.backward_launches
    for where in ("cpu", dev):
        ps = [p.to(where).requires_grad_() for p in _leaves_of(params)]
        tree = _unflatten(params, iter(ps))
        loss, _ = t_lm.lm_loss(tree, {k: v.to(where) for k, v in batch.items()}, cfg)
        out[str(where)] = (loss.item(), [t.cpu() for t in torch.autograd.grad(loss, ps)])
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[str(dev)]
    assert abs(l_card - l_cpu) <= 1e-5
    for card, cpu in zip(g_card, g_cpu):
        assert (card - cpu).abs().max() <= 1e-4 * cpu.abs().max()
    assert linear_scan.backward_launches - b0 == (cfg.n_layers if name == "hymba-1.5b"
                                                  else 0)


def _unflatten(tree, it):
    return ({k: _unflatten(tree[k], it) for k in sorted(tree)} if isinstance(tree, dict)
            else next(it))


# ------------------------------------------------------------- MoE and C1


def test_moe_lm_on_card_matches_cpu(dev):
    """The reduced qwen3-moe-30b-a3b (E 4, top 2, float32): the forward, the
    prefill and 8 greedy decode steps on the card against the same params
    on the CPU; tokens equal, logits within 2e-4 (float32 sums in other
    orders), B2's float32 kernel once a layer in the prefill and the
    forward."""
    from repro_torch import pytree

    cfg = reduced(get_config("qwen3-moe-30b-a3b"))
    params = init_lm_params(cfg, 0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    out = {}
    for where in ("cpu", dev):
        p = pytree.map(lambda t: t.to(where), params)
        flash_f32.launches = 0
        with torch.no_grad():
            full = t_lm.lm_fwd(p, tokens.to(where), cfg)
            caches = t_lm.lm_cache_init(p, cfg, 2, 48, dtype=torch.float32)
            lg, caches = t_lm.lm_prefill(p, tokens.to(where), caches, cfg)
            steps, toks = [lg[:, 0]], []
            for i in range(8):
                toks.append(steps[-1].argmax(-1))
                lg, caches = t_lm.lm_decode_step(p, toks[-1], caches, 40 + i, cfg)
                steps.append(lg[:, 0])
        out[str(where)] = (full.cpu(), torch.stack(toks, 1).cpu(), torch.stack(steps, 1).cpu(),
                           flash_f32.launches)
    (fc, tc, sc, _), (fg, tg, sg, launched) = out["cpu"], out[str(dev)]
    assert torch.equal(tc, tg)
    assert (fg - fc).abs().max().item() <= 2e-4 and (sg - sc).abs().max().item() <= 2e-4
    assert launched == 2 * cfg.n_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_is_the_same_bits_twice_and_captured(dev, dtype):
    """moe_apply (E 8, top 4, capacity_factor 1.0: tokens drop) twice, and
    captured in a CUDA graph and replayed: equal bits each time; and
    against the CPU's within 2e-4 (float32) or 5e-2 (bf16, a few ulps of
    outputs of order 1)."""
    import dataclasses

    from repro_torch.nn.moe import moe_apply

    cfg = dataclasses.replace(reduced(get_config("qwen3-moe-30b-a3b")), n_experts=8,
                              top_k=4, capacity_factor=1.0)
    g = torch.Generator(device=dev).manual_seed(3)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"router": torch.randn(d, E, generator=g, device=dev),
         "w_gate": torch.randn(E, d, ff, generator=g, device=dev) / d ** 0.5,
         "w_up": torch.randn(E, d, ff, generator=g, device=dev) / d ** 0.5,
         "w_down": torch.randn(E, ff, d, generator=g, device=dev) / ff ** 0.5}
    p = {k: v.to(dtype) for k, v in p.items()}
    x = torch.randn(3, 64, d, generator=g, device=dev).to(dtype)
    with torch.no_grad():
        a, b = moe_apply(p, x, cfg)[0], moe_apply(p, x, cfg)[0]
        static_x = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_apply(p, static_x, cfg)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe_apply(p, static_x, cfg)[0]
        graph.replay()
        torch.cuda.synchronize()
    assert torch.isfinite(a).all() and a.abs().max() > 0.1
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(a, out)
    cpu = moe_apply({k: v.cpu() for k, v in p.items()}, x.cpu(), cfg)[0]
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    assert (a.cpu().float() - cpu.float()).abs().max().item() <= tol


@pytest.mark.parametrize("name,capacity_factor", [("qwen3-moe-30b-a3b", None),
                                                   ("dbrx-132b", None),
                                                   ("qwen3-moe-30b-a3b", 1.0)])
def test_moe_lm_training_step_on_card_matches_cpu(dev, name, capacity_factor):
    """One lm_loss gradient of the reduced MoE arch in float32 (the router's
    aux term in the loss; capacity_factor 1.0 with routers scaled by 25:
    the capacity drops pairs) from the same params and batch: the loss
    within 1e-5, moe_aux within 1e-5, every leaf's gradient within 1e-4 of
    its largest magnitude."""
    import dataclasses

    cfg = reduced(get_config(name))
    params = init_lm_params(cfg, 0, device="cpu")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        params["decoder"]["g0"]["moe"]["router"].mul_(25.0)
    g = torch.Generator().manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g),
             "labels": torch.randint(0, cfg.vocab_size, (2, 32), generator=g)}
    out = {}
    for where in ("cpu", dev):
        ps = [p.to(where).requires_grad_() for p in _leaves_of(params)]
        tree = _unflatten(params, iter(ps))
        loss, metrics = t_lm.lm_loss(tree, {k: v.to(where) for k, v in batch.items()}, cfg)
        out[str(where)] = (loss.item(), metrics["moe_aux"].item(),
                           [t.cpu() for t in torch.autograd.grad(loss, ps)])
    (l_cpu, a_cpu, g_cpu), (l_card, a_card, g_card) = out["cpu"], out[str(dev)]
    assert a_cpu > 0 and abs(a_card - a_cpu) <= 1e-5
    assert abs(l_card - l_cpu) <= 1e-5
    for card, cpu in zip(g_card, g_cpu):
        assert (card - cpu).abs().max() <= 1e-4 * cpu.abs().max()


def test_adamw_groups_on_card_are_one_group_bit_for_bit(dev, monkeypatch):
    """AdamW a leaf at a time (a group of vectors alone among them: no
    weight-decay call there) against one group of every leaf on the card:
    the same bits over three steps."""
    from repro_torch import pytree
    from repro_torch.training import optimizer

    g = torch.Generator(device=dev).manual_seed(9)
    tree = {"a": torch.randn(30, 20, generator=g, device=dev),
            "b": torch.randn(7, generator=g, device=dev),
            "c": torch.randn(3, 5, 6, generator=g, device=dev)}
    grads = pytree.map(lambda t: torch.randn(t.shape, generator=g, device=dev), tree)
    out = []
    for group_bytes in (1 << 30, 4):
        monkeypatch.setattr(optimizer, "_GROUP_BYTES", group_bytes)
        opt = optimizer.adamw(optimizer.cosine_schedule(1e-2, 2, 10))
        params = pytree.map(torch.clone, tree)
        state = opt.init(params)
        for _ in range(3):
            params, state, _ = opt.update(grads, state, params)
        out.append(pytree.leaves({"p": params, "mu": state["mu"], "nu": state["nu"]}))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_dbrx_width_moe_layer_is_the_same_bits_twice_and_captured(dev):
    """One MoE layer at dbrx-132b's widths (d 6144, ff 10752, E 16, top 4,
    bf16) on 1 x 512 tokens (C 160: pairs drop): two calls, and a captured
    call replayed, equal in bits."""
    from repro_torch.nn.moe import capacity_of, moe_apply

    cfg = get_config("dbrx-132b")
    g = torch.Generator(device=dev).manual_seed(4)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff

    def draw(*shape, std):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(torch.bfloat16)

    p = {"router": draw(d, E, std=0.02 * 25),
         "w_gate": draw(E, d, ff, std=(E * d) ** -0.5),
         "w_up": draw(E, d, ff, std=(E * d) ** -0.5),
         "w_down": draw(E, ff, d, std=(E * ff) ** -0.5)}
    x = draw(1, 512, d, std=1.0)
    assert capacity_of(cfg, 512) == 160
    with torch.no_grad():
        a, b = moe_apply(p, x, cfg)[0], moe_apply(p, x, cfg)[0]
        static_x = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_apply(p, static_x, cfg)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = moe_apply(p, static_x, cfg)[0]
        graph.replay()
        torch.cuda.synchronize()
    assert torch.isfinite(a).all() and a.abs().max() > 0
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(a.view(torch.int16), out.view(torch.int16))


def test_moe_denoiser_point_is_the_same_bits_alone_and_in_a_batch(dev):
    """qwen3-moe-a3b-smoke at random weights: one point alone, and the first
    18, against the same points in a batch of 36, in bits (the denoiser runs
    in blocks of 16 points, each of one shape)."""
    from repro_torch.configs.registry import get_denoiser_config

    dc = get_denoiser_config("qwen3-moe-a3b-smoke")
    fn = t_diff.make_ddpm_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device=dev), dc)
    g = torch.Generator(device=dev).manual_seed(5)
    t = torch.randint(0, 64, (36,), generator=g, device=dev).float()
    y = torch.randn(36, dc.seq_len, dc.d_data, generator=g, device=dev)
    with torch.no_grad():
        full = fn(t, y)
        for m in (1, 18):
            assert torch.equal(fn(t[:m], y[:m]).view(torch.int32), full[:m].view(torch.int32))


@pytest.mark.parametrize("chunk", [7, 16])
def test_chunked_mamba_gives_the_unchunked_bits_on_the_card(dev, chunk):
    """The reduced hymba's mixer at chunks 7 and 16 against one chunk over
    all of L (B7 once a chunk), in bits, and the final state."""
    from repro_torch.nn.ssm import mamba_fwd

    cfg = reduced(get_config("hymba-1.5b"))
    params = init_lm_params(cfg, 0, device=dev)["decoder"]["g0"]["mamba"]
    layer = {k: v[1] for k, v in params.items()}
    x = torch.randn(2, 45, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(6),
                    device=dev)
    with torch.no_grad():
        whole, ws = mamba_fwd(layer, x, cfg, return_state=True, chunk=1 << 20)
        linear_scan.launches = 0
        out, st = mamba_fwd(layer, x, cfg, return_state=True, chunk=chunk)
    assert linear_scan.launches == -(-45 // chunk)
    assert torch.equal(out.view(torch.int32), whole.view(torch.int32))
    assert torch.equal(st["ssm"].view(torch.int32), ws["ssm"].view(torch.int32))


@pytest.mark.parametrize("arch, shape, L", [("tinyllama-1.1b", "train_4k", 64),
                                            ("hymba-1.5b", "train_4k", 64),
                                            ("tinyllama-1.1b", "prefill_32k", 128),
                                            ("hymba-1.5b", "decode_32k", 128)])
def test_dryrun_measures_a_reduced_lm_cell_on_the_card(dev, tmp_path, arch, shape, L):
    """``run_cell`` of a reduced cell of each LM kind on the card: measured
    ok and finite, timed by events, its peak read, B2 once a layer in a
    prefill (the reduced configs run float32: its float32 kernel), B7 in
    hymba's step (once a layer forward, once backward: no remat), a decode
    step as a captured graph."""
    from repro_torch.launch import dryrun

    cfg = reduced(get_config(arch))
    rec = dryrun.run_cell(arch, shape, "single", str(tmp_path), config=cfg, seq_len=L)
    assert rec["status"] == "ok", rec.get("traceback")
    m = rec["measured"]
    assert m["status"] == "ok" and m["finite"] and 0 < m["fraction"] <= 1.05
    assert m["peak_gb"] > 0 and m["device"] != "cpu" and len(m["runs_ms"]) >= 3
    launches = {k: v for k, v in m["launches_per_run"].items() if v}
    if shape == "prefill_32k":
        assert launches == {"flash_attention_f32": cfg.n_layers}
    elif arch == "hymba-1.5b" and shape == "train_4k":
        assert launches == {"ssm_scan": cfg.n_layers, "ssm_scan_backward": cfg.n_layers}
    elif shape == "decode_32k":
        assert "captured as a CUDA graph" in m["what"] and m["capture_ms"] > 0
        assert not launches
    else:
        assert not launches


def test_dryrun_measures_an_asd_round_on_the_card(dev, tmp_path):
    """The smoke policy's ASD cell at 8 chains, K 40, counter noise: rounds
    2-4 of the replayed round graph, B1 once and B2 (float32) twice a
    layer a round."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("paper-diffusion-policy-smoke", "asd", "single", str(tmp_path),
                          "memopt", n_chains=8, K=40)
    assert rec["status"] == "ok", rec.get("traceback")
    m = rec["measured"]
    assert m["status"] == "ok" and m["finite"] and m["capture_ms"] > 0
    assert {k: v for k, v in m["launches_per_run"].items() if v} == \
        {"grs": 1, "flash_attention_f32": 2 * 2}


def test_dryrun_too_large_cell_allocates_nothing(dev, tmp_path):
    """dbrx-132b's prefill_32k is reckoned past 0.9 of the card: recorded
    too_large, and not one byte is allocated for it."""
    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = dryrun.run_cell("dbrx-132b", "prefill_32k", "multi", str(tmp_path))
    assert rec["status"] == "ok" and rec["measured"]["status"] == "too_large"
    assert rec["measured"]["reckoned_gb"] > rec["measured"]["limit_gb"]
    assert torch.cuda.memory_allocated() == before == torch.cuda.max_memory_allocated()


def _tp2_policy_rank(group, seed):
    """One rank of a two-rank model group on the card: the policy smoke
    config's TP2 forward on its share of the weights, and rank 0's
    replicated forward; B2's launches in the sharded call."""
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.distributed.sharding import mp_param_pspecs, shard_params
    from repro_torch.kernels.flash_attention.ops import flash_f32
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn.param import param_axes
    from repro_torch.weights import param_shapes

    dc = paper_diffusion_policy_smoke()
    params = init_denoiser_params(dc, seed, out_scale=1.0, device=group.device)
    specs = mp_param_pspecs(param_axes(dc), param_shapes(dc), Mesh((2,), ("model",), ()))
    local = shard_params(params, specs, MeshGroups((group.world,), ("model",), group.rank))
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.uniform(1.0, 9.0, 5).astype(np.float32)).to(group.device)
    y = torch.from_numpy(rng.standard_normal((5, dc.seq_len, dc.d_data)).astype(
        np.float32)).to(group.device)
    before = flash_f32.launches
    out = t_diff.denoiser_fwd(local, t, y, dc, tp_axis=group)
    launches = flash_f32.launches - before
    ref = t_diff.denoiser_fwd(params, t, y, dc) if group.rank == 0 else None
    return dict(out=out.cpu(), ref=None if ref is None else ref.cpu(), launches=launches)


def test_tp2_forward_on_two_ranks_of_one_card(dev):
    """Two ranks share the card (gloo over pinned host copies): the TP2
    forward of the policy smoke config within 1e-5 of the replicated
    forward, the same bits on both ranks, B2's float32 kernel once a layer
    on the local heads."""
    from repro_torch.distributed.group import run_group

    r0, r1 = run_group(_tp2_policy_rank, 2, "cuda", (5,))
    assert torch.equal(r0["out"], r1["out"])
    torch.testing.assert_close(r0["out"], r0["ref"], atol=1e-5, rtol=1e-5)
    assert r0["launches"] == r1["launches"] == paper_diffusion_policy_smoke().backbone.n_layers


def _mesh_serve_policy(dev, layout=None):
    """The policy smoke engine (float32, unpacked, counter noise) on
    ``dev``, its slots laid out by ``layout``, served on six keyed
    requests: the samples, each request's counters, the engine's slot
    state bytes and whether it ran eagerly."""
    dc = paper_diffusion_policy_smoke()
    fn = t_diff.make_ddpm_model_fn(init_denoiser_params(dc, 5, out_scale=1.0, device=dev), dc)
    eng = ContinuousASDEngine(fn, t_sch.ddpm(16), (dc.seq_len, dc.d_data), num_slots=4,
                              theta=4, noise_mode="counter", keep_trajectory=False,
                              rounds_per_sync=2, device=dev, state_sharding=layout)
    rng = np.random.default_rng(5)
    out = eng.serve([Request(i, key=np.array([0, 700 + i], np.uint32),
                             y0=rng.standard_normal((dc.seq_len, dc.d_data)).astype(np.float32))
                     for i in range(6)])
    st = eng._states
    return dict(samples=out, eager=eng._eager,
                counters={m.rid: (m.rounds, m.head_calls, m.accepts, m.proposals)
                          for m in eng.stats.per_request},
                bytes=sum(getattr(st, f).numel() * getattr(st, f).element_size()
                          for f in ("y", "a", "rounds", "accepts")))


def _mesh_serve_rank(group):
    """One rank of a 2x1 serve mesh on the card."""
    from repro_torch.distributed.sharding import chain_state_shardings
    from repro_torch.launch.mesh import make_rank_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    return _mesh_serve_policy(group.device,
                              chain_state_shardings(make_rank_mesh(group, "2x1")))


def test_mesh_2x1_serve_on_two_ranks_of_one_card_gives_the_1x1_bits(dev):
    """The continuous engine's slots over a 2x1 mesh of two ranks sharing
    the card: rank 0 returns every request's sample in the 1 x 1 engine's
    bits, both ranks its counters, each holds half the slot state, and
    the supersteps stay captured graphs."""
    from repro_torch.distributed.group import run_group

    r0, r1 = run_group(_mesh_serve_rank, 2, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    one = _mesh_serve_policy(dev)
    assert sorted(r0["samples"]) == sorted(one["samples"]) == list(range(6))
    for rid, v in one["samples"].items():
        assert np.array_equal(r0["samples"][rid].view(np.int32), v.view(np.int32)), rid
    assert r0["counters"] == r1["counters"] == one["counters"]
    assert r0["bytes"] * 2 == r1["bytes"] * 2 == one["bytes"]
    assert not r0["eager"] and not r1["eager"]


def _mesh_2x1_rank(group, steps):
    """One rank of a 2x1 mesh on the card: reduced tinyllama in float32,
    the CLI's build (data parallelism, ZeRO-1), ``steps`` steps on
    MarkovLM batches; the losses and rank 0's whole params at the end."""
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_rank_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config("tinyllama-1.1b"))
    mesh = make_rank_mesh(group, "2x1")
    step, init, lay = train.build(cfg, mesh, 1, 3e-3, steps, device=group.device)
    params, opt = init()
    data = MarkovLM(vocab=cfg.vocab_size, seq_len=16, batch=8)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(group.device) for k, v in data.batch_at(s).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    mu_bytes = sum(t.numel() * t.element_size() for t in _flat(opt["mu"]).values())
    whole, _ = lay.gather(params, opt)
    return dict(losses=losses, params={k: v.cpu() for k, v in _flat(whole).items()},
                mu_bytes=mu_bytes, device=str(next(iter(_flat(params).values())).device))


def _flat(tree, pre=()):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], pre + (k,)))
        else:
            out["/".join(pre + (k,))] = tree[k]
    return out


def test_mesh_2x1_step_on_two_ranks_of_one_card_follows_1x1(dev):
    """The trainer's 2x1 mesh on two ranks sharing the card (gloo over
    pinned host copies) against the 1 x 1 trainer on the card, float32:
    losses within 1e-5 relative, the params after three steps within
    AdamW's bound, the same bits on both ranks, AdamW's state halved."""
    from repro_torch.data.pipeline import MarkovLM
    from repro_torch.distributed.group import run_group
    from repro_torch.launch import train

    steps = 3
    r0, r1 = run_group(_mesh_2x1_rank, 2, "cuda", (steps,))
    assert r0["device"].startswith("cuda") and r0["losses"] == r1["losses"]
    cfg = reduced(get_config("tinyllama-1.1b"))
    step, init, _ = train.build(cfg, None, 1, 3e-3, steps, device=dev)
    params, opt = init()
    data = MarkovLM(vocab=cfg.vocab_size, seq_len=16, batch=8)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(s).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5, atol=0)
    whole = sum(t.numel() * 4 for t in _flat(opt["mu"]).values())
    assert r0["mu_bytes"] < whole
    for k, v in _flat(params).items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        torch.testing.assert_close(r0["params"][k], v.cpu(), atol=2 * 3e-3 * steps, rtol=0)


def _mesh_1x2_pixel_rank(group):
    """One rank of a 1x2 serve mesh on the card: pixel-dit at its published
    widths and 2 of its 24 layers, its weights by the mesh's
    ``ServeLayout`` (cast to bf16 first, as the serve CLI does): the model
    call on 16 points (and on rank 0 the replicated call), then an engine
    over the rank's blocks serving four keyed requests."""
    import dataclasses

    from repro_torch.configs.registry import paper_pixel_dit
    from repro_torch.distributed.sharding import ServeLayout, chain_state_shardings
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.nn.param import param_axes
    from repro_torch.weights import param_shapes

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = group.device
    dc = paper_pixel_dit()
    dc = dataclasses.replace(dc, backbone=dataclasses.replace(dc.backbone, n_layers=2))
    params = t_diff.compute_params(init_denoiser_params(dc, 0, out_scale=1e-2, device=dev), dc)
    mesh = make_rank_mesh(group, "1x2")
    layout = ServeLayout(param_axes(dc), param_shapes(dc), mesh)
    g = torch.Generator(device=dev).manual_seed(9)
    t = torch.exp(torch.linspace(np.log(0.05), np.log(50.0), 16)).to(dev)
    y = torch.randn(16, dc.seq_len, dc.d_data, generator=g, device=dev) * (
        t * t + t).sqrt()[:, None, None]
    eng = ContinuousASDEngine(
        lambda p: make_sl_model_fn(p, dc, tp_axis=layout.tp_axis, at_use=layout.at_use),
        t_sch.sl_geometric(8, 0.05, 50.0), (dc.seq_len, dc.d_data), num_slots=4, theta=3,
        noise_mode="counter", keep_trajectory=False, state_sharding=chain_state_shardings(mesh),
        model_group=layout.model_group, params=params, param_specs=layout.specs)
    with torch.no_grad():
        call = eng._model_fn(t, y)
        ref = make_sl_model_fn(params, dc)(t, y) if group.rank == 0 else None
    resident = sum(x.numel() * x.element_size() for x in _leaves_of(eng._params))
    layout_bytes = layout.local_bytes(params)
    del params
    out = eng.serve([Request(i, key=np.array([0, 900 + i], np.uint32)) for i in range(4)])
    return dict(call=call.cpu(), ref=None if ref is None else ref.cpu(), samples=out,
                counters={m.rid: (m.rounds, m.accepts, m.proposals)
                          for m in eng.stats.per_request},
                eager=eng._eager, captures=sum(p.captures for p in eng._superstep_fns.values()),
                resident=resident, layout_bytes=layout_bytes,
                gathered=[".".join(p) for p in layout.gathered])


def test_mesh_1x2_pixel_dit_serve_on_two_ranks_of_one_card(dev):
    """The serve mesh's model axis on the card: two ranks share it, the
    weights laid out by ``param_pspecs`` (the attention and FFN blocks
    tensor-parallel, wk / wv, in_proj, out_proj and the time MLP gathered
    at use).  The model call is within the bf16 gate of the replicated
    call (2 x 2^-8 x sqrt(2 x depth): one more bf16 rounding of each
    row-parallel product's partial sums) and the ranks' bits agree; the
    engine's samples and counters agree on both ranks, its programs eager
    (no capture), each rank holding the layout's bytes of the weights."""
    from repro_torch.distributed.group import run_group

    r0, r1 = run_group(_mesh_1x2_pixel_rank, 2, "cuda")
    rel = ((r0["call"].float() - r0["ref"].float()).norm() / r0["ref"].float().norm()).item()
    assert rel <= 2 * 2.0 ** -8 * np.sqrt(2 * 2), rel
    assert torch.equal(r0["call"], r1["call"]) and bool(torch.isfinite(r0["call"]).all())
    assert sorted(r0["samples"]) == sorted(r1["samples"]) == list(range(4))
    for rid, v in r0["samples"].items():
        assert np.array_equal(v.view(np.int32), r1["samples"][rid].view(np.int32)), rid
        assert np.isfinite(v).all()
    assert r0["counters"] == r1["counters"]
    for r in (r0, r1):
        assert r["eager"] and r["captures"] == 0 and r["resident"] == r["layout_bytes"]
    assert {p.rsplit(".", 1)[-1] for p in r0["gathered"]} == {
        "wk", "wv", "in_proj", "out_proj", "t_mlp1", "t_mlp2"}


def _sampler_loop_eager_rank(group):
    """The fused sampler over four policy-smoke chains on this rank of a
    1x2 serve mesh, its rounds eager (``eager=True``)."""
    from repro_torch.distributed.sharding import ServeLayout
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.nn.param import param_axes
    from repro_torch.weights import param_shapes

    torch.backends.cuda.matmul.allow_tf32 = False
    dc = paper_diffusion_policy_smoke()
    params = init_denoiser_params(dc, 3, out_scale=1.0, device=group.device)
    layout = ServeLayout(param_axes(dc), param_shapes(dc), make_rank_mesh(group, "1x2"))
    fn = t_diff.make_ddpm_model_fn(layout.shard(params), dc, tp_axis=layout.tp_axis,
                                   at_use=layout.at_use)
    return _policy_sampler(fn, dc, group.device, eager=True)


def _policy_sampler(fn, dc, dev, eager=False):
    y0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, dc.seq_len, dc.d_data)).astype(np.float32)).to(dev)
    with torch.no_grad():
        res = t_asd.asd_sample_batched(fn, t_sch.ddpm(12), y0, 4, eager_head=True,
                                       keep_trajectory=False, device=dev,
                                       noise_mode="counter", key=t_asd.prng.PRNGKey(2),
                                       eager=eager)
    torch.cuda.synchronize()
    return dict(sample=res.sample.cpu(), rounds=res.rounds.cpu(),
                capture_ms=res.loop.capture_ms, loop_rounds=res.loop.rounds)


def test_sampler_loop_eager_under_a_model_group_and_captured_without(dev):
    """``asd_sample_batched(eager=True)`` over a 1x2 mesh's model group runs
    every round eagerly (no capture: its collectives are host-staged), the
    two ranks in the same bits; without a model group the loop is captured
    as before; the two within 1e-5 with the same rounds."""
    from repro_torch.distributed.group import run_group

    r0, r1 = run_group(_sampler_loop_eager_rank, 2, "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    dc = paper_diffusion_policy_smoke()
    fn = t_diff.make_ddpm_model_fn(init_denoiser_params(dc, 3, out_scale=1.0, device=dev), dc)
    one = _policy_sampler(fn, dc, dev)
    assert r0["capture_ms"] is None and r1["capture_ms"] is None
    assert one["capture_ms"] is not None
    assert torch.equal(r0["sample"], r1["sample"]) and torch.equal(r0["rounds"], r1["rounds"])
    torch.testing.assert_close(r0["sample"], one["sample"], atol=1e-5, rtol=1e-5)
    assert torch.equal(r0["rounds"], one["rounds"]) and r0["loop_rounds"] == one["loop_rounds"]
