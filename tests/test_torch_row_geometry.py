"""The row geometry of the GRS (B1) and fused verify-commit (B6) cluster
kernels, on the CPU: how ``row_geometry`` cuts a row over a thread block
cluster, that both wrappers launch with it, and a float32 emulation of the
kernels' summation order held against the plain GRS.  No GPU is needed:
the kernels' C entry is replaced by a recorder."""

import types

import numpy as np
import pytest
import torch

from repro_torch.core.grs import grs as grs_plain
from repro_torch.kernels import _build
from repro_torch.kernels.grs import ops as grs_ops
from repro_torch.kernels.superstep import ops as fused_ops

SMEM_LIMIT = 232_448  # bytes of shared memory a block can have on sm_90

# paper-pixel-dit (1024 x 192), paper-ldm-dit (16,384) and
# paper-diffusion-policy (224) rows; the edge shapes of the kernel checks
# (D = 1, 5, 4097, 5000, rank-3 events of 48 and 21 floats); rows just
# past what a cluster holds, which stream
DS = [196_608, 16_384, 224, 1, 5, 4097, 5000, 48, 21, 4096, 196_612, 262_144, 300_001]


@pytest.mark.parametrize("D", DS)
def test_row_geometry_covers_the_row_once(D):
    geo = grs_ops.row_geometry(D)
    count = np.zeros(D, np.int64)
    for k in range(geo.cluster):
        count[k * geo.per_block:(k + 1) * geo.per_block] += 1
    assert (count == 1).all()
    # every block owns part of the row
    assert (geo.cluster - 1) * geo.per_block < D


@pytest.mark.parametrize("D", DS)
def test_row_geometry_fits_the_card(D):
    geo = grs_ops.row_geometry(D)
    assert 1 <= geo.cluster <= grs_ops.MAX_CLUSTER == 8  # portable: no layout needs 16
    assert geo.smem_bytes <= SMEM_LIMIT
    held = geo.per_block <= grs_ops.THREADS * grs_ops.HELD
    # a held slice keeps xi and m_hat in shared memory; a streamed one none
    assert geo.smem_bytes == (8 * geo.per_block if held else 0)
    assert held == (D <= 8 * grs_ops.THREADS * grs_ops.HELD)
    # slices start on 16-byte boundaries of a 16-byte aligned row (TMA)
    assert geo.per_block % 4 == 0
    assert all(k * geo.per_block * 4 % 16 == 0 for k in range(geo.cluster))


def test_row_geometry_at_the_main_path():
    """paper-pixel-dit: 8 blocks of 24,576 floats, 192 KB each, held."""
    assert tuple(grs_ops.row_geometry(196_608)) == (8, 24_576, 196_608)


def test_row_geometry_refuses_an_empty_row():
    with pytest.raises(ValueError):
        grs_ops.row_geometry(0)


class _Recorder:
    """Stands in for the kernel library: records each C call's arguments."""

    def __init__(self):
        self.calls = []

    def function(self, name, argtypes):
        def call(*args):
            assert len(args) == len(argtypes), name
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "function", rec.function)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    # the wrappers count the recorded calls as launches: restore the counts,
    # which other tests read
    monkeypatch.setattr(grs_ops.grs, "launches", grs_ops.grs.launches)
    monkeypatch.setattr(fused_ops.fused_verify_commit, "launches",
                        fused_ops.fused_verify_commit.launches)
    return rec


@pytest.mark.parametrize("D", [196_608, 4097, 300_001])
def test_b1_and_b6_launch_with_row_geometry(recorder, D):
    R, M, N = 3, 3, 5
    f = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    grs_ops.grs_cuda(f(R), f(R), f(R, D), f(R, D), f(R, D))
    fused_ops.fused_verify_commit_cuda(f(M, D), f(M, D), f(M, D), f(M, D), f(M), f(M), f(M),
                                       f(M), torch.tensor([4, 0, 9]), N)
    (b1_name, b1), (b6_name, b6) = recorder.calls
    geo = tuple(grs_ops.row_geometry(D))
    # repro_grs(..., R, D, cluster, per_block, smem_bytes, stream)
    assert b1_name == "repro_grs" and b1[7:9] == (R, D) and b1[9:12] == geo
    # repro_fused_verify_commit(..., M, N, D, cluster, per_block, smem_bytes,
    # stream)
    assert b6_name == "repro_fused_verify_commit" and b6[11:14] == (M, N, D)
    assert b6[14:17] == geo


# ---- the kernels' summation order, emulated in float32


def _fma(a, b, c):
    """float32 fmaf: the product is exact in float64, then one rounding
    (twice, through float64, which the tolerance below covers)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _block_sums(m, x, h, V, T=grs_ops.THREADS):
    """A block's (vv, vx) as rows.cuh::grs_row forms it: thread t walks the
    V-wide elements t, t + T, ... of its slice in order (the V lanes in
    order) with fmaf, then a butterfly warp_sum, then warps in order."""
    nvec = len(x) // V
    nk = -(-nvec // T)
    vv = np.zeros(T, np.float32)
    vx = np.zeros(T, np.float32)
    for k in range(nk):
        q = k * T + np.arange(T)
        live = q < nvec
        for j in range(V):
            e = np.where(live, q * V + j, 0)
            v = (h[e] - m[e]).astype(np.float32)
            vv = np.where(live, _fma(v, v, vv), vv)
            vx = np.where(live, _fma(v, x[e], vx), vx)
    lanes = np.arange(32)
    out = []
    for s in (vv, vx):
        w = s.reshape(T // 32, 32)
        for off in (16, 8, 4, 2, 1):
            w = (w + w[:, lanes ^ off]).astype(np.float32)
        total = np.float32(0)
        for lane0 in w[:, 0]:
            total = np.float32(total + lane0)
        out.append(total)
    return out


def _emulated_grs(u, xi, mh, m, sigma):
    """z, accept of rows.cuh::grs_row over a (R, D) float32 batch, with
    row_geometry's cut and the 16-byte path where D allows it."""
    R, D = xi.shape
    geo = grs_ops.row_geometry(D)
    V = 4 if D % 4 == 0 else 1
    z = np.empty_like(xi)
    acc = np.zeros(R, bool)
    for r in range(R):
        pairs = []
        for k in range(geo.cluster):
            sl = slice(k * geo.per_block, min((k + 1) * geo.per_block, D))
            pairs.append(_block_sums(m[r, sl], xi[r, sl], mh[r, sl], V))
        vv = vx = np.float32(0)
        for a, b in pairs:  # ranks in order, over DSMEM
            vv, vx = np.float32(vv + a), np.float32(vx + b)
        sg = np.float32(sigma[r])
        s = sg if sg > 0 else np.float32(1)
        log_ratio = -(vx / s + vv / (np.float32(2) * s * s))
        accept = np.log(max(u[r], np.float32(1e-20))) <= min(log_ratio, np.float32(0))
        if not sg > 0:
            accept = vv <= 0
        coef = np.float32(2) * vx / (vv if vv > 0 else np.float32(1))
        if accept:
            z[r] = _fma(np.full(D, sg), xi[r], mh[r])
        else:
            v = (mh[r] - m[r]).astype(np.float32)
            xref = _fma(np.full(D, -coef), v, xi[r]) if vv > 0 else xi[r]
            z[r] = _fma(np.full(D, sg), xref, m[r])
        acc[r] = accept
    return z, acc


def _rows(R, D, seed):
    rng = np.random.default_rng(seed)
    u = rng.random(R).astype(np.float32)
    xi = rng.standard_normal((R, D)).astype(np.float32)
    mh = rng.standard_normal((R, D)).astype(np.float32)
    m = (mh + 0.4 * rng.standard_normal((R, D)) / np.sqrt(D)).astype(np.float32)
    sigma = (0.05 + 0.5 * rng.random(R)).astype(np.float32)
    sigma[0] = 0.0  # sigma 0, v != 0: reject, z = m
    m[1] = mh[1]  # v 0: accept
    return u, xi, mh, m, sigma


def _near_threshold(u, xi, mh, m, sigma):
    v = (mh - m).astype(np.float64)
    vv, vx = (v * v).sum(-1), (v * xi).sum(-1)
    s = np.where(sigma > 0, sigma, 1.0)
    lr = -(vx / s + vv / (2 * s * s))
    return (np.abs(np.log(np.maximum(u, 1e-20)) - np.minimum(lr, 0)) < 1e-5) & (sigma > 0)


# 20,000: five blocks a row on the 16-byte path; 4097: two blocks on the
# 4-byte path; 224: paper-diffusion-policy's row, one block
@pytest.mark.parametrize("D", [20_000, 4097, 224])
def test_emulated_summation_order_matches_plain_grs(D):
    args = _rows(6, D, D)
    z, acc = _emulated_grs(*args)
    zp, ap = grs_plain(*(torch.from_numpy(a) for a in args))
    # the chip_smoke.py gate: z within 1e-5, accept bits equal away from
    # the threshold (float32 sums in another order)
    np.testing.assert_allclose(z, zp.numpy(), atol=1e-5, rtol=0)
    near = _near_threshold(*args)
    np.testing.assert_array_equal(acc[~near], ap.numpy()[~near])
    assert not acc[0] and acc[1] and (~acc).sum() > 1
