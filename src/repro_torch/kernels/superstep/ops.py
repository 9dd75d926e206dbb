"""The fused packed-round pair on the card: wrappers of the CUDA kernels in
``csrc/superstep.cu``.

Replace the TPU kernels ``repro/kernels/superstep/kernel.py::
_fused_gather_kernel`` and ``::_fused_commit_kernel``.  ``fused_gather`` is
the pack side of a fused round in one launch; ``fused_verify_commit`` is
the target mean, the GRS pass and the commit scatter in one launch: B1's
cluster row code, one cluster per destination row, with B1's row geometry
(``kernels/grs/ops.py::row_geometry``), so the fused round gives the packed
round's bits (the source notes in ``csrc/superstep.cu`` and
``csrc/rows.cuh``).

The plain versions are composed as the JAX package's
``kernels/superstep/ref.py`` composes them: row takes, the plain GRS
(``repro_torch.core.grs.grs``) and the drop-row scatter.  The public
functions take them only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise.  ``fused_gather.launches`` and
``fused_verify_commit.launches`` count kernel launches.

Nothing is padded here: the kernels mask ragged M and D themselves, so the
JAX wrapper's padding rows (whose sigma it pads to 1.0 so that their GRS
math stays finite before they are dropped) do not exist.  Indices are
int64, as the pack maps carry them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.grs import bcast_right
from repro_torch.core.grs import grs as grs_plain
from repro_torch.kernels import _build
from repro_torch.kernels.grs.ops import row_geometry
from repro_torch.kernels.pack.ops import (CHUNK, _check, _on_card, _rows,
                                          gather_rows_plain, scatter_rows_plain)

_GATHER_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
_COMMIT_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]


def fused_gather_plain(y_tbl, xi_tbl, mh_tbl, scal_tbl, idx):
    """Rows ``idx`` (M,) of the y_prev / xi / m_hat tables (N, *event) and
    of the scalar table (N, C) -> ((M, *event) x 3, (M, C))."""
    return tuple(gather_rows_plain(t, idx) for t in (y_tbl, xi_tbl, mh_tbl, scal_tbl))


def fused_verify_commit_plain(y, g, xi, mh, A, B, u, sigma, idx, num_rows: int):
    """m = A y + B g, the plain GRS pass, then z / accept routed to their
    rows of (num_rows, *event) / (num_rows,) tables (idx[p] >= num_rows
    drops row p, unwritten rows are zero and not accepted)."""
    ev_ndim = y.ndim - 1
    m_tgt = bcast_right(A, ev_ndim + 1) * y + bcast_right(B, ev_ndim + 1) * g
    z, acc = grs_plain(u, xi, mh, m_tgt, sigma, event_ndim=ev_ndim)
    return scatter_rows_plain(z, idx, num_rows), scatter_rows_plain(acc, idx, num_rows)


def fused_gather_cuda(y, xi, mh, sc, idx):
    """The kernel on (N, D) float32 tables y, xi, mh, the (N, C) float32
    scalar table and (M,) int64 indices, all on one CUDA device."""
    N, D = y.shape
    C = sc.shape[1]
    (M,) = idx.shape
    dev = y.device
    for name, t in (("y", y), ("xi", xi), ("m_hat", mh)):
        _check(f"fused gather kernel: {name}", t, (N, D), torch.float32, dev)
    _check("fused gather kernel: scalars", sc, (N, C), torch.float32, dev)
    _check("fused gather kernel: idx", idx, (M,), torch.int64, dev)
    outs = [torch.empty((M, D), dtype=torch.float32, device=dev) for _ in range(3)]
    osc = torch.empty((M, C), dtype=torch.float32, device=dev)
    fn = _build.function("repro_fused_gather", _GATHER_ARGS)
    err = fn(y.data_ptr(), xi.data_ptr(), mh.data_ptr(), sc.data_ptr(), idx.data_ptr(),
             *(o.data_ptr() for o in outs), osc.data_ptr(), N, M, D, C, CHUNK,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused gather kernel launch")
    fused_gather.launches += 1
    return (*outs, osc)


def fused_verify_commit_cuda(y, g, xi, mh, A, B, u, sigma, idx, num_rows: int):
    """The kernel on (M, D) float32 rows y, g, xi, mh, (M,) float32 A, B,
    u, sigma and (M,) int64 indices on one CUDA device.  Returns (z
    (num_rows, D) float32, accept (num_rows,) int32)."""
    M, D = y.shape
    dev = y.device
    for name, t in (("y", y), ("g", g), ("xi", xi), ("m_hat", mh)):
        _check(f"fused commit kernel: {name}", t, (M, D), torch.float32, dev)
    for name, t in (("A", A), ("B", B), ("u", u), ("sigma", sigma)):
        _check(f"fused commit kernel: {name}", t, (M,), torch.float32, dev)
    _check("fused commit kernel: idx", idx, (M,), torch.int64, dev)
    z = torch.empty((num_rows, D), dtype=torch.float32, device=dev)
    acc = torch.empty((num_rows,), dtype=torch.int32, device=dev)
    # B1's geometry: the same partial sums in the same order as the packed
    # round's GRS kernel, so both rounds give the same bits
    fn = _build.function("repro_fused_verify_commit", _COMMIT_ARGS)
    err = fn(u.data_ptr(), sigma.data_ptr(), A.data_ptr(), B.data_ptr(), y.data_ptr(),
             g.data_ptr(), xi.data_ptr(), mh.data_ptr(), idx.data_ptr(), z.data_ptr(),
             acc.data_ptr(), M, num_rows, D, *row_geometry(D),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused verify-commit kernel launch")
    fused_verify_commit.launches += 1
    return z, acc


def fused_gather(y_tbl, xi_tbl, mh_tbl, scal_tbl, idx):
    """The pack side of a fused round: rows ``idx`` (M,) of the y_prev / xi
    / m_hat tables (N, *event) and of the (N, C) scalar table (t, u, A, B,
    sigma as lanes).  Returns ((M, *event) x 3, (M, C)).  Padding positions
    carry idx 0.  The plain version on the CPU, one kernel launch on the
    card."""
    if not _on_card(y_tbl, "fused_gather"):
        return fused_gather_plain(y_tbl, xi_tbl, mh_tbl, scal_tbl, idx)
    ev = tuple(y_tbl.shape[1:])
    M = idx.shape[0]
    oy, oxi, omh, osc = fused_gather_cuda(
        *(_rows(t).contiguous() for t in (y_tbl, xi_tbl, mh_tbl)),
        scal_tbl.contiguous(), idx.to(torch.int64).contiguous())
    return (oy.reshape((M,) + ev), oxi.reshape((M,) + ev), omh.reshape((M,) + ev), osc)


def fused_verify_commit(y, g, xi, mh, A, B, u, sigma, idx, num_rows: int):
    """The verify/commit side of a fused round: m = A y + B g, the GRS
    accept/reflect pass, and the scatter of z / accept into the
    (num_rows, *event) / (num_rows,) slot-window tables.

    y, g, xi, mh: (M, *event); A, B, u, sigma: (M,); idx: (M,), with
    idx[p] >= num_rows dropping row p.  Unwritten rows are zero (accept
    False).  Accept comes back as bool.  The plain version on the CPU, one
    kernel launch on the card."""
    if not _on_card(y, "fused_verify_commit"):
        return fused_verify_commit_plain(y, g, xi, mh, A, B, u, sigma, idx, num_rows)
    ev = tuple(y.shape[1:])
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    z, acc = fused_verify_commit_cuda(
        *(_rows(t).contiguous() for t in (y, g, xi, mh)),
        f32(A), f32(B), f32(u), f32(sigma), idx.to(torch.int64).contiguous(),
        int(num_rows))
    return z.reshape((int(num_rows),) + ev), acc.bool()


fused_gather.launches = 0
fused_verify_commit.launches = 0
