"""GRS (paper Alg 3) on the card: wrapper of the CUDA kernel ``csrc/grs.cu``.

Replaces the TPU kernel ``repro/kernels/grs/kernel.py::_grs_kernel``.  The
kernel is memory-bound (two row reductions and an elementwise select).  It
is one launch: a thread block cluster per row holds the row on chip, sums
its blocks' partials over distributed shared memory and writes z from what
it holds (the source note in ``csrc/rows.cuh`` says how).
``row_geometry`` is the one place that decides how a row is cut over a
cluster; B1 and the fused verify-commit (B6, ``kernels/superstep/ops.py``)
both launch with it, so the packed and the fused round sum in the same
order and give the same bits.

The plain PyTorch version is ``repro_torch.core.grs.grs``.  ``grs`` below
takes it only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``grs.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.grs import grs as grs_plain
from repro_torch.kernels import _build

# These mirror csrc/rows.cuh: kRowThreads (the kernels' block size), kHeld
# (floats of m a thread holds in registers) and kMaxCluster (the portable
# cluster size).  SLICE is the fewest floats a block takes before a row is
# spread over more blocks.
THREADS = 512
HELD = 48
MAX_CLUSTER = 8
SLICE = 4096

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]


class RowGeometry(NamedTuple):
    """How a row of D floats is cut: ``cluster`` blocks, block k owning
    floats [k per_block, (k + 1) per_block) of it, with ``smem_bytes`` of
    dynamic shared memory each (0: the slice streams)."""

    cluster: int
    per_block: int
    smem_bytes: int


def row_geometry(D: int) -> RowGeometry:
    """The cluster geometry of one GRS row of D floats, for B1 and B6.

    A row spreads over one block per SLICE floats, at most MAX_CLUSTER
    blocks; each block's slice is a multiple of 4 floats, so slices of a
    16-byte aligned row start 16-byte aligned (the TMA bulk copies need
    it).  A slice of at most THREADS * HELD floats is held: xi and m_hat
    in shared memory (8 bytes a float), m in registers.  A longer one (D
    above 196,608) streams from device memory and needs no shared memory.
    This is the one place that decides it: the kernels hold a slice
    exactly when ``smem_bytes`` is not 0."""
    if D <= 0:
        raise ValueError(f"row_geometry: D must be positive, got {D}")
    cluster = min(MAX_CLUSTER, -(-D // SLICE))
    per_block = 4 * -(-D // (4 * cluster))
    held = per_block <= THREADS * HELD
    return RowGeometry(cluster, per_block, 8 * per_block if held else 0)


def max_active_clusters(geometry: RowGeometry) -> int:
    """How many clusters of ``geometry`` the current card runs at once."""
    fn = _build.function("repro_grs_max_active_clusters",
                         [ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(fn(geometry.cluster, geometry.smem_bytes, ctypes.byref(out)),
                 "cudaOccupancyMaxActiveClusters")
    return out.value


def grs_cuda(u, sigma, xi, m_hat, m):
    """The kernel on (R,) u, sigma and (R, D) xi, m_hat, m, all float32 on
    one CUDA device, launched with ``row_geometry(D)``.  Returns (z (R, D)
    f32, accept (R,) int32)."""
    R, D = xi.shape
    for name, t, shape in (("u", u, (R,)), ("sigma", sigma, (R,)), ("xi", xi, (R, D)),
                           ("m_hat", m_hat, (R, D)), ("m", m, (R, D))):
        if t.device != xi.device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"grs kernel: {name} must be float32 {shape} on "
                             f"{xi.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"grs kernel: {name} must be contiguous")
    z = torch.empty_like(xi)
    acc = torch.empty((R,), dtype=torch.int32, device=xi.device)
    fn = _build.function("repro_grs", _ARGTYPES)
    err = fn(u.data_ptr(), sigma.data_ptr(), xi.data_ptr(), m_hat.data_ptr(),
             m.data_ptr(), z.data_ptr(), acc.data_ptr(), R, D, *row_geometry(D),
             torch.cuda.current_stream(xi.device).cuda_stream)
    _build.check(err, "grs kernel launch")
    grs.launches += 1
    return z, acc


def grs(u, xi, m_hat, m, sigma, event_ndim: int = 1):
    """Drop-in for ``repro_torch.core.grs.grs`` (same arguments and
    results): the plain version on the CPU, the CUDA kernel on the card.
    Batch dims collapse to rows and event dims to one feature axis."""
    if xi.device.type == "cpu":
        return grs_plain(u, xi, m_hat, m, sigma, event_ndim=event_ndim)
    if xi.device.type != "cuda":
        raise ValueError(f"grs: no kernel for device {xi.device}")
    batch_shape = tuple(xi.shape[: xi.ndim - event_ndim])
    event_shape = tuple(xi.shape[xi.ndim - event_ndim:])
    R, D = math.prod(batch_shape), math.prod(event_shape)
    z, acc = grs_cuda(
        u.reshape(R).contiguous(),
        torch.broadcast_to(sigma, batch_shape).reshape(R).contiguous(),
        xi.reshape(R, D).contiguous(), m_hat.reshape(R, D).contiguous(),
        m.reshape(R, D).contiguous())
    return z.reshape(batch_shape + event_shape), acc.reshape(batch_shape).bool()


grs.launches = 0
