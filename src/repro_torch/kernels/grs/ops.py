"""GRS (paper Alg 3) on the card: wrapper of the CUDA kernel ``csrc/grs.cu``.

Replaces the TPU kernel ``repro/kernels/grs/kernel.py::_grs_kernel``.  The
kernel is memory-bound (two row reductions and an elementwise select); the
source note in ``csrc/grs.cu`` says how its two passes fill the card at the
main path's 32 rows of 196,608 floats.

The plain PyTorch version is ``repro_torch.core.grs.grs``.  ``grs`` below
takes it only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``grs.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.grs import grs as grs_plain
from repro_torch.kernels import _build

CHUNK = 4096  # elements of a row per block

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def grs_cuda(u, sigma, xi, m_hat, m):
    """The kernel on (R,) u, sigma and (R, D) xi, m_hat, m, all float32 on
    one CUDA device.  Returns (z (R, D) f32, accept (R,) int32)."""
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
    part = torch.empty((R, math.ceil(D / CHUNK), 2), dtype=torch.float32,
                       device=xi.device)
    fn = _build.function("repro_grs", _ARGTYPES)
    err = fn(u.data_ptr(), sigma.data_ptr(), xi.data_ptr(), m_hat.data_ptr(),
             m.data_ptr(), z.data_ptr(), acc.data_ptr(), part.data_ptr(), R, D, CHUNK,
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
