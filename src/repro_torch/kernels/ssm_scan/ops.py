"""Linear scan on the card: wrapper of the CUDA kernel ``csrc/ssm_scan.cu``.

Replaces the TPU kernel ``repro/kernels/ssm_scan/kernel.py::_scan_kernel``
(through ``ssm_scan``, wrapped by that package's ``ops.py::linear_scan``):
h_t = a_t * h_{t-1} + b_t over (B, L, D), float32 carry, h_{-1} = 0.  The
kernel is bound by bytes; the source note in the ``.cu`` file says how it
keeps enough of them in flight.  It takes any L and D and masks its own
ragged edge, so nothing is padded.

The plain PyTorch version is ``ssm_scan_plain``.  ``linear_scan`` takes it
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``linear_scan.launches`` counts kernel launches.

``linear_scan`` is differentiable.  Its backward is the same recurrence
run in reverse time: with the upstream gradient G, g_t = G_t + a_{t+1}
g_{t+1} (a_L = 0), db = g and da_t = g_t h_{t-1} (h_{-1} = 0).  Its plain
version is ``ssm_scan_backward_plain``; on the card it is one launch of
its own kernel, ``csrc/ssm_scan_bwd.cu``, which reads a_{t+1} and h_{t-1}
at their own offsets, so nothing is shifted or flipped in device memory.
That launch counts in ``linear_scan.launches`` and apart in
``linear_scan.backward_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                         ctypes.c_void_p]


def ssm_scan_plain(a, b):
    """The recurrence as a sequential loop over L in float32: each step
    rounds a * h, then adds b.  a, b: (B, L, D) -> h (B, L, D) in a's
    dtype."""
    a32, b32 = a.float(), b.float()
    out = torch.empty_like(a32)
    h = torch.zeros_like(a32[:, 0])
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def _check_kernel_inputs(what, **tensors):
    """(B, L, D) of the kernel's inputs, or ValueError: each one float32,
    contiguous, of the first one's (B, L, D) shape, on its CUDA device."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {first.device}")
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != first.device:
            raise ValueError(f"{what}: {name} must be float32 on {first.device}, "
                             f"got {t.dtype} on {t.device}")
        if t.ndim != 3 or t.shape != first.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} must be one (B, L, D) "
                             f"shape with {tuple(first.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    B, L, D = first.shape
    if not (0 < B <= 65535 and 0 < L < 2 ** 31 and D > 0):
        raise ValueError(f"{what}: shape {tuple(first.shape)} needs "
                         "0 < B <= 65535, L >= 1, D >= 1")
    return B, L, D


def ssm_scan_cuda(a, b):
    """The kernel on CUDA tensors a, b: (B, L, D) float32, contiguous, on one
    device.  Returns h (B, L, D) float32."""
    B, L, D = _check_kernel_inputs("ssm_scan kernel", a=a, b=b)
    h = torch.empty_like(a)
    fn = _build.function("repro_ssm_scan", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, L, D,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ssm_scan kernel launch")
    linear_scan.launches += 1
    return h


def ssm_scan_backward_plain(a, h, G):
    """The backward as a reverse loop over L in float32: g_t = a_{t+1} *
    g_{t+1} + G_t (each step rounds the product, then the sum), db_t = g_t,
    da_t = g_t * h_{t-1}, with a_L = 0, g_L = 0 and h_{-1} = 0.  a, h, G:
    (B, L, D) -> (da, db) in a's dtype."""
    a32, h32, G32 = a.float(), h.float(), G.float()
    da, db = torch.empty_like(a32), torch.empty_like(a32)
    zero = torch.zeros_like(a32[:, 0])
    g = zero
    L = a.shape[1]
    for t in range(L - 1, -1, -1):
        g = (a32[:, t + 1] if t + 1 < L else zero) * g + G32[:, t]
        db[:, t] = g
        da[:, t] = g * (h32[:, t - 1] if t > 0 else zero)
    return da.to(a.dtype), db.to(a.dtype)


def ssm_scan_backward_cuda(a, h, G):
    """The backward kernel on CUDA tensors a, h, G: (B, L, D) float32,
    contiguous, on one device.  Returns (da, db), (B, L, D) float32."""
    B, L, D = _check_kernel_inputs("ssm_scan backward kernel", a=a, h=h, G=G)
    da, db = torch.empty_like(a), torch.empty_like(a)
    fn = _build.function("repro_ssm_scan_bwd", _BWD_ARGTYPES)
    err = fn(a.data_ptr(), h.data_ptr(), G.data_ptr(), da.data_ptr(), db.data_ptr(), B, L, D,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ssm_scan backward kernel launch")
    linear_scan.launches += 1
    linear_scan.backward_launches += 1
    return da, db


def _scan(a, b):
    """The device's scan: the plain version on the CPU, the kernel on the
    card."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ssm_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan: no kernel for device {a.device}")
    return ssm_scan_cuda(a, b)


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, G):
        a, h = ctx.saved_tensors
        G = G.to(a.dtype)
        if a.device.type == "cpu":
            return ssm_scan_backward_plain(a, h, G)
        if a.device.type != "cuda":
            raise ValueError(f"linear_scan: no backward kernel for device {a.device}")
        # a gradient that arrives strided (an expanded or permuted view) is
        # copied once; a contiguous one, as the mamba mixer's C readout
        # gives, goes to the kernel as it is
        return ssm_scan_backward_cuda(a, h, G.contiguous())


def linear_scan(a, b):
    """a, b: (B, L, D) -> the full state trajectory h (B, L, D), h_t = a_t
    h_{t-1} + b_t, in a's dtype: the plain version on the CPU, the CUDA
    kernel on the card; differentiable in a and b."""
    if a.ndim != 3 or tuple(b.shape) != tuple(a.shape):
        raise ValueError(f"linear_scan: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         "must be one (B, L, D) shape")
    return _LinearScan.apply(a, b)


linear_scan.launches = 0
linear_scan.backward_launches = 0
