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
g_{t+1} is the scan of (a shifted one step earlier, G) over flipped time,
then db = g and da_t = g_t h_{t-1} (h_{-1} = 0).  On the card that is one
more launch of the kernel, counted in ``linear_scan.launches`` and apart
in ``linear_scan.backward_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
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


def ssm_scan_cuda(a, b):
    """The kernel on CUDA tensors a, b: (B, L, D) float32, contiguous, on one
    device.  Returns h (B, L, D) float32."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.device != a.device:
            raise ValueError(f"ssm_scan kernel: {name} must be float32 on {a.device}, "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan kernel: {name} must be contiguous")
    B, L, D = a.shape
    if not (0 < B <= 65535 and 0 < L < 2 ** 31 and D > 0):
        raise ValueError(f"ssm_scan kernel: shape {tuple(a.shape)} needs "
                         "0 < B <= 65535, L >= 1, D >= 1")
    h = torch.empty_like(a)
    fn = _build.function("repro_ssm_scan", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, L, D,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ssm_scan kernel launch")
    linear_scan.launches += 1
    return h


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
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        g = _scan(a_next.flip(1), G.to(a.dtype).flip(1)).flip(1)
        if a.device.type == "cuda":
            linear_scan.backward_launches += 1
        h_prev = torch.zeros_like(h)
        h_prev[:, 1:] = h[:, :-1]
        return g * h_prev, g


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
