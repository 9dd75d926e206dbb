"""Flash attention on the card: wrapper of the CUDA kernel
``csrc/flash_attention.cu``, in the (B, L, H, hd) layout of the JAX
package's ``flash_mha``.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
_flash_kernel``.  The function is bound by operations at the main path's
shape (L = S = 1024, dh = 64); the source note in the ``.cu`` file says what
this first design does about that.  The kernel reads q, k, v through their
strides and masks ragged edges itself, so nothing is padded or transposed.

The plain PyTorch version is ``attention_plain``.  ``flash_mha`` takes it
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``flash_mha.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_int64] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


def _mask(Lq: int, S: int, causal: bool, window: int, seq_k: int, device):
    qi = torch.arange(Lq, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    mask = ki < seq_k
    if causal:
        mask = mask & (ki <= qi)
    if window:
        mask = mask & ((qi - ki) < window)
    return mask


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, true_seq_k: int | None = None):
    """Straightforward softmax attention in float32, the kernel's plain
    version.  q: (B, Lq, H, hd); k, v: (B, S, H, hd) -> (B, Lq, H, hd) in
    q's dtype.  Keys at or past ``true_seq_k`` are masked."""
    Lq, S, hd = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("blhk,bshk->bhls", q.float(), k.float()) / (hd ** 0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = _mask(Lq, S, causal, window, S if true_seq_k is None else true_seq_k,
                 q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhls,bshk->blhk", p, v.float()).to(q.dtype)


def flash_cuda(q, k, v, *, causal: bool, window: int, softcap: float,
               true_seq_k: int):
    """The kernel on CUDA tensors q (B, Lq, H, hd), k, v (B, S, H, hd) of
    one dtype (float32 or bfloat16), each with a contiguous last axis."""
    B, Lq, H, hd = q.shape
    S = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash kernel: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash kernel: {name} needs a contiguous head dim")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel: no kernel for {q.dtype}")
    if tuple(k.shape) != (B, S, H, hd) or tuple(v.shape) != (B, S, H, hd):
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd > 128 or B * H > 65535 or not 0 < true_seq_k <= S:
        raise ValueError(f"flash kernel: hd {hd} > 128, B*H {B * H} > 65535 or "
                         f"true_seq_k {true_seq_k} outside (0, {S}]")
    o = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device)
    fn = _build.function("repro_flash_attention", _ARGTYPES)
    strides = [t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
             B, H, Lq, S, hd, *strides, int(causal), int(window), float(softcap),
             int(true_seq_k), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash attention kernel launch")
    flash_mha.launches += 1
    return o


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, true_seq_k: int | None = None):
    """q: (B, Lq, H, hd); k, v: (B, S, H, hd) (KV already head-repeated).
    Returns (B, Lq, H, hd): the plain version on the CPU, the CUDA kernel on
    the card."""
    seq_k = k.shape[1] if true_seq_k is None else int(true_seq_k)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap, true_seq_k=seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    return flash_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                      true_seq_k=seq_k)


flash_mha.launches = 0

