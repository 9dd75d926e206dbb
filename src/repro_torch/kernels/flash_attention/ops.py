"""Flash attention on the card: wrapper of two hand-written CUDA kernels,
in the (B, L, H, hd) layout of the JAX package's ``flash_mha``.

Both replace the TPU kernel ``repro/kernels/flash_attention/kernel.py::
_flash_kernel``.  The dtype picks the kernel, explicitly:

- bfloat16 goes to ``csrc/flash_attention_wgmma.cu`` (``flash_wgmma``):
  TMA-fed tiles and wgmma for both products, P split into two bf16 terms.
  It reads q, k, v in place through TMA and refuses, with ``ValueError``,
  a tensor it cannot map: a base address or a batch, row or head stride
  that is not a multiple of 16 bytes, hd not a multiple of 8 or above 256
  (four 64-column chunks: gemma2-9b's head dim), or a grid too large.
- float32 goes to ``csrc/flash_attention.cu`` (``flash_f32``), in one of
  two designs that ``f32_design`` picks by shape: ``"packed"`` where the
  query and key counts are both at most 64 (a (batch, head) pair's whole
  problem is one tile: several pairs a block, float32 FMAs), else
  ``"tensor_core"`` (64-row query tiles, 3xTF32 ``mma.sync`` for both
  products, which holds the float32 gate where one TF32 pass does not).
  It reads q, k and v in place with 16-byte copies where every row starts
  on a 16-byte boundary and 4-byte copies otherwise (``vec_loads``), and
  takes hd up to 128.

The plain PyTorch version is ``attention_plain``.  ``flash_mha`` takes it
only for tensors on the CPU; for CUDA tensors it launches a kernel or
raises.  The kernels have no backward and are launched through ``ctypes``,
so their output is cut from the autograd graph: for CUDA tensors
``flash_mha`` raises where autograd would record through it, instead of
giving q, k and v a silent zero gradient (train through the naive core).
``flash_mha.launches`` counts the launches of both kernels;
``flash_wgmma.launches`` and ``flash_f32.launches`` count each, and
``flash_f32.launches_by_design`` splits the float32 kernel's by design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 12
             + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])
# the wgmma kernel's limits: 16-byte TMA addresses and strides, hd in
# 64-column chunks (at most four), B*H blocks on grid x, 128-row query tiles
# on grid y (64-row above 192 columns); the float32 kernel's hd limit
_TMA_ALIGN = 16
_MAX_HD = 256
_MAX_HD_F32 = 128
_MAX_GRID_X, _MAX_GRID_Y, _BQ, _BQ_SPLIT = 2 ** 31 - 1, 65535, 128, 64
# the float32 kernel's designs (the C entry's design argument is the index)
# and the longest query and key counts the packed design takes; the tensor
# core design's query tiles are 64 rows on grid y
F32_DESIGNS = ("tensor_core", "packed")
PACKED_MAX_SEQ = 64
_BQ_F32 = 64


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


def _check(q, k, v, true_seq_k):
    B, Lq, H, hd = q.shape
    S = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash kernel: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash kernel: {name} needs a contiguous head dim")
    if tuple(k.shape) != (B, S, H, hd) or tuple(v.shape) != (B, S, H, hd):
        raise ValueError(f"flash kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 < true_seq_k <= S:
        raise ValueError(f"flash kernel: true_seq_k {true_seq_k} outside (0, {S}]")


def _launch(entry, q, k, v, strides, causal, window, softcap, true_seq_k, *extra):
    B, Lq, H, hd = q.shape
    o = torch.empty((B, Lq, H, hd), dtype=q.dtype, device=q.device)
    fn = _build.function(entry, _ARGTYPES[:-1] + [ctypes.c_int] * len(extra)
                         + _ARGTYPES[-1:])
    strides = strides + [o.stride(i) for i in (0, 1, 2)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, Lq,
             k.shape[1], hd, *strides, int(causal), int(window), float(softcap),
             int(true_seq_k), *extra, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"flash attention kernel launch ({entry})")
    flash_mha.launches += 1
    return o


def _tma_strides(t, name):
    """The batch, row and head strides of t (elements) for a TMA map, where
    a dimension of size 1 takes its contiguous stride (it is never
    stepped); raises where an address or stride is not a multiple of 16
    bytes."""
    B, L, H, hd = t.shape
    natural = (L * H * hd, H * hd, hd)
    strides = [t.stride(i) if t.shape[i] > 1 else natural[i] for i in (0, 1, 2)]
    item = t.element_size()
    if t.data_ptr() % _TMA_ALIGN or any(s <= 0 or s * item % _TMA_ALIGN for s in strides):
        raise ValueError(f"flash wgmma kernel: {name} at address {t.data_ptr():#x} with "
                         f"strides {tuple(t.stride())} is not 16-byte aligned for TMA")
    return strides


def flash_wgmma(q, k, v, *, causal: bool, window: int, softcap: float,
                true_seq_k: int):
    """The bf16 kernel (TMA + wgmma) on CUDA tensors q (B, Lq, H, hd), k, v
    (B, S, H, hd), each with a contiguous last axis."""
    _check(q, k, v, true_seq_k)
    B, Lq, H, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash wgmma kernel: takes bfloat16, not {q.dtype}")
    if hd % 8 or hd > _MAX_HD:
        raise ValueError(f"flash wgmma kernel: hd {hd} is not a multiple of 8 "
                         f"at most {_MAX_HD}")
    rows = _BQ_SPLIT if hd > 192 else _BQ
    if B * H > _MAX_GRID_X or -(-Lq // rows) > _MAX_GRID_Y:
        raise ValueError(f"flash wgmma kernel: B*H {B * H} or Lq {Lq} over the grid limit")
    strides = [s for name, t in (("q", q), ("k", k), ("v", v))
               for s in _tma_strides(t, name)]
    o = _launch("repro_flash_attention_wgmma", q, k, v, strides, causal, window, softcap,
                true_seq_k)
    flash_wgmma.launches += 1
    return o


def f32_design(Lq: int, S: int) -> str:
    """The float32 kernel's design for Lq query and S key rows: "packed"
    where both are at most PACKED_MAX_SEQ, else "tensor_core"."""
    return "packed" if Lq <= PACKED_MAX_SEQ and S <= PACKED_MAX_SEQ else "tensor_core"


def vec_loads(q, k, v) -> bool:
    """Whether the float32 kernel may copy q, k and v in 16-byte pieces:
    hd a multiple of 4 and every base address and stepped batch, row and
    head stride a multiple of 16 bytes."""
    if q.shape[-1] % 4:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(t.stride(i) % 4 == 0 for i in (0, 1, 2) if t.shape[i] > 1)
               for t in (q, k, v))


def flash_f32(q, k, v, *, causal: bool, window: int, softcap: float,
              true_seq_k: int):
    """The float32 kernel on CUDA tensors q (B, Lq, H, hd), k, v (B, S, H,
    hd), each with a contiguous last axis, in the design ``f32_design``
    picks."""
    _check(q, k, v, true_seq_k)
    B, Lq, H, hd = q.shape
    if q.dtype != torch.float32:
        raise ValueError(f"flash f32 kernel: takes float32, not {q.dtype}")
    if hd > _MAX_HD_F32:
        raise ValueError(f"flash f32 kernel: hd {hd} > {_MAX_HD_F32}")
    design = f32_design(Lq, k.shape[1])
    if B * H > _MAX_GRID_X or (design == "tensor_core" and -(-Lq // _BQ_F32) > _MAX_GRID_Y):
        raise ValueError(f"flash f32 kernel: B*H {B * H} or Lq {Lq} over the grid limit")
    strides = [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)]
    o = _launch("repro_flash_attention_f32", q, k, v, strides, causal, window, softcap,
                true_seq_k, F32_DESIGNS.index(design), int(vec_loads(q, k, v)))
    flash_f32.launches += 1
    flash_f32.launches_by_design[design] += 1
    return o


def wgmma_launch_info(hd: int) -> dict:
    """The wgmma kernel's launch configuration for head dim ``hd`` (its
    instance has ceil(hd / 64) chunks): query rows and keys per tile,
    threads, dynamic shared memory bytes, compiled registers and local
    (spill) bytes a thread."""
    fn = _build.function("repro_flash_attention_wgmma_info",
                         [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 6)
    out = [ctypes.c_int() for _ in range(6)]
    _build.check(fn(hd, *out), "flash wgmma kernel attributes")
    return dict(zip(("query_rows", "keys_per_tile", "threads", "dynamic_smem_bytes",
                     "registers", "local_bytes"), (v.value for v in out)))


_KERNELS = {torch.bfloat16: flash_wgmma, torch.float32: flash_f32}


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, true_seq_k: int | None = None):
    """q: (B, Lq, H, hd); k, v: (B, S, H, hd) (KV already head-repeated).
    Returns (B, Lq, H, hd): the plain version on the CPU; on the card the
    wgmma kernel for bfloat16, the float32 kernel (``flash_f32``) for
    float32."""
    seq_k = k.shape[1] if true_seq_k is None else int(true_seq_k)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap, true_seq_k=seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_mha: the CUDA kernels have no backward; autograd is "
                           "recording through q, k or v (train with attn_impl='naive', "
                           "or call under torch.no_grad())")
    kernel = _KERNELS.get(q.dtype)
    if kernel is None:
        raise ValueError(f"flash_mha: no kernel for {q.dtype}")
    return kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                  true_seq_k=seq_k)


flash_mha.launches = 0
flash_wgmma.launches = 0
flash_f32.launches = 0
flash_f32.launches_by_design = dict.fromkeys(F32_DESIGNS, 0)

