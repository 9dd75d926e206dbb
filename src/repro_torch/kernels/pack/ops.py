"""Ragged row gather and scatter on the card: wrappers of the CUDA kernels
in ``csrc/pack.cu``.

Replace the TPU kernels ``repro/kernels/pack/kernel.py::_gather_kernel``
and ``::_scatter_kernel``.  Both are pure data movement, bound by memory;
the source note in ``csrc/pack.cu`` says how the kernels stream the rows
and why the scatter owns destination rows instead of zeroing first.

Contracts (those of the JAX package's ``kernels/pack/ref.py``):

  gather_rows   out[p] = src[idx[p]]; idx in [0, N), may repeat.  The
                packed round's padding lanes carry idx 0 and re-read row 0.
  scatter_rows  out[i] = vals[p] where idx[p] == i, else 0; idx[p] >=
                num_rows drops row p; in-range indices are unique.

Event shapes of any rank collapse to one feature axis D.  The kernels take
int64 indices (torch's index dtype, which the pack maps carry) and mask
ragged M and D themselves: nothing is padded to the TPU's 8-row blocks or
128 lanes.

``gather_rows_plain`` / ``scatter_rows_plain`` are the plain versions; the
public functions take them only for tensors on the CPU, and for CUDA
tensors launch the kernel or raise.  ``gather_rows.launches`` and
``scatter_rows.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

CHUNK = 4096  # floats of a row per block (a multiple of 4)

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (N, *event), idx (M,) -> (M, *event)."""
    return src.index_select(0, idx.to(torch.int64))


def scatter_rows_plain(vals: torch.Tensor, idx: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """vals (M, *event), idx (M,) -> (num_rows, *event); rows with
    idx >= num_rows go to a dump row that is cut off."""
    out = vals.new_zeros((num_rows + 1,) + tuple(vals.shape[1:]))
    out[torch.clamp(idx.to(torch.int64), max=num_rows)] = vals
    return out[:num_rows]


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gather_rows_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel on a (N, D) float32 table and (M,) int64 indices on one
    CUDA device.  Returns (M, D) float32."""
    N, D = src.shape
    (M,) = idx.shape
    _check("gather kernel: src", src, (N, D), torch.float32, src.device)
    _check("gather kernel: idx", idx, (M,), torch.int64, src.device)
    out = torch.empty((M, D), dtype=torch.float32, device=src.device)
    fn = _build.function("repro_gather_rows", _ARGTYPES)
    err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), N, M, D, CHUNK,
             torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "gather kernel launch")
    gather_rows.launches += 1
    return out


def scatter_rows_cuda(vals: torch.Tensor, idx: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """The kernel on (M, D) float32 rows and (M,) int64 indices on one CUDA
    device.  Returns the (num_rows, D) float32 table."""
    M, D = vals.shape
    _check("scatter kernel: vals", vals, (M, D), torch.float32, vals.device)
    _check("scatter kernel: idx", idx, (M,), torch.int64, vals.device)
    out = torch.empty((num_rows, D), dtype=torch.float32, device=vals.device)
    fn = _build.function("repro_scatter_rows", _ARGTYPES)
    err = fn(vals.data_ptr(), idx.data_ptr(), out.data_ptr(), M, num_rows, D,
             CHUNK, torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(err, "scatter kernel launch")
    scatter_rows.launches += 1
    return out


def _rows(a: torch.Tensor) -> torch.Tensor:
    """(R, *event) -> (R, D), D = prod(event) (1 for no event axes)."""
    return a.reshape(a.shape[0], math.prod(a.shape[1:]))


def _on_card(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return True


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[p] = src[idx[p]] for a (N, *event) table and (M,) indices: the
    plain version on the CPU, the CUDA kernel on the card."""
    if not _on_card(src, "gather_rows"):
        return gather_rows_plain(src, idx)
    out = gather_rows_cuda(_rows(src).contiguous(), idx.to(torch.int64).contiguous())
    return out.reshape((idx.shape[0],) + tuple(src.shape[1:]))


def scatter_rows(vals: torch.Tensor, idx: torch.Tensor,
                 num_rows: int) -> torch.Tensor:
    """Route (M, *event) rows to a zeroed (num_rows, *event) table;
    ``idx[p] >= num_rows`` drops row p.  The plain version on the CPU, the
    CUDA kernel on the card."""
    if not _on_card(vals, "scatter_rows"):
        return scatter_rows_plain(vals, idx, num_rows)
    out = scatter_rows_cuda(_rows(vals).contiguous(),
                            idx.to(torch.int64).contiguous(), int(num_rows))
    return out.reshape((int(num_rows),) + tuple(vals.shape[1:]))


gather_rows.launches = 0
scatter_rows.launches = 0
