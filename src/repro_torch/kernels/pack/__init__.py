"""Kernels B3 and B4: row gather and row scatter (``ops.py``)."""

from repro_torch.kernels.pack.ops import gather_rows, scatter_rows

__all__ = ["gather_rows", "scatter_rows"]
