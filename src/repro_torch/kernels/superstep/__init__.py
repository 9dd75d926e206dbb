"""Kernels B5 and B6: the fused round's gather and its verify-and-commit
(``ops.py``)."""

from repro_torch.kernels.superstep.ops import fused_gather, fused_verify_commit

__all__ = ["fused_gather", "fused_verify_commit"]
