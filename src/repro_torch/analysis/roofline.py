"""Roofline terms of a cell at the NVIDIA H100's peaks: the port's copy of
the JAX package's ``analysis/roofline.py``.

compute term    = flops_per_chip / peak FLOP/s
memory term     = bytes_per_chip / HBM bandwidth
collective term = 0 on one card

The JAX module reads its flops, bytes and collective bytes from a compiled
XLA program (``cost_analysis`` and a parse of the post-SPMD HLO).  The port
has no such program: ``analyze`` builds a ``Roofline`` from an analytic
``CellCost`` (``repro_torch.analysis.analytic``) and a chip count, and
``memory_stats`` reads a measured step's bytes from ``torch.cuda``.  The
collective term stays 0: the term over a mesh of cards (the payload
schedules of ``models/diffusion.py`` over a link constant) is ROADMAP.md
A13.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.analytic import CellCost

# ---- NVIDIA H100 SXM published peaks (dense), for the card nvidia-smi
# names "NVIDIA H100 80GB HBM3" at a power limit of 700.00 W ----
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, float32 FMAs outside the tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 tensor cores
HBM_BW = 3.35e12  # B/s


def peak_flops(compute_dtype: str) -> float:
    """The least-time rate for work in ``compute_dtype``: bf16's tensor
    cores, or for float32 the faster of FMAs and 3xTF32 (three TF32
    products give float32 accuracy), as ``PERF.md`` bounds float32 kernels."""
    if compute_dtype == "float32":
        return max(PEAK_FLOPS_F32, PEAK_FLOPS_TF32 / 3)
    return PEAK_FLOPS_BF16


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_raw: float
    collective_ring: float
    coll_counts: dict
    coll_per_op: dict

    @property
    def t_compute(self):
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def t_memory(self):
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self):
        # one card has no link: no collective bytes and no link rate
        return 0.0

    @property
    def dominant(self):
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    def bound_time(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_raw_bytes": self.collective_raw,
            "collective_ring_bytes": self.collective_ring,
            "coll_counts": self.coll_counts,
            "coll_per_op": self.coll_per_op,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def analyze(cost: CellCost, n_chips: int) -> Roofline:
    """The per-chip roofline of a global cell's analytic cost spread over
    ``n_chips``: flops and bytes divided evenly, no collective bytes."""
    return Roofline(
        flops_per_chip=cost.flops / n_chips,
        bytes_per_chip=cost.hbm_bytes / n_chips,
        collective_raw=0.0,
        collective_ring=0.0,
        coll_counts={},
        coll_per_op={},
    )


def model_flops(n_params: int, n_tokens: int, kind: str = "train",
                n_active_params: int | None = None) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); 2*N*D for a forward pass."""
    n = n_active_params if n_active_params is not None else n_params
    per_tok = 6 * n if kind == "train" else 2 * n
    return float(per_tok) * n_tokens


def memory_stats(argument_bytes: int, device, base_bytes: int = 0) -> dict:
    """A measured step's memory on ``device``: ``argument_bytes`` (the
    params, optimizer state, caches and inputs it was called with) and the
    temporaries, the peak allocation since the last
    ``torch.cuda.reset_peak_memory_stats`` minus ``base_bytes`` (what was
    allocated before the step's arguments) and minus those.  The CPU keeps
    no peak: its temporaries are None."""
    device = torch.device(device)
    peak = (torch.cuda.max_memory_allocated(device) - base_bytes
            if device.type == "cuda" else None)
    return {
        "argument_bytes": argument_bytes,
        "temp_bytes": None if peak is None else max(0, peak - argument_bytes),
        "peak_bytes": peak,
    }
