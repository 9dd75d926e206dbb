"""Packed ragged verification: fixed-budget work packing for the
continuous ASD engine.

Each round every live chain wants ``min(theta_live, K - a)`` verification
points.  Packing grants each slot ``g_s <= n_valid_s`` points with
``sum g_s <= budget`` (a ``BudgetAllocator``), lays them out with the pack
maps, and verifies them in ONE budget-shaped model call, so small windows
free real compute (``round.py`` says how).  A branched round's demand is
``b_live`` windows a slot, laid out branch-major.
"""

from repro_torch.serving.packing.allocator import (
    ALLOCATORS,
    BudgetAllocator,
    PriorityWeightedAllocator,
    ProportionalAllocator,
    WaterfillingAllocator,
    make_allocator,
)
from repro_torch.serving.packing.plan import (BranchedPackedRoundPlan, PackedRoundPlan,
                                             build_branched_pack_maps, build_pack_maps,
                                             build_sharded_pack_maps)
from repro_torch.serving.packing.round import (packed_round, packed_superstep,
                                              sharded_packed_superstep)

__all__ = [
    "ALLOCATORS",
    "BudgetAllocator",
    "ProportionalAllocator",
    "PriorityWeightedAllocator",
    "WaterfillingAllocator",
    "make_allocator",
    "BranchedPackedRoundPlan",
    "PackedRoundPlan",
    "build_branched_pack_maps",
    "build_pack_maps",
    "build_sharded_pack_maps",
    "packed_round",
    "packed_superstep",
    "sharded_packed_superstep",
]
