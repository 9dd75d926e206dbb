"""Pack maps: the slot / step index maps that flatten ragged live windows
into one dense budget-shaped batch.

Given integer grants ``g_s`` (verification points slot s packs this round,
``sum g_s <= budget``), the packed batch lays slots out contiguously:

  packed position p  ->  slot_id[p] = the s with  off_s <= p < off_s + g_s
                         step_id[p] = p - off_s          (0-based in-window)
                         valid[p]   = p < sum(g_s)

Padding positions (p >= total) carry slot_id / step_id 0 and valid False:
the gather re-reads a harmless row for them and the scatter routes them to
the drop row.  Built on the device from the grants (a searchsorted over
their prefix sums), with no read on the host.  A branched round lays each
slot's ``b_r`` windows of ``pts1`` points out branch-major
(``build_branched_pack_maps``).  ``build_sharded_pack_maps`` builds one
shard's maps a row of a (shards, S_local) grant batch, so every ``slot_id``
is shard-local.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PackedRoundPlan:
    """Index maps and grants of one packed verification round (int64)."""

    grants: torch.Tensor  # (S,) points packed per slot
    offsets: torch.Tensor  # (S,) exclusive prefix sums of grants
    total: torch.Tensor  # () live packed points (<= budget)
    slot_id: torch.Tensor  # (budget,) packed position -> slot
    step_id: torch.Tensor  # (budget,) packed position -> in-window step
    valid: torch.Tensor  # (budget,) bool: the position holds a live point

    def row_id(self, theta: int) -> torch.Tensor:
        """Row into the flattened (S * theta) window table; padding
        positions map one past the table (the scatter's drop row)."""
        rows = self.slot_id * theta + self.step_id
        return torch.where(self.valid, rows, self.grants.shape[0] * theta)


def build_pack_maps(grants: torch.Tensor, budget: int) -> PackedRoundPlan:
    """grants (S,) with sum <= budget -> ``PackedRoundPlan`` of width
    ``budget``."""
    grants = grants.to(torch.int64)
    csum = torch.cumsum(grants, 0)
    total = csum[-1]
    offsets = csum - grants
    pos = torch.arange(int(budget), device=grants.device)
    # first slot whose segment end exceeds p; the clip keeps padding in range
    slot_id = torch.searchsorted(csum, pos, right=True)
    slot_id = torch.clamp(slot_id, max=grants.shape[0] - 1)
    valid = pos < total
    step_id = torch.where(valid, pos - offsets[slot_id], 0)
    slot_id = torch.where(valid, slot_id, 0)
    return PackedRoundPlan(grants=grants, offsets=offsets, total=total,
                           slot_id=slot_id, step_id=step_id, valid=valid)


@dataclasses.dataclass
class BranchedPackedRoundPlan:
    """Index maps of one branched packed round (int64): slot s packs
    ``b_r[s] * pts1[s]`` points, branch 0's window first, then branch 1's,
    and so on, so the flat source table is the (S * NB * theta)-row
    branched window stack."""

    pts1: torch.Tensor  # (S,) points packed per branch (the effective window)
    b_r: torch.Tensor  # (S,) branches packed per slot
    offsets: torch.Tensor  # (S,) exclusive prefix sums of pts1 * b_r
    total: torch.Tensor  # () live packed points (<= budget)
    slot_id: torch.Tensor  # (budget,) packed position -> slot
    branch_id: torch.Tensor  # (budget,) packed position -> draft branch
    step_id: torch.Tensor  # (budget,) packed position -> in-window step
    valid: torch.Tensor  # (budget,) bool: the position holds a live point

    def row_id(self, num_branches: int, theta: int) -> torch.Tensor:
        """Row into the flattened (S * NB * theta) branched window table;
        padding positions map one past the table (the scatter's drop row)."""
        rows = (self.slot_id * num_branches + self.branch_id) * theta + self.step_id
        return torch.where(self.valid, rows, self.pts1.shape[0] * num_branches * theta)


def build_branched_pack_maps(pts1: torch.Tensor, b_r: torch.Tensor,
                             budget: int) -> BranchedPackedRoundPlan:
    """pts1, b_r (S,) with sum(pts1 * b_r) <= budget ->
    ``BranchedPackedRoundPlan`` of width ``budget``: the searchsorted of
    ``build_pack_maps`` over the points ``pts1 * b_r``, and position q in a
    slot's segment is branch ``q // pts1``, step ``q % pts1``.  With b_r 1
    everywhere the maps are ``build_pack_maps(pts1, budget)``'s with a zero
    branch lane."""
    pts1, b_r = pts1.to(torch.int64), b_r.to(torch.int64)
    points = pts1 * b_r
    csum = torch.cumsum(points, 0)
    total = csum[-1]
    offsets = csum - points
    pos = torch.arange(int(budget), device=pts1.device)
    slot_id = torch.clamp(torch.searchsorted(csum, pos, right=True), max=pts1.shape[0] - 1)
    valid = pos < total
    q = pos - offsets[slot_id]
    width = torch.clamp(pts1[slot_id], min=1)
    return BranchedPackedRoundPlan(
        pts1=pts1, b_r=b_r, offsets=offsets, total=total,
        slot_id=torch.where(valid, slot_id, 0),
        branch_id=torch.where(valid, torch.div(q, width, rounding_mode="floor"), 0),
        step_id=torch.where(valid, torch.remainder(q, width), 0), valid=valid)


def build_sharded_pack_maps(grants: torch.Tensor, budget: int) -> PackedRoundPlan:
    """grants (shards, S_local) -> a ``PackedRoundPlan`` whose every field
    carries a leading shard axis.  Each shard's maps are built from its own
    grant row alone, so ``slot_id`` lies in [0, S_local): a gather driven by
    them reads only its own shard's window table (the JAX package's ``vmap``
    of ``build_pack_maps``)."""
    plans = [build_pack_maps(g, budget) for g in grants]
    return PackedRoundPlan(**{f.name: torch.stack([getattr(p, f.name) for p in plans])
                              for f in dataclasses.fields(PackedRoundPlan)})
