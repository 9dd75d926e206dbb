"""Budget allocators: split a fixed per-round verification-point budget
across the live speculation windows of a slot batch.

An allocator is a frozen dataclass whose ``allocate`` runs on the device,
inside the packed round, with no read on the host.  Given per-slot demands
``d_s`` (the live verification points ``min(theta_live, K - a)``, 0 for
retired slots) and an integer budget ``B``, it returns integer grants with

  0 <= g_s <= d_s,   sum(g_s) <= B,
  g_s == d_s everywhere whenever sum(d_s) <= B   (the packed round is then
      the unpacked round), and
  g_s >= 1 wherever d_s >= 1, provided B >= #active (engines enforce
      B >= num_slots, so every live chain moves every round).

Three policies, as in the JAX package:

  ``proportional``  g_s ~ B d_s / sum(d), largest-remainder rounding.
  ``waterfill``     max-min fairness: min(d_s, L) at the highest feasible
                    water level L, then the deepest windows topped up.
  ``priority``      proportional in w_s d_s, greedy top-up by weight.

Ties between slots are broken as the JAX package breaks them: float32 rank
keys whose slot-index term can vanish, then a STABLE sort (``jnp.argsort``
is stable; ``torch.argsort`` is only when asked), so the grants are equal
as integers.  ``allocate_sharded`` splits a (shards, S_local) batch row by
row, each shard under its own budget, as the JAX package's ``vmap`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _greedy_fill(grants, headroom, leftover, rank_key):
    """Give each slot, in ascending ``rank_key`` order, as much of its
    ``headroom`` as the remaining ``leftover`` allows."""
    order = torch.argsort(rank_key, stable=True)
    head_sorted = headroom[order]
    before = torch.cumsum(head_sorted, 0) - head_sorted  # exclusive prefix sum
    extra_sorted = torch.minimum(torch.clamp(leftover - before, min=0), head_sorted)
    return grants + torch.zeros_like(grants).scatter(0, order, extra_sorted)


def _index_term(demand: torch.Tensor, scale: float) -> torch.Tensor:
    """arange(S) * scale in float32, as the JAX package computes it."""
    return torch.arange(demand.shape[0], dtype=torch.float32,
                        device=demand.device) * scale


@dataclasses.dataclass(frozen=True)
class BudgetAllocator:
    """Interface: a device function from demands to integer grants."""

    name = "base"

    def allocate(self, demand: torch.Tensor, budget, weights: torch.Tensor):
        """demand (S,) int >= 0; budget an int or a 0-d int tensor;
        weights (S,) float32 > 0 -> grants (S,) int64."""
        raise NotImplementedError

    def allocate_sharded(self, demand: torch.Tensor, budgets: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
        """demand and weights (shards, S_local), budgets (shards,) -> grants
        (shards, S_local): ``allocate`` on each row under its own budget, so
        a shard's grants depend only on its own row.  A loop over the rows
        (every op of ``allocate`` stays as it is: the stable argsort, the
        float32 rank keys); it reads nothing on the host."""
        return torch.stack([self.allocate(d, b, w)
                            for d, b, w in zip(demand, budgets, weights)])


@dataclasses.dataclass(frozen=True)
class ProportionalAllocator(BudgetAllocator):
    """Grants proportional to demand, largest-remainder rounding."""

    name = "proportional"

    def allocate(self, demand, budget, weights):
        demand = demand.to(torch.int64)
        total = demand.sum()
        min1 = torch.clamp(demand, max=1)
        eb = torch.clamp(budget - min1.sum(), min=0)  # budget past the min-1
        ed = demand - min1
        ed_total = torch.clamp(ed.sum(), min=1)
        raw = eb * ed
        share = raw // ed_total
        leftover = eb - share.sum()
        # +1 to the largest fractional remainders, slot index breaking ties
        rank = -(raw % ed_total).to(torch.float32) + _index_term(demand, 1e-6)
        headroom = torch.clamp(ed - share, max=1)
        constrained = min1 + _greedy_fill(share, headroom, leftover, rank)
        return torch.where(total <= budget, demand, constrained)


@dataclasses.dataclass(frozen=True)
class WaterfillingAllocator(BudgetAllocator):
    """Max-min fair grants: min(d_s, L) at the highest feasible level L,
    found by scanning the candidate levels [1, theta_max]."""

    name = "waterfill"
    theta_max: int = 64  # upper bound on any demand

    def allocate(self, demand, budget, weights):
        demand = demand.to(torch.int64)
        total = demand.sum()
        levels = torch.arange(1, self.theta_max + 1, device=demand.device)
        used = torch.minimum(demand[None, :], levels[:, None]).sum(1)
        L = torch.where(used <= budget, levels, 0).max()
        L = torch.clamp(L, min=1)  # B >= #active makes level 1 feasible
        base = torch.minimum(demand, L)
        leftover = torch.clamp(budget - base.sum(), min=0)
        # top up the tallest demands first (deepest windows, ties by slot)
        rank = -demand.to(torch.float32) + _index_term(demand, 1e-6)
        constrained = _greedy_fill(base, demand - base, leftover, rank)
        return torch.where(total <= budget, demand, constrained)


@dataclasses.dataclass(frozen=True)
class PriorityWeightedAllocator(BudgetAllocator):
    """Proportional in weight * demand, greedy top-up by weight."""

    name = "priority"

    def allocate(self, demand, budget, weights):
        demand = demand.to(torch.int64)
        total = demand.sum()
        min1 = torch.clamp(demand, max=1)
        eb = torch.clamp(budget - min1.sum(), min=0)
        ed = demand - min1
        w = torch.clamp(weights.to(torch.float32), min=1e-3)
        wd = w * ed.to(torch.float32)
        share_f = eb * wd / torch.clamp(wd.sum(), min=1e-9)
        share = torch.minimum(torch.floor(share_f).to(torch.int64), ed)
        leftover = torch.clamp(eb - share.sum(), min=0)
        # highest weight first; fractional remainder, then slot index
        rank = (-w * 1e6 - (share_f - torch.floor(share_f))
                + _index_term(demand, 1e-9))
        constrained = min1 + _greedy_fill(share, ed - share, leftover, rank)
        return torch.where(total <= budget, demand, constrained)


ALLOCATORS = {
    a.name: a for a in (
        ProportionalAllocator, WaterfillingAllocator, PriorityWeightedAllocator)
}


def make_allocator(name: str, theta_max: Optional[int] = None,
                   **kwargs) -> BudgetAllocator:
    """``make_allocator("waterfill", theta_max=8)``.  ``theta_max`` (the
    engine's window cap) is accepted for every allocator and passed only to
    those that use it."""
    try:
        cls = ALLOCATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown budget allocator {name!r}; have {sorted(ALLOCATORS)}"
        ) from None
    if theta_max is not None and "theta_max" in {
            f.name for f in dataclasses.fields(cls)}:
        kwargs.setdefault("theta_max", theta_max)
    return cls(**kwargs)
