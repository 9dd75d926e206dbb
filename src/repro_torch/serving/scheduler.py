"""Slot scheduler for continuous-batching ASD serving (the port's own copy
of the JAX package's ``serving/scheduler.py``, which imports no JAX; the
port imports nothing of that package).

The engine owns a fixed number of *slots* — lanes of the vmapped per-round
speculation program.  The scheduler is the host-side bookkeeping around them:

  submitted --> queued --policy admit--> active (slot i) --chain done--> retired
                   |                        ^                               |
                   +-- admission control    +------- slot i freed ----------+
                       may DROP (deadline
                       already unmeetable)

Admission happens at SUPERSTEP boundaries only (the device program is SPMD
over slots and runs ``rounds_per_sync`` fused rounds per dispatch, so a slot
can only change occupants between dispatches; a chain finishing mid-superstep
freezes in place until the boundary harvest).  A chain that accepts its full
speculation window retires early and frees its slot for the next queued
request instead of blocking the batch until the slowest chain finishes — the
standard continuous-batching move from LLM serving, applied to diffusion
chains.

WHICH queued request takes a freed slot is a pluggable ``SchedulingPolicy``:

  ``FCFS``                            submit order (the default).
  ``Priority``                        highest ``Request.priority`` first.
  ``ShortestExpectedRemainingRounds`` fewest expected speculation rounds
      first, estimated from the request's accept-rate hint (or the engine's
      observed EWMA accept rate) — SJF for diffusion chains: short chains
      stop queueing behind long ones.
  ``DeadlineAware``                   earliest deadline first; with
      ``drop_late`` it rejects requests whose deadline can no longer be met
      given the engine's observed seconds-per-round (SLO admission control).

Policies are host-side and only reorder/filter the queue — the device
program never sees them, so every policy serves bit-identical samples.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections import deque
from typing import Any, List, Optional, Tuple

log = logging.getLogger("repro_torch.serving.scheduler")


@dataclasses.dataclass
class SlotInfo:
    """Host-side record of the request occupying a slot."""

    request: Any
    submit_time: float
    admit_time: float
    admit_round: int  # engine round counter at admission


@dataclasses.dataclass(eq=False)  # identity equality: requests may hold
class QueueEntry:                 # ndarray fields, where __eq__ is ambiguous
    request: Any
    submit_time: float


@dataclasses.dataclass
class AdmissionContext:
    """Engine observables the scheduling policies key on.

    The engine refreshes this at every admission point; estimates degrade
    gracefully (policies fall back to FCFS-ish behavior) when the engine has
    not observed enough traffic yet.
    """

    K: int = 0  # chain length (steps to commit per request)
    theta_max: int = 1  # speculation window cap
    accept_rate: float = 1.0  # engine-level EWMA of observed accept rates
    seconds_per_round: float = 0.0  # observed wall seconds per fused round
    now: float = 0.0
    # packed execution: per-round verification-point budget and the slot
    # batch's current live demand (sum of live windows).  The unpacked
    # engine reports budget == slots * theta_max, so pressure stays sane.
    round_budget: int = 0
    live_demand: int = 0
    # what ONE admission adds to demand: the controller's opening window
    # (<= theta_max; 0 means unknown — price at the cap)
    theta_open: int = 0
    # superstep execution: rounds fused per device dispatch.  Admission and
    # retirement only happen at superstep boundaries, so service times
    # quantize to multiples of this (see expected_service_time) and a freed
    # slot refills up to rounds_per_sync - 1 rounds late.
    rounds_per_sync: int = 1
    # slot overcommit factor (>= 1): how far past the budget's nominal
    # concurrency (round_budget // theta_max full-width chains) the engine
    # wants admission to multiplex.  Only BudgetAware reads it — at 1 the
    # policy keeps live demand within the budget; at c it admits until
    # demand reaches c * budget, trading per-chain window depth for slot
    # occupancy (a queueing win under bursty arrivals).
    overcommit: float = 1.0

    @property
    def budget_pressure(self) -> float:
        """Live verification demand as a fraction of the round budget.
        > 1 means windows are being trimmed by the allocator right now."""
        if self.round_budget <= 0:
            return 0.0
        return self.live_demand / self.round_budget

    def expected_rounds(self, request) -> float:
        """Expected speculation rounds for ``request``: K / E[steps per round]
        under a geometric accept model at the request's (hinted or engine-
        observed) per-slot accept rate."""
        rate = getattr(request, "expected_accept_rate", None)
        if rate is None:
            rate = self.accept_rate
        rate = min(max(float(rate), 0.0), 0.999)
        # E[advance] = sum_{j<theta} rate^j = (1 - rate^theta) / (1 - rate)
        adv = (1.0 - rate ** self.theta_max) / max(1.0 - rate, 1e-3)
        return self.K / max(adv, 1.0)

    def expected_service_time(self, request) -> float:
        """Expected rounds priced in wall seconds, quantized UP to the next
        superstep boundary: a chain that finishes mid-superstep still holds
        its slot (frozen) until the boundary harvest, so the deadline policy
        must budget whole supersteps, not raw rounds."""
        rounds = self.expected_rounds(request)
        R = max(self.rounds_per_sync, 1)
        return math.ceil(rounds / R) * R * self.seconds_per_round


class SchedulingPolicy:
    """Orders the queue at each admission point; may veto admissions."""

    name = "base"
    # True when order() is submit order and admit_ok() never vetoes: the
    # scheduler then admits via O(1) popleft instead of sort-and-filter
    fifo_fast_path = False

    def order(self, queue: List[QueueEntry], ctx: AdmissionContext) -> List[QueueEntry]:
        return list(queue)

    def admit_ok(self, entry: QueueEntry, ctx: AdmissionContext) -> bool:
        return True

    def admit_quota(self, n_free: int, ctx: AdmissionContext) -> int:
        """How many of the ``n_free`` slots to fill this round.  Unlike an
        ``admit_ok`` veto (which DROPS a request), an unused quota leaves the
        request queued for a later round — the budget-pressure deferral."""
        return n_free


class FCFS(SchedulingPolicy):
    """First-come-first-served: the queue's own order."""

    name = "fcfs"
    fifo_fast_path = True


class Priority(SchedulingPolicy):
    """Highest ``Request.priority`` first; FCFS within a priority level."""

    name = "priority"

    def order(self, queue, ctx):
        return sorted(
            queue,
            key=lambda e: (
                -float(getattr(e.request, "priority", 0.0) or 0.0),
                e.submit_time,
            ),
        )


class ShortestExpectedRemainingRounds(SchedulingPolicy):
    """SJF on expected speculation rounds (accept-rate-informed)."""

    name = "serr"

    def order(self, queue, ctx):
        return sorted(
            queue,
            key=lambda e: (ctx.expected_rounds(e.request), e.submit_time),
        )


class DeadlineAware(SchedulingPolicy):
    """Earliest-deadline-first + optional SLO admission control.

    Requests without a deadline sort last (best effort).  With ``drop_late``,
    a request whose estimated completion ``now + queue-position-agnostic
    service estimate`` already exceeds its deadline is rejected at admission
    instead of burning a slot it cannot use — the engine records the drop.
    """

    name = "deadline"

    def __init__(self, drop_late: bool = True):
        self.drop_late = drop_late

    def order(self, queue, ctx):
        return sorted(
            queue,
            key=lambda e: (
                getattr(e.request, "deadline", None) is None,
                getattr(e.request, "deadline", None) or 0.0,
                e.submit_time,
            ),
        )

    def admit_ok(self, entry, ctx):
        deadline = getattr(entry.request, "deadline", None)
        if deadline is None or not self.drop_late:
            return True
        if ctx.seconds_per_round <= 0.0:  # no service-time estimate yet
            return True
        return ctx.now + ctx.expected_service_time(entry.request) <= deadline


class BudgetAware(SchedulingPolicy):
    """FCFS admission that defers under verification-budget pressure.

    Packed execution multiplexes a fixed per-round point budget across the
    live windows: admitting a fresh chain (which opens at the controller's
    initial window, typically theta_max) when demand already exceeds
    ``pressure_target * budget`` doesn't add throughput — it trims every
    in-flight chain's window, stretching THEIR rounds while the new chain
    still has to wait for points.  This policy leaves the queue untouched
    until pressure drops below the target, then fills as many slots as the
    remaining headroom covers.  Deferred requests stay queued (never
    dropped), and an idle engine always admits at least one request, so the
    engine cannot stall.

    The engine's ``overcommit`` factor (``AdmissionContext.overcommit``)
    scales the target: at overcommit c the policy admits until live demand
    reaches ``c * pressure_target * budget``, letting ``num_slots`` exceed
    the budget's nominal full-width concurrency (``round_budget //
    theta_max``) — the allocator then multiplexes the admitted chains over
    the fixed budget with trimmed windows instead of leaving slots idle.
    """

    name = "budget"

    def __init__(self, pressure_target: float = 1.0):
        self.pressure_target = pressure_target

    def admit_quota(self, n_free, ctx):
        if ctx.round_budget <= 0:  # unpacked engine without budget info
            return n_free
        target = self.pressure_target * max(
            getattr(ctx, "overcommit", 1.0), 1.0)
        headroom = (target - ctx.budget_pressure) * ctx.round_budget
        # price each admission at the controller's opening window, not the
        # cap — a small-opening controller admits proportionally more
        quota = int(headroom // max(ctx.theta_open or ctx.theta_max, 1))
        if ctx.live_demand <= 0:  # idle engine: always make progress
            quota = max(quota, 1)
        return max(0, min(n_free, quota))


POLICIES = {
    "fcfs": FCFS,
    "priority": Priority,
    "serr": ShortestExpectedRemainingRounds,
    "deadline": DeadlineAware,
    "budget": BudgetAware,
}


def make_policy(name: str, **kwargs) -> SchedulingPolicy:
    """CLI-facing factory: ``make_policy("deadline", drop_late=False)``."""
    try:
        return POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r}; have {sorted(POLICIES)}"
        ) from None


class SlotScheduler:
    """Policy-driven admission of requests into a fixed set of engine slots."""

    def __init__(self, num_slots: int, policy: Optional[SchedulingPolicy] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = num_slots
        self.policy = policy if policy is not None else FCFS()
        self._queue: deque[QueueEntry] = deque()
        self._slots: List[Optional[SlotInfo]] = [None] * num_slots
        self.submitted = 0
        self.admitted = 0
        self.retired = 0
        self.deferred = 0  # admission rounds deferred under budget pressure
        self.queue_depth_peak = 0  # high-watermark of the admission queue
        self.dropped: List[QueueEntry] = []  # drained by the engine

    # -- queue side ---------------------------------------------------------

    def submit(self, request, now: float) -> None:
        self._queue.append(QueueEntry(request, now))
        self.submitted += 1
        if len(self._queue) > self.queue_depth_peak:
            self.queue_depth_peak = len(self._queue)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def drain_dropped(self) -> List[QueueEntry]:
        out, self.dropped = self.dropped, []
        return out

    # -- slot side ----------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def slot_info(self, slot: int) -> Optional[SlotInfo]:
        return self._slots[slot]

    def admit(
        self,
        now: float,
        round_idx: int,
        ctx: Optional[AdmissionContext] = None,
    ) -> List[Tuple[int, Any]]:
        """Fill free slots from the queue in policy order.

        Returns [(slot, request)].  Entries the policy vetoes
        (``admit_ok`` False) are moved to ``self.dropped`` — the engine
        drains and accounts them.
        """
        free = self.free_slots()
        if not free or not self._queue:
            return []
        if ctx is None:
            ctx = AdmissionContext(now=now)
        ctx.now = now
        quota = self.policy.admit_quota(len(free), ctx)
        if quota <= 0:  # deferred: requests stay queued for a later round
            self.deferred += 1
            if log.isEnabledFor(logging.DEBUG):
                log.debug(
                    "admission deferred: %d queued, %d slots free, "
                    "budget pressure %.2f (policy %s)",
                    len(self._queue), len(free), ctx.budget_pressure,
                    self.policy.name)
            return []
        free = free[:quota]
        placed: List[Tuple[int, Any]] = []

        def place(slot: int, entry: QueueEntry) -> None:
            placed.append(self._place(slot, entry, now, round_idx))

        if self.policy.fifo_fast_path:  # hot loop: no copy, sort, or scan
            for slot in free:
                if not self._queue:
                    break
                place(slot, self._queue.popleft())
            return placed

        taken: set = set()
        for entry in self.policy.order(list(self._queue), ctx):
            if not free:
                break
            if not self.policy.admit_ok(entry, ctx):
                taken.add(id(entry))
                self.dropped.append(entry)
                continue
            place(free.pop(0), entry)
            taken.add(id(entry))
        if taken:  # one rebuild pass (entries compare by identity)
            self._queue = deque(
                e for e in self._queue if id(e) not in taken
            )
        return placed

    def follow(
        self,
        now: float,
        round_idx: int,
        placements: List[Tuple[int, Any]],
        dropped_rids: List[Any],
        deferred: bool = False,
    ) -> List[Tuple[int, Any]]:
        """Apply an admission that ``admit`` decided on a replica of this
        scheduler holding the same queue: place the queued request of each
        (slot, rid) of ``placements``, move each of ``dropped_rids`` to
        ``self.dropped``, and return [(slot, request)] as ``admit`` does."""
        if deferred:
            self.deferred += 1
        queued: dict = {}
        for entry in self._queue:
            queued.setdefault(entry.request.rid, []).append(entry)
        taken: set = set()

        def take(rid) -> QueueEntry:
            if not queued.get(rid):
                raise ValueError(f"follow: request {rid} is not queued here")
            entry = queued[rid].pop(0)
            taken.add(id(entry))
            return entry

        placed = []
        for slot, rid in placements:
            if self._slots[slot] is not None:
                raise ValueError(f"follow: slot {slot} is not free here")
            placed.append(self._place(slot, take(rid), now, round_idx))
        self.dropped.extend(take(rid) for rid in dropped_rids)
        self._queue = deque(e for e in self._queue if id(e) not in taken)
        return placed

    def _place(self, slot: int, entry: QueueEntry, now: float, round_idx: int):
        self._slots[slot] = SlotInfo(
            request=entry.request,
            submit_time=entry.submit_time,
            admit_time=now,
            admit_round=round_idx,
        )
        self.admitted += 1
        return slot, entry.request

    def retire(self, slot: int) -> SlotInfo:
        """Free a slot whose chain has finished; returns its record."""
        info = self._slots[slot]
        if info is None:
            raise ValueError(f"retire of empty slot {slot}")
        self._slots[slot] = None
        self.retired += 1
        return info

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)
