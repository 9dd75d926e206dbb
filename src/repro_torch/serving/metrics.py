"""Per-request and engine-level serving metrics (the port's own copy of the
JAX package's ``serving/metrics.py``, which imports no JAX), cut to the
fields the single-device worker fills.

``RequestMetrics`` is emitted once per retired chain; the per-chain speculation
counters (rounds, head calls, accepts, proposals) come straight off the
``ASDChainState`` — they are exact because ``asd_round`` freezes a finished
chain's counters while its slot waits to be retired.

``EngineStats`` aggregates across requests and keeps the engine-level counters
(rounds driven, supersteps, the chunked engine's batches, host wall time),
the branched-speculation lanes (``draft_points``, ``branch_accept_depth``,
``wasted_draft_frac``) and the model-parallel collective lanes
(``collective_s`` and its psum / all_to_all split).  ``merged`` is the
sharded front end's cross-shard view, and ``fused_dispatch_s`` its fused
dispatch lane.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import List, Optional, Sequence


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    queue_latency: float  # submit -> admit (s)
    service_time: float  # admit -> retire (s)
    rounds: int  # speculation rounds this chain ran
    head_calls: int  # sequential proposal calls actually made
    model_evals: int  # total model evaluations (all speculation slots)
    accepts: int
    proposals: int
    draft_points: int = 0  # verification points drafted across ALL branches
    deadline: Optional[float] = None  # absolute SLO deadline, if any
    slo_met: Optional[bool] = None  # retired before the deadline? (None: no SLO)

    @property
    def accept_rate(self) -> float:
        return self.accepts / max(self.proposals, 1)

    @property
    def branch_accept_depth(self) -> float:
        """Mean accepted prefix a round: extra draft branches deepen it."""
        return self.accepts / max(self.rounds, 1)

    @property
    def wasted_draft_frac(self) -> float:
        """Fraction of drafted verification points that never committed
        (``1 - accept_rate`` at one branch, where draft_points ==
        proposals); with the accept depth it prices the branches."""
        if self.draft_points <= 0:
            return 0.0
        return 1.0 - self.accepts / self.draft_points

    @property
    def parallel_depth(self) -> int:
        """Sequential model-call depth this chain experienced."""
        return self.rounds + self.head_calls

    @property
    def latency(self) -> float:
        return self.queue_latency + self.service_time

    @property
    def mean_window(self) -> float:
        """Mean live speculation window (verified slots per round) — equals
        theta under StaticTheta, tracks theta_live under adaptive control."""
        return self.proposals / max(self.rounds, 1)


@dataclasses.dataclass
class EngineStats:
    requests: int = 0  # admitted into the engine
    retired: int = 0  # completed and returned
    batches: int = 0  # chunked engine: batches launched
    rounds_total: int = 0  # engine rounds driven (all slots at once)
    supersteps: int = 0  # device dispatches (each runs rounds_per_sync rounds)
    # where the engine's HOST wall time goes, per superstep boundary.  These
    # are host clocks, not a device split: in eager PyTorch the launch call
    # blocks whenever the card's launch queue is full, so a card that is
    # busy shows up largely as dispatch_s (the device idle share comes
    # from a profiler trace, not from here):
    #   dispatch_s   host time in admission and the superstep's launch calls
    #   device_s     host time blocked on the sync packet's ready event
    #   host_sync_s  host time reading the sync packet + retire/metrics
    #                bookkeeping — the per-boundary tax supersteps amortize
    #   fused_dispatch_s  the sharded engine's fused dispatch wall a
    #                boundary (one program covers every shard): a front-end
    #                lane, on the merged view only, never split across the
    #                workers' dispatch_s
    #   collective_s model-parallel collective seconds inside the supersteps
    #                (a per-round probe calibrated on the worker's model
    #                group, times the rounds driven): a view INTO the time
    #                the other lanes already count, never added to them
    #   gather_s     measured seconds inside the boundary's gathers over
    #                the batch ranks of a ``state_sharding`` (the counters'
    #                all-gather, the finished samples to rank 0): a view
    #                into host_sync_s, never added to the lanes
    dispatch_s: float = 0.0
    fused_dispatch_s: float = 0.0
    device_s: float = 0.0
    host_sync_s: float = 0.0
    collective_s: float = 0.0
    # its split by kind: psum all-reduces against all_to_all exchanges,
    # calibrated apart (their bytes a rank moves differ)
    collective_psum_s: float = 0.0
    collective_a2a_s: float = 0.0
    gather_s: float = 0.0
    head_calls_total: int = 0
    model_evals_total: int = 0
    accepts_total: int = 0
    proposals_total: int = 0
    draft_points_total: int = 0  # branched speculation: points drafted (all branches)
    queue_latency_total: float = 0.0
    wall_time: float = 0.0
    dropped: int = 0  # rejected at admission (SLO admission control)
    slo_tracked: int = 0  # retired requests that carried a deadline
    slo_met_count: int = 0
    shard: Optional[int] = None  # worker's shard id
    # health / backpressure signals (the router contract),
    # refreshed by the worker at harvest boundaries and on health() calls:
    queue_depth: int = 0  # requests queued awaiting a slot (live)
    queue_depth_peak: int = 0  # high-watermark of the admission queue
    slot_occupancy: float = 0.0  # busy fraction of the slot batch (live)
    admission_pressure: float = 0.0  # live demand / round budget (live)
    draining: bool = False  # graceful drain: no new admissions accepted
    per_request: List[RequestMetrics] = dataclasses.field(default_factory=list)

    # every additive counter and timer ``merged`` sums across shards;
    # wall_time is not one (concurrent shards share one wall clock)
    _MERGE_SUM = (
        "requests", "retired", "batches", "rounds_total", "supersteps",
        "dispatch_s", "fused_dispatch_s", "device_s", "host_sync_s",
        "collective_s", "collective_psum_s", "collective_a2a_s", "gather_s",
        "head_calls_total", "model_evals_total", "accepts_total", "proposals_total",
        "draft_points_total", "queue_latency_total", "dropped", "slo_tracked",
        "slo_met_count", "queue_depth",
    )

    @classmethod
    def merged(cls, shards: Sequence["EngineStats"],
               wall_time: Optional[float] = None) -> "EngineStats":
        """The cross-shard view: counters and timers sum, per-request
        metrics concatenate, ``wall_time`` is the caller's one front-end
        wall (default the max over shards, which run concurrently).  Queue
        depth sums, its peak and the admission pressure take the worst
        shard, occupancy averages, draining is any.  A request id served by
        two shards raises ValueError: every per-request aggregate would
        count it twice."""
        m = cls()
        for s in shards:
            for f in cls._MERGE_SUM:
                setattr(m, f, getattr(m, f) + getattr(s, f))
            m.per_request.extend(s.per_request)
        counts = Counter(rm.rid for rm in m.per_request)
        dupes = sorted(rid for rid, n in counts.items() if n > 1)
        if dupes:
            raise ValueError(
                f"duplicate request ids across merged shards: {dupes[:10]}"
                f"{' ...' if len(dupes) > 10 else ''} — router-assigned rids must be "
                "globally unique")
        m.wall_time = (wall_time if wall_time is not None
                       else max((s.wall_time for s in shards), default=0.0))
        if shards:
            m.queue_depth_peak = max(s.queue_depth_peak for s in shards)
            m.admission_pressure = max(s.admission_pressure for s in shards)
            m.slot_occupancy = sum(s.slot_occupancy for s in shards) / len(shards)
            m.draining = any(s.draining for s in shards)
        return m

    def observe(self, rm: RequestMetrics) -> None:
        self.retired += 1
        self.head_calls_total += rm.head_calls
        self.model_evals_total += rm.model_evals
        self.accepts_total += rm.accepts
        self.proposals_total += rm.proposals
        self.draft_points_total += rm.draft_points
        self.queue_latency_total += rm.queue_latency
        if rm.slo_met is not None:
            self.slo_tracked += 1
            self.slo_met_count += int(rm.slo_met)
        self.per_request.append(rm)

    def observe_drop(self, n: int = 1) -> None:
        """A request rejected at admission: its deadline was unmeetable."""
        self.dropped += n

    def parallel_depth_per_sample(self) -> float:
        return (self.rounds_total + self.head_calls_total) / max(self.requests, 1)

    def accept_rate(self) -> float:
        return self.accepts_total / max(self.proposals_total, 1)

    def mean_queue_latency(self) -> float:
        return self.queue_latency_total / max(self.retired, 1)

    def throughput(self) -> float:
        """Completed samples per second of engine wall time."""
        return self.retired / self.wall_time if self.wall_time > 0 else 0.0

    def slo_attainment(self) -> float:
        """Fraction of deadline-carrying requests that met their deadline.
        Admission-control drops count as misses (tracked but unmet)."""
        tracked = self.slo_tracked + self.dropped
        if tracked == 0:
            return 1.0
        return self.slo_met_count / tracked

    def mean_window(self) -> float:
        """Verified slots per fused round per chain (mean live theta)."""
        rounds = sum(m.rounds for m in self.per_request)
        return self.proposals_total / max(rounds, 1)

    def branch_accept_depth(self) -> float:
        """Mean accepted prefix a round over retired chains."""
        rounds = sum(m.rounds for m in self.per_request)
        return self.accepts_total / max(rounds, 1)

    def wasted_draft_frac(self) -> float:
        """Drafted verification points that never committed, as a fraction
        of all drafted points (``1 - accept_rate`` at one branch)."""
        if self.draft_points_total <= 0:
            return 0.0
        return 1.0 - self.accepts_total / self.draft_points_total

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Nearest-rank percentiles of queue and completion (submit ->
        retire) latency over retired requests — the open-loop traffic
        numbers.

        Explicit edge handling: an empty engine reports zeros, a single
        sample IS every percentile, and the nearest-rank
        ``rank = ceil(q * n / 100)`` is clamped to [1, n] so q <= 0 or
        q >= 100 can never index out of range."""

        def pcts(values):
            if not values:
                return {f"p{q}": 0.0 for q in qs}
            ordered = sorted(values)
            n = len(ordered)
            out = {}
            for q in qs:
                rank = min(max(math.ceil(q * n / 100.0), 1), n)
                out[f"p{q}"] = ordered[rank - 1]
            return out

        return {
            "queue": pcts([m.queue_latency for m in self.per_request]),
            "completion": pcts([m.latency for m in self.per_request]),
        }

    def mean_parallel_depth(self) -> float:
        """Mean per-request sequential model-call depth (rounds + head calls)."""
        if not self.per_request:
            return 0.0
        return sum(m.parallel_depth for m in self.per_request) / len(self.per_request)

    def timing_breakdown(self) -> dict:
        """Dispatch / device-wait / host-sync split of the engine's HOST wall
        time, absolute and as fractions (see the field notes: not a device
        split).  The denominator is the larger of the recorded wall and the
        accounted total, so the fractions never sum past 1 under the
        dispatch/harvest overlap, and a ``step()``-driven loop with no serve
        wall still gets fractions.  The collective lanes are reported
        against the same denominator but are not part of the accounted
        total: they are a calibrated view into time the lanes already
        count."""
        accounted = (self.dispatch_s + self.fused_dispatch_s + self.device_s
                     + self.host_sync_s)
        denom = max(self.wall_time, accounted, 1e-12)
        return {
            "supersteps": self.supersteps,
            "rounds_per_superstep": self.rounds_total / max(self.supersteps, 1),
            "dispatch_s": self.dispatch_s,
            "fused_dispatch_s": self.fused_dispatch_s,
            "device_s": self.device_s,
            "host_sync_s": self.host_sync_s,
            "collective_s": self.collective_s,
            "collective_psum_s": self.collective_psum_s,
            "collective_a2a_s": self.collective_a2a_s,
            "gather_s": self.gather_s,
            "dispatch_frac": self.dispatch_s / denom,
            "fused_dispatch_frac": self.fused_dispatch_s / denom,
            "device_frac": self.device_s / denom,
            "host_sync_frac": self.host_sync_s / denom,
            "collective_frac": self.collective_s / denom,
            "collective_psum_frac": self.collective_psum_s / denom,
            "collective_a2a_frac": self.collective_a2a_s / denom,
            "gather_frac": self.gather_s / denom,
            # the branch lanes ride along (not time components)
            "branch_accept_depth": self.branch_accept_depth(),
            "wasted_draft_frac": self.wasted_draft_frac(),
        }

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "retired": self.retired,
            "dropped": self.dropped,
            "rounds_total": self.rounds_total,
            "supersteps": self.supersteps,
            "head_calls_total": self.head_calls_total,
            "model_evals_total": self.model_evals_total,
            "accept_rate": self.accept_rate(),
            "mean_window": self.mean_window(),
            "branch_accept_depth": self.branch_accept_depth(),
            "wasted_draft_frac": self.wasted_draft_frac(),
            "mean_parallel_depth": self.mean_parallel_depth(),
            "mean_queue_latency_s": self.mean_queue_latency(),
            "slo_attainment": self.slo_attainment(),
            "wall_time_s": self.wall_time,
            "throughput_rps": self.throughput(),
            "timing": self.timing_breakdown(),
            "health": {
                "queue_depth": self.queue_depth,
                "queue_depth_peak": self.queue_depth_peak,
                "slot_occupancy": self.slot_occupancy,
                "admission_pressure": self.admission_pressure,
                "draining": self.draining,
            },
        }
