"""The continuous-batching ASD engine: one ``ShardWorker`` plus the host
serve loop.

The worker runs device-resident SUPERSTEPS: each runs ``rounds_per_sync``
speculation rounds launched in a row (finished chains stay frozen), and the
host intervenes only at superstep boundaries.  ``serve`` dispatches
superstep s+1 before it harvests superstep s's sync packet, so the host's
bookkeeping overlaps the card's rounds; while requests queue for a slot it
harvests first, so a freed slot refills at the next boundary.  A chain
that commits its last step retires at the next boundary and its slot is
refilled from the queue (FCFS by default, see ``scheduler.py``).

The chunked static engine (``ASDServingEngine``) and the sharded front end
are not ported yet.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.serving.worker import Request, ShardWorker

log = logging.getLogger("repro_torch.serving.engine")

__all__ = ["ContinuousASDEngine", "Request"]


class ContinuousASDEngine(ShardWorker):
    """Slot-based continuous-batching ASD server on one device.  The
    constructor is the worker's (``repro_torch.serving.worker``)."""

    def submit(self, request: Request) -> None:
        if self.draining:
            raise RuntimeError(
                f"engine is draining: request {request.rid} rejected "
                "(begin_drain() closed the admission gate)")
        self.scheduler.submit(request, time.perf_counter())

    def step(self) -> bool:
        """Admit, run ONE superstep over all slots, harvest it.  Returns True
        while work is queued or in flight."""
        if not self.scheduler.has_work():
            return False
        self._harvest(self._dispatch_superstep())
        return self.scheduler.has_work()

    def serve(self, requests: list[Request], key=None) -> dict[int, np.ndarray]:
        """Submit everything, drive supersteps until drained, and return
        {rid: sample}.  ``key`` replaces the serve key that requests without
        a key of their own are derived from."""
        if key is not None:
            self._key = prng.as_key(key, "cpu")
        self.dropped_rids = []
        t0 = time.perf_counter()
        for r in requests:
            self.submit(r)
        pending = None
        while self.scheduler.has_work() or pending is not None:
            if pending is not None and self.scheduler.queue_depth > 0:
                # someone waits for a slot: harvest first, so the dispatch
                # below admits into the slots superstep s freed
                self._harvest(pending)
                pending = None
            nxt = self._dispatch_superstep() if self.scheduler.has_work() else None
            if pending is not None:
                self._harvest(pending)  # overlaps the superstep in flight
            pending = nxt
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.wall_time += time.perf_counter() - t0
        self._refresh_health()
        log.info("shard %d serve drained: %d retired (%d dropped) in %d supersteps",
                 self.shard_id, self.stats.retired, self.stats.dropped,
                 self.stats.supersteps)
        return self.drain_results()
