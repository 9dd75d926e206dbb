"""Request routers: which shard's admission queue a request joins (the
port's own copy of the JAX package's ``serving/router.py``, which imports
no JAX).

A sharded deployment (``repro_torch.serving.sharded.ShardedASDEngine``)
runs N shard-local workers, each with its own slot sub-batch, verification
budget and ``SlotScheduler`` queue.  A router only picks a shard index at
submit time: it never reorders a shard's queue (the shard's
``SchedulingPolicy`` does that) and never touches a device program, so
every router serves the same bits for key-carrying requests.

  ``RoundRobin``    cycle the shards in submit order.
  ``LeastLoaded``   the shard with the lowest load (busy slots + queued
      requests, in units of full slot batches); ties go to the lowest
      index.  The default.
  ``DeadlineAware`` deadline-carrying requests go least-loaded; best-effort
      traffic packs onto the busiest shard that still has room (load < 1),
      keeping a shallow shard for the next urgent arrival.

A router sees workers duck-typed: anything with a ``load`` float (0 idle,
1 all slots busy, > 1 queueing) and a ``scheduler``, as
``repro_torch.serving.worker.ShardWorker`` has.
"""

from __future__ import annotations

from typing import Any, Sequence


class Router:
    """Picks the shard whose admission queue a request joins."""

    name = "base"

    def route(self, request: Any, workers: Sequence[Any]) -> int:
        raise NotImplementedError


class RoundRobin(Router):
    """Cycle the shards in submit order."""

    name = "round-robin"

    def __init__(self):
        self._next = 0

    def route(self, request, workers):
        shard = self._next % len(workers)
        self._next = (shard + 1) % len(workers)
        return shard


class LeastLoaded(Router):
    """Lowest load first; ties break to the lowest shard index."""

    name = "least-loaded"

    def route(self, request, workers):
        return min(range(len(workers)), key=lambda i: (workers[i].load, i))


class DeadlineAware(Router):
    """Deadline-carrying requests route least-loaded.  Best-effort ones pack
    onto the most-loaded shard with load < 1, and once every shard is
    saturated fall back to least-loaded."""

    name = "deadline"

    def route(self, request, workers):
        order = sorted(range(len(workers)), key=lambda i: (workers[i].load, i))
        if getattr(request, "deadline", None) is not None:
            return order[0]
        for i in reversed(order):  # most-loaded first
            if workers[i].load < 1.0:
                return i
        return order[0]


ROUTERS = {
    "round-robin": RoundRobin,
    "least-loaded": LeastLoaded,
    "deadline": DeadlineAware,
}


def make_router(name: str, **kwargs) -> Router:
    """``make_router("least-loaded")``; an unknown name raises ValueError."""
    try:
        return ROUTERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown router {name!r}; have {sorted(ROUTERS)}") from None
