"""ASD serving engines: batched diffusion-sampling requests.

``ContinuousASDEngine``, the continuous-batching engine: one ``ShardWorker``
plus the host serve loop.

The worker runs device-resident SUPERSTEPS: each runs ``rounds_per_sync``
speculation rounds launched in a row (finished chains stay frozen), and the
host intervenes only at superstep boundaries.  ``serve`` dispatches
superstep s+1 before it harvests superstep s's sync packet, so the host's
bookkeeping overlaps the card's rounds; while requests queue for a slot it
harvests first, so a freed slot refills at the next boundary.  A chain
that commits its last step retires at the next boundary and its slot is
refilled from the queue (FCFS by default, see ``scheduler.py``).  On the
card a superstep is the replay of a captured CUDA graph
(``repro_torch.programs``) that ends by writing the sync packet; what a
harvest reads (the counters and the samples) is copied from it into the
next of two buffers made once, so the next replay, dispatched before that
harvest, cannot overwrite it.

``ASDServingEngine``, the chunked static baseline: requests are padded into
fixed-size batches, and each batch runs the batched sampler to its slowest
chain (padded lanes burn compute), the waste the continuous engine removes.
It keeps its sampler program across batches, so only the first captures.

The sharded front end, N such workers behind a request router, is
``ShardedASDEngine`` (``serving/sharded.py``).
"""

from __future__ import annotations

import logging
import time

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.asd import SamplerLoop, init_chain_state
from repro_torch.core.controller import StaticTheta
from repro_torch.core.schedules import Schedule
from repro_torch.core.sequential import SequentialProgram
from repro_torch.device import resolve_device
from repro_torch.serving.metrics import EngineStats
from repro_torch.serving.worker import Request, ShardWorker

log = logging.getLogger("repro_torch.serving.engine")

_STATIC = StaticTheta()

__all__ = ["ASDServingEngine", "ContinuousASDEngine", "Request"]


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


class ASDServingEngine:
    """Batched exact-sampling server, the chunked static baseline.

    ``mode`` "asd" (speculative) or "ddpm" (the K-step sequential sampler).
    Every chunk is padded to ``batch_size`` chains and run to its slowest
    chain in one batched call of the sampler (a model call over the whole
    chunk each step).  Chain i of a chunk draws from ``split(key,
    batch_size)[i]`` as the JAX package's does: buffer noise and the whole
    trajectory for "asd" (its ``asd_sample`` defaults), the K step noises
    ``normal(key_i, (K, *event))`` for "ddpm"; y0 is zeros, or, where the
    schedule starts from a standard normal, ``normal`` of ``split(keys[0],
    batch_size)[i]``.

    ``model_fn(t, y)``, or ``model_fn(t, y, cond)`` with one condition row
    per point when ``d_cond`` > 0 (a request without ``cond`` gets zeros).
    Runs on ``device`` (None means "cuda")."""

    def __init__(self, model_fn: Callable, schedule: Schedule, event_shape: tuple,
                 theta: int = 8, batch_size: int = 8, mode: str = "asd",
                 eager_head: bool = True, d_cond: int = 0, device=None):
        if mode not in ("asd", "ddpm"):
            raise ValueError(f"unknown mode {mode!r}; have ('asd', 'ddpm')")
        self.device = resolve_device(device)
        self.model_fn = model_fn
        self.schedule = schedule.to(self.device)
        self.event_shape = tuple(event_shape)
        self.theta = theta
        self.batch_size = batch_size
        self.mode = mode
        self.eager_head = eager_head
        self.d_cond = d_cond
        self.stats = EngineStats()
        self._program = None  # the mode's sampler program, built by the first chunk

    def _batch(self, conds: Optional[torch.Tensor], keys: torch.Tensor):
        """(samples, rounds, head calls) of one padded chunk; ``keys``
        (batch_size, 2) on the device.  The first chunk builds the mode's
        program (``SamplerLoop`` or ``SequentialProgram``) on its tensors;
        every later chunk copies its chains in and replays it, as the JAX
        engine's one ``jax.jit`` of its batch function serves every chunk."""
        sched, ev, n = self.schedule, self.event_shape, self.batch_size
        y0 = torch.zeros((n,) + ev, device=self.device)
        if sched.y0_mode == "std_normal":
            y0 = prng.normal(prng.split(keys[0], n), ev)
        with torch.no_grad():
            if self.mode == "asd":
                st = init_chain_state(sched, y0, self.theta, True, _STATIC, key=keys)
                if self._program is None:
                    self._program = SamplerLoop(self.model_fn, sched, st, self.theta,
                                                self.eager_head, True, _STATIC, conds)
                else:
                    self._program.load(st, conds)
                res = self._program.result(self._program.run())
                return res.sample, res.rounds, res.head_calls
            xi = prng.normal(keys, (sched.K,) + ev).transpose(0, 1)
            if self._program is None:
                self._program = SequentialProgram(self.model_fn, sched, y0, xi.contiguous(),
                                                  conds)
            else:
                self._program.load(y0, xi, conds)
            out = self._program.run()
        steps = torch.full((n,), sched.K, dtype=torch.int64)
        return out, steps, steps

    def submit_batch(self, requests: list[Request], key) -> dict[int, np.ndarray]:
        """Pads ``requests`` to batch_size, samples, returns {rid: sample}."""
        t0 = time.perf_counter()
        n = len(requests)
        if n > self.batch_size:
            raise ValueError(f"{n} requests for a batch of {self.batch_size}")
        conds = None
        if self.d_cond:
            rows = np.zeros((self.batch_size, self.d_cond), np.float32)
            for i, r in enumerate(requests):
                if r.cond is not None:
                    rows[i] = r.cond
            conds = torch.from_numpy(rows).to(self.device)
        keys = prng.split(prng.as_key(key, self.device), self.batch_size)
        samples, rounds, heads = self._batch(conds, keys)
        # a copy: the samples are the program's tensors, which the next batch overwrites
        samples = samples.to("cpu", copy=True).numpy()
        self.stats.requests += n
        self.stats.batches += 1
        # the batch runs to its slowest chain: its depth is the max
        self.stats.rounds_total += int(rounds.max())
        self.stats.head_calls_total += int(heads.max())
        self.stats.retired += n
        self.stats.wall_time += time.perf_counter() - t0
        return {r.rid: samples[i] for i, r in enumerate(requests)}

    def serve(self, requests: list[Request], key) -> dict[int, np.ndarray]:
        """Chunked static serving: the queue in chunks of batch_size, each
        from its own split of ``key``."""
        out = {}
        key = prng.as_key(key, "cpu")
        for i in range(0, len(requests), self.batch_size):
            key, sub = prng.split(key, 2).unbind(0)
            out.update(self.submit_batch(requests[i:i + self.batch_size], sub))
        return out
