"""The sharded front end: shard-local workers behind a request router, each
with its own admission queue, slot sub-batch and verification budget (the
port of the JAX package's ``serving/sharded.py``).

            submit(request)
                  |
               Router            (round-robin / least-loaded / deadline,
                  |               serving/router.py; host only)
        +---------+---------+
        |         |         |
    ShardWorker ShardWorker ShardWorker      serving/worker.py
     queue 0     queue 1     queue 2         a SlotScheduler each
     slots 0     slots 1     slots 2         an ASDChainState batch each
     budget 0    budget 1    budget 2        a round_budget tier each

A worker's packed rounds gather points only across its own slots, and its
queue defers or drops under its own budget pressure.

Two dispatch shapes drive the shards:

  ``dispatch="per-shard"``  each worker replays its own superstep programs
      (the serve loop dispatches every shard before it harvests any), so
      shards may run different budget tiers and superstep lengths.  With
      ``devices=None`` and more than one visible card, shard i lives on
      ``cuda:(i % n)``; on one card every shard does.  The workers on one
      card share one graph pool (``adopt_programs``) and replay on one
      stream: sibling graphs take their transients from the same memory, so
      they must not run at once.
  ``dispatch="fused"``  one program a boundary covers every shard: the JAX
      package's one ``shard_map`` dispatch over a ``slots`` mesh, here one
      captured CUDA graph on one card.  The slot tensors are stacked
      (shards, S_local, ...) and every worker's slot tensors, condition
      rows, allocator weights, budget tier and sync packet are views of the
      stacked ones, so the workers' own code (admission policy, harvest)
      and the fused program address the same memory.  On the card each
      shard's body is captured on a side stream of its own, forked from
      the capturing stream and joined back, so the graph holds one
      independent branch a shard that the card may run together.  The
      boundary costs one replay and one wait however many shards there are.
      One R is common to the shards (worker 0 picks it); the budget is
      common too unless ``round_impl="fused"``, whose per-shard tiers are
      data (a (shards,) tensor filled before each replay).

Exactness: routing and sharding are host scheduling.  A chain's trajectory
depends only on its own state (its key), so a key-carrying request gets the
same bits whatever shard serves it: ``shards=1`` is ``ContinuousASDEngine``
bit for bit, and more shards reproduce the single-shard samples wherever
grants equal demands (unpacked execution, or packed at covering budgets),
where the device computes each point's row independently of the batch it
rides in.  Fused dispatch runs the per-shard bodies, so it equals per-shard
dispatch in bits.

Model parallelism inside a shard (``model_shards`` > 1): where the JAX
engine gives each shard a device group of ``model_shards`` devices, the
port runs the whole front end on every rank of one ``model_group`` (a
``repro_torch.distributed.group`` ``ModelGroup`` of ``model_shards``
ranks): each rank's shards sit on the rank's device, so per-shard and
fused dispatch both work, and every model call's collectives go over the
one group.  It needs explicit ``params`` and ``param_specs`` (each worker
keeps its rank's ``shard_params``) and takes ``collective_payloads`` for
the calibrated collective lanes; the programs run eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.asd import ASDChainState
from repro_torch.device import resolve_device
from repro_torch.programs import SuperstepProgram
from repro_torch.serving.metrics import EngineStats
from repro_torch.serving.router import LeastLoaded, Router
from repro_torch.serving.worker import (Request, ShardWorker, admission_program, inject_noise,
                                        run_admission)

log = logging.getLogger("repro_torch.serving.sharded")

__all__ = ["ShardedASDEngine"]


def _on(device: torch.device):
    """Make ``device`` the current card (its streams, graphs and kernels),
    where a shard lives on a card of its own; else nothing."""
    if device.type == "cuda" and device.index is not None:
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _stacked_fields(states: ASDChainState) -> list:
    return [f.name for f in dataclasses.fields(ASDChainState)
            if getattr(states, f.name) is not None]


class ShardedASDEngine:
    """N shard-local ``ShardWorker``s behind a ``Router``.

    The arguments besides these are the worker's, passed to every worker:

      shards: the number of workers.  ``num_slots`` is the total slot count
        and must divide evenly (each worker gets ``num_slots // shards``).
      model_shards: model parallelism inside a shard: 1, or the world size
        of ``model_group`` (with ``params`` and ``param_specs``, and
        ``model_fn`` a factory ``params -> model_fn``; see the module
        docstring).
      router: picks the shard a submitted request joins (default
        ``LeastLoaded``).
      dispatch: "per-shard" or "fused" (see the module docstring).
        ``round_budget="auto"`` with fused dispatch needs
        ``round_impl="fused"`` (the tiers as data).
      devices: the per-shard device list (per-shard dispatch).  Default:
        ``device`` for every shard, except that with more than one visible
        card and per-shard dispatch shard i goes to ``cuda:(i % n)``.
        Fused dispatch runs on one device.
      model_fn_for: ``device -> model_fn``, for shards on more than one
        card (the weights live on a card); without it ``model_fn`` serves
        every shard, which then must share one device.
      round_budget: the per-shard budget; "auto" re-tiers each shard.
      seed: worker i's serve key is ``PRNGKey(seed + 1000003 * i)`` (worker
        0 keeps ``seed``, so shard 0 matches the single-shard engine);
        requests with a key of their own are unaffected.

    Workers on one device share worker 0's graph pool (``adopt_programs``).
    """

    def __init__(self, model_fn: Callable, schedule, event_shape, num_slots: int = 8, *,
                 shards: int = 1, model_shards: int = 1, router: Optional[Router] = None,
                 dispatch: str = "per-shard", devices: Optional[list] = None, seed: int = 0,
                 model_fn_for: Optional[Callable] = None, **worker_kwargs):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if model_shards < 1:
            raise ValueError(f"model_shards must be >= 1, got {model_shards}")
        group = worker_kwargs.get("model_group")
        world = group.world if group is not None else 1
        if model_shards != world:
            raise ValueError(
                f"model_shards {model_shards} must equal the model group's world ({world}"
                f"{'' if group is not None else ': no model_group given'}): every rank "
                "of a group runs this front end (start them with "
                "repro_torch.distributed.group.run_group)")
        if model_shards > 1 and (worker_kwargs.get("params") is None
                                 or worker_kwargs.get("param_specs") is None):
            raise ValueError(
                "model_shards > 1 needs explicit params AND param_specs "
                "(mp_param_pspecs tree): a factory closure cannot be sharded over a "
                "model group")
        if num_slots % shards:
            raise ValueError(f"num_slots {num_slots} must divide evenly over {shards} shards "
                             "(each worker owns an equal slot sub-batch)")
        if dispatch not in ("per-shard", "fused"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        fused = dispatch == "fused"
        if (fused and worker_kwargs.get("round_budget") == "auto"
                and worker_kwargs.get("round_impl") != "fused"):
            raise ValueError(
                'round_budget="auto" (per-shard budget tiers) requires dispatch="per-shard": '
                "one fused program cannot give shards different static budgets.  Use "
                'round_impl="fused" (budget-as-data) to carry per-shard tiers as data.')
        self.num_shards = shards
        self.num_slots = num_slots
        self.model_shards = int(model_shards)
        self.dispatch = dispatch
        self.router = router if router is not None else LeastLoaded()
        base = resolve_device(worker_kwargs.pop("device", None) or (
            group.device if group is not None else None))
        if group is not None:
            # a rank's shards sit on the rank's device
            if devices is not None and {resolve_device(d) for d in devices} != {base}:
                raise ValueError(f"a model group's shards sit on the rank's device {base}, "
                                 f"got devices {list(map(str, devices))}")
            devices = [base] * shards
        if devices is None:
            n = torch.cuda.device_count() if base.type == "cuda" else 1
            devices = ([torch.device("cuda", i % n) for i in range(shards)]
                       if n > 1 and shards > 1 and not fused else [base] * shards)
        elif len(devices) < shards:
            raise ValueError(f"devices list ({len(devices)}) shorter than shards ({shards})")
        devices = [resolve_device(d) for d in devices[:shards]]
        if fused and len(set(devices)) > 1:
            raise ValueError("fused dispatch runs on one device, got "
                             f"{sorted(map(str, set(devices)))}")
        if model_fn_for is None and len(set(devices)) > 1:
            raise ValueError(f"shards on {len(set(devices))} devices need model_fn_for "
                             "(device -> model_fn): one model_fn's weights live on one card")
        fns = {}
        self.workers: List[ShardWorker] = []
        for i, dev in enumerate(devices):
            if dev not in fns:
                fns[dev] = model_fn if model_fn_for is None else model_fn_for(dev)
            with _on(dev):
                w = ShardWorker(fns[dev], schedule, event_shape,
                                num_slots=num_slots // shards,
                                seed=seed if i == 0 else seed + 1000003 * i, device=dev,
                                shard_id=i, **worker_kwargs)
            # one graph pool for the shards on a device
            donor = next((d for d in self.workers if d.device == dev), None)
            if donor is not None:
                w.adopt_programs(donor)
            self.workers.append(w)
        self.schedule = schedule
        self.theta = self.workers[0].theta
        self.dropped_rids: list[int] = []
        self._wall_time = 0.0
        # the fused dispatch wall a boundary: a front-end lane, on the merged
        # view, never split across the workers' dispatch_s
        self._fused_dispatch_s = 0.0
        self._tracer = worker_kwargs.get("tracer")
        self._routed = np.zeros((shards,), np.int64)
        if fused:
            self._init_fused()
        log.debug("sharded engine up: %d shards x %d slots, dispatch=%s, router=%s",
                  shards, num_slots // shards, dispatch, self.router.name)

    # -- fused dispatch: every shard in one program -------------------------

    def _init_fused(self) -> None:
        """Stack the workers' slot tensors (shards, S_local, ...) and rebind
        each worker's to its views, before any program exists; the same for
        the condition rows, allocator weights, budget tiers and sync
        packet.  The packet's two host buffers are made here, once."""
        ws, w0 = self.workers, self.workers[0]
        dev, n, S = w0.device, self.num_shards, w0.num_slots
        self.device = dev
        stacked = {name: torch.stack([getattr(w._states, name) for w in ws])
                   for name in _stacked_fields(w0._states)}
        self._states = dataclasses.replace(w0._states, **stacked)
        self._conds = (torch.zeros((n, S, w0.d_cond), device=dev) if w0.d_cond else None)
        self._weights = torch.stack([w._weights_dev for w in ws])
        self._tiers = torch.zeros((n,), dtype=w0._budget_dev.dtype, device=dev)
        self._packet_info = torch.zeros((n,) + tuple(w0._packet_info.shape),
                                        dtype=torch.int32, device=dev)
        self._packet_samples = torch.zeros((n,) + tuple(w0._packet_samples.shape), device=dev)
        for i, w in enumerate(ws):
            w._states = dataclasses.replace(w._states,
                                            **{k: v[i] for k, v in stacked.items()})
            if self._conds is not None:
                w._conds = self._conds[i]
            # _set_weight's one-lane writes land in the stacked weights
            w._weights_dev = self._weights[i]
            w._budget_dev = self._tiers[i]
            w._packet_info, w._packet_samples = self._packet_info[i], self._packet_samples[i]
        cuda = dev.type == "cuda"
        self._info_out = [torch.empty(self._packet_info.shape, dtype=torch.int32,
                                      pin_memory=cuda) for _ in range(2)]
        self._samples_out = [torch.empty_like(self._packet_samples) for _ in range(2)]
        self._ready = [torch.cuda.Event() for _ in range(2)] if cuda else [None, None]
        self._packet_turn = 0
        # one side stream a shard: each shard's body is one branch of the graph
        self._streams = [torch.cuda.Stream(dev) for _ in ws] if cuda else None
        self._fused_fns: dict = {}
        self._fused_admit_fns: dict = {}

    def _shard_body(self, w: ShardWorker, R: int, budget) -> None:
        """One shard's part of the fused program: the worker's superstep
        body on its views (the per-shard dispatch's very code)."""
        w._step_slots(R, w._budget_dev if budget == "data" else budget)

    def _make_fused(self, R: int, budget) -> SuperstepProgram:
        ws, streams, dev = self.workers, self._streams, self.device

        def body():
            if streams is None:
                for w in ws:
                    self._shard_body(w, R, budget)
                return
            origin = torch.cuda.current_stream(dev)
            for w, s in zip(ws, streams):
                s.wait_stream(origin)
                with torch.cuda.stream(s):
                    self._shard_body(w, R, budget)
            for s in streams:
                origin.wait_stream(s)

        return SuperstepProgram(body, dev, ws[0]._graph_pool, eager=ws[0]._eager)

    def _get_fused(self, R: int, budget) -> SuperstepProgram:
        # budget-as-data: one program per R serves every shard's tier
        key = (R, "data" if self.workers[0]._budget_as_data else budget)
        prog = self._fused_fns.get(key)
        if prog is None:
            prog = self._fused_fns[key] = self._make_fused(R, key[1])
            assert len(self._fused_fns) <= self.workers[0]._program_bound(), (
                f"fused dispatch built more programs than the ladders allow: "
                f"{sorted(self._fused_fns, key=str)}")
        return prog

    def _get_fused_admit(self, width: int) -> SuperstepProgram:
        """The admission program of ``width`` chains over the stacked batch
        flattened to (shards * S_local) rows (JAX's ``_fused_admit``)."""
        prog = self._fused_admit_fns.get(width)
        if prog is None:
            w0, rows = self.workers[0], self.num_shards * self.workers[0].num_slots
            flat = dataclasses.replace(self._states, **{
                name: getattr(self._states, name).view((rows,) + tuple(
                    getattr(self._states, name).shape[2:]))
                for name in _stacked_fields(self._states)})
            conds = None if self._conds is None else self._conds.view(rows, -1)
            prog = self._fused_admit_fns[width] = admission_program(
                w0, width, flat, conds, w0._graph_pool, w0._eager)
            assert len(self._fused_admit_fns) <= (rows - 1).bit_length() + 1
        return prog

    def _fused_sync_packet(self):
        """The stacked packet, copied into the next of the two buffers."""
        k = self._packet_turn
        self._packet_turn ^= 1
        host, samples, ready = self._info_out[k], self._samples_out[k], self._ready[k]
        host.copy_(self._packet_info, non_blocking=True)
        samples.copy_(self._packet_samples)
        if ready is not None:
            ready.record(torch.cuda.current_stream(self.device))
        return host, ready, samples

    def _dispatch_fused(self):
        """One boundary for every shard: each worker's admission policy, the
        placed chains of all shards in one admission program, then the one
        superstep program."""
        now = time.perf_counter()
        S = self.workers[0].num_slots
        rows, records, reqs, injected = [], [], [], []
        for i, w in enumerate(self.workers):
            for slot, req in w._collect_admissions(now):
                rows.append(i * S + slot)
                records.append(w._admit_record(req))
                reqs.append(req)
                injected.append((w, slot, req))
        if rows:
            width = 1 << (len(rows) - 1).bit_length()
            run_admission(self._get_fused_admit(width), rows, records, reqs,
                          self.workers[0].d_cond)
            with torch.no_grad():
                for w, slot, req in injected:
                    inject_noise(w._states, slot, req, self.device)
        # one R for every shard: worker 0 picks, its siblings follow
        w0 = self.workers[0]
        R, budget = w0._pick_rounds(), w0._pick_budget()
        for w in self.workers[1:]:
            w._rps = R
        prog = self._get_fused(R, budget)
        t0 = time.perf_counter()
        if w0._budget_as_data:
            w0._budget_dev.fill_(budget)
            for w in self.workers[1:]:
                w._budget_dev.fill_(w._pick_budget())
        cold = prog()
        sync = self._fused_sync_packet()
        t1 = time.perf_counter()
        if not cold:
            self._fused_dispatch_s += t1 - t0
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr.add_span("fused_dispatch", t0, t1, pid=self.num_shards, tid=0,
                        pname="frontend", tname="dispatch",
                        args={"R": R, "cold": cold, "budget": budget or 0})
        snapshots = []
        for w in self.workers:
            w.stats.rounds_total += R
            w.stats.supersteps += 1
            snapshots.append(w.stats.rounds_total)
        return sync, snapshots, R, t0, cold

    def _harvest_fused(self, pending) -> None:
        """Wait once for the stacked packet, then run every worker's harvest
        on its slice with one completion stamp; each worker's device_s gets
        its share of the wait."""
        (info_host, ready, samples), snapshots, R, t0, cold = pending
        t_wait = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        done_at = time.perf_counter()
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr.add_span("fused_device_wait", t_wait, done_at, pid=self.num_shards, tid=1,
                        pname="frontend", tname="device", args={"R": R, "cold": cold})
        for i, w in enumerate(self.workers):
            w._harvest(((info_host[i], None, samples[i]), snapshots[i], R, t0, cold),
                       done_at=done_at)
            w.stats.device_s += (done_at - t_wait) / self.num_shards

    # -- views ---------------------------------------------------------------

    @property
    def stats(self) -> EngineStats:
        """The merged cross-shard view (per shard: ``shard_stats``), with the
        fused dispatch lane."""
        m = EngineStats.merged([w.stats for w in self.workers], wall_time=self._wall_time)
        m.fused_dispatch_s += self._fused_dispatch_s
        return m

    @property
    def shard_stats(self) -> List[EngineStats]:
        return [w.stats for w in self.workers]

    @property
    def round_budget(self):
        """Shard 0's current budget tier (per shard: ``workers[i].round_budget``)."""
        return self.workers[0].round_budget

    @property
    def routed_counts(self) -> np.ndarray:
        """Requests routed per shard (a copy)."""
        return self._routed.copy()

    @property
    def _compiled_supersteps(self) -> int:
        """Superstep programs built: the workers' and the fused ones."""
        return (sum(w._compiled_supersteps for w in self.workers)
                + len(getattr(self, "_fused_fns", ())))

    def has_work(self) -> bool:
        return any(w.has_work() for w in self.workers)

    @property
    def draining(self) -> bool:
        return any(w.draining for w in self.workers)

    def begin_drain(self) -> None:
        """Close every shard's admission gate: queued and in-flight requests
        finish, new submissions raise."""
        log.info("sharded engine draining %d shards", self.num_shards)
        for w in self.workers:
            w.begin_drain()

    def health(self) -> List[dict]:
        return [w.health() for w in self.workers]

    def healthz(self) -> dict:
        """The ``/healthz`` document: the worst shard's status wins."""
        shards = self.health()
        status = next((s for s in ("draining", "backpressure")
                       if any(h["status"] == s for h in shards)), "ok")
        return {"status": status, "shards": shards}

    def chain_state(self, shard: int, slot: int) -> ASDChainState:
        """One slot's state, as views (in fused dispatch, views of the
        stacked batch)."""
        return self.workers[shard].chain_state(slot)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, request: Request) -> None:
        if self.draining:
            raise RuntimeError(f"engine is draining: request {request.rid} rejected "
                               "(begin_drain() closed the admission gates)")
        shard = int(self.router.route(request, self.workers))
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"router {self.router.name!r} returned shard {shard} outside "
                             f"[0, {self.num_shards})")
        self._routed[shard] += 1
        now = time.perf_counter()
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr.add_instant("route", now, pid=self.num_shards, tid=2, pname="frontend",
                           tname="router", args={"rid": request.rid, "shard": shard})
        self.workers[shard].scheduler.submit(request, now)

    def step(self) -> bool:
        """One boundary across every shard with work: dispatch all, then
        harvest all.  True while any shard has work."""
        if self.dispatch == "fused":
            if not self.has_work():
                return False
            self._harvest_fused(self._dispatch_fused())
            return self.has_work()
        pending = []
        for w in self.workers:
            if w.has_work():
                with _on(w.device):
                    pending.append((w, w._dispatch_superstep()))
        for w, rec in pending:
            with _on(w.device):
                w._harvest(rec)
        return self.has_work()

    def _synchronize(self) -> None:
        for dev in {w.device for w in self.workers}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def serve(self, requests: List[Request], key=None) -> dict:
        """Submit everything through the router, drive every shard until
        drained, and return {rid: sample}.  Each boundary dispatches every
        working shard's superstep s+1 before it harvests any shard's
        superstep s; a shard with queued requests harvests first, so its
        freed slots refill at this boundary.  With one shard this is
        ``ContinuousASDEngine.serve``."""
        if key is not None:
            # one serve key for every worker: an unkeyed request's key is
            # fold_in(key, rid), whatever shard it lands on
            for w in self.workers:
                w._key = prng.as_key(key, "cpu")
        self.dropped_rids = []
        for w in self.workers:
            w.dropped_rids = []
        t0 = time.perf_counter()
        for r in requests:
            self.submit(r)
        if self.dispatch == "fused":
            pending = None
            while self.has_work() or pending is not None:
                if pending is not None and any(w.scheduler.queue_depth > 0
                                               for w in self.workers):
                    self._harvest_fused(pending)
                    pending = None
                nxt = self._dispatch_fused() if self.has_work() else None
                if pending is not None:
                    self._harvest_fused(pending)
                pending = nxt
        else:
            waiting: dict[int, tuple] = {}
            while self.has_work() or waiting:
                for i, w in enumerate(self.workers):
                    if i in waiting and w.scheduler.queue_depth > 0:
                        with _on(w.device):
                            w._harvest(waiting.pop(i))
                nxt = {}
                for i, w in enumerate(self.workers):
                    if w.has_work():
                        with _on(w.device):
                            nxt[i] = w._dispatch_superstep()
                for i in sorted(waiting):
                    with _on(self.workers[i].device):
                        self.workers[i]._harvest(waiting.pop(i))
                waiting = nxt
        self._synchronize()
        self._wall_time += time.perf_counter() - t0
        out = {}
        for w in self.workers:
            out.update(w.drain_results())
            self.dropped_rids.extend(w.dropped_rids)
            w._refresh_health()
        if log.isEnabledFor(logging.INFO):
            m = self.stats
            log.info("sharded serve drained: %d retired (%d dropped) across %d shards in %d "
                     "supersteps", m.retired, m.dropped, self.num_shards, m.supersteps)
        return out

    def drain_results(self) -> dict:
        out = {}
        for w in self.workers:
            out.update(w.drain_results())
        return out

    def adopt_programs(self, warm) -> "ShardedASDEngine":
        """Share a warm engine's program build (same per-shard statics): a
        ``ShardedASDEngine`` or a bare worker or engine.  A CUDA graph binds
        the slot tensors it was captured on, so what is shared is the graph
        pool (see ``ShardWorker.adopt_programs``); the fused programs
        capture into worker 0's pool, so they share it too.  Call it before
        the first dispatch.  Under a model group the programs are eager and
        there is nothing to share: an engine of another ``model_shards`` or
        shard count is left as it is, as in the JAX engine."""
        donors = warm.workers if hasattr(warm, "workers") else [warm]
        if self.model_shards > 1 and (getattr(warm, "model_shards", 1) != self.model_shards
                                      or getattr(warm, "num_shards", None)
                                      != self.num_shards):
            return self
        for i, w in enumerate(self.workers):
            w.adopt_programs(donors[i % len(donors)])
        return self
