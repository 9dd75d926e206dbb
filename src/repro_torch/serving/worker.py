"""Serving worker on one device: the device-side core of the continuous ASD
engine.

A ``ShardWorker`` owns what one shard of a deployment needs:

  * a slot batch of chains (one ``ASDChainState`` with a leading slot axis)
    on its device,
  * the superstep that drives it: ``rounds_per_sync`` rounds launched in a
    row with no read on the host (``asd_superstep`` unpacked,
    ``packed_superstep`` packed or fused),
  * the boundary sync packet (retire flags, counters and samples), which
    each superstep program writes into tensors the worker owns and the
    host copies into one of two buffers made once (pinned host memory for
    the counters, one transfer a superstep),
  * its admission programs, one per power-of-two width: a boundary's new
    chains initialised and written into their slots in one program,
  * its own ``SlotScheduler`` admission queue and ``EngineStats``, and
  * the budget state (per-slot priority weights, the live-demand EWMA and,
    with ``round_budget="auto"``, the power-of-two budget tier).

Where the JAX package donates the slot pytree to a jitted superstep cached
per ``(R, budget)``, the port keeps one ``SuperstepProgram``
(``repro_torch.programs``) per key: on the card a captured CUDA graph,
replayed once a superstep, on the CPU the same body run eagerly.  The slot
tensors are made once and never rebound: an admission program writes new
chains' rows into them and a superstep writes every round field back into
them (the keys and noise buffers are never copied), so a graph replays on
the addresses it was captured on.  The fused round's budget tier is a 0-d
device tensor filled before each call, so one program a R serves every
tier, as the JAX worker's budget-as-data does.  The JAX package's
``donate``, ``pipelined``, ``pack_impl`` and ``grs_impl`` have no
counterpart: the device picks the plain versions (CPU) or the kernels
(CUDA).  The sharded front end (``serving/sharded.py``) runs N workers
behind a router; its fused dispatch binds their slot tensors to views of
one stacked batch.

Model parallelism: where the JAX worker takes ``model_mesh`` (its device
group's ``"model"`` axis) and wraps every superstep in ``shard_map``, the
port's takes ``model_group`` (a ``repro_torch.distributed.group``
``ModelGroup``): one process a rank, every rank running this same worker
on the same requests, and the model function's collectives the only
traffic between them.  It requires explicit ``params`` and
``param_specs`` and keeps this rank's ``shard_params`` of them;
``collective_payloads`` (``mp_collective_payloads``) calibrates the
``collective_*`` lanes of ``EngineStats`` at init.  The group's
collectives are staged through the host, which no CUDA graph can capture,
so its programs run eagerly (``SuperstepProgram(eager=True)``).  Rank 0
alone runs the admission policy, on its own clock and deadlines, and the
other ranks apply what it placed and dropped, so the ranks stay in
lockstep.

Data-parallel slots: where the JAX worker places its slot pytree by
``state_sharding`` (``chain_state_shardings(mesh)``: the slot axis over the
mesh's batch axes), the port's takes the ``ChainStateSharding`` of a mesh
of ranks whose ``model`` axis is 1 (``repro_torch.distributed.sharding``).
Every rank runs this worker with the whole weights and the same
``SlotScheduler`` over all ``num_slots`` slots, but its slot tensors,
sync packet, allocator weights and admission programs hold its own block
of rows (``slot_rows``); the dummy chains take their rows of
``split(PRNGKey(seed), num_slots)``, so each block equals the one-rank
worker's rows.  An unpacked round touches each slot alone, so a superstep
holds no collective and stays a captured graph.  The ranks meet at the
boundary only: rank 0 decides admission as under a model group (each rank
then admits the placed slots of its block), every harvest all-gathers the
(9, rows) counters in rank order, so every rank's host reads the (9, S)
packet of the one-rank worker (retirement, demand, EWMAs, auto
``rounds_per_sync``, health and ``EngineStats`` agree with no other
traffic), and at a boundary where slots finished their samples go to rank
0, whose ``drain_results`` holds every request's sample (another rank's
holds those of its block).  The gathers' seconds are the measured
``gather_s`` lane of ``EngineStats``.  Packed rounds over several batch
ranks (ROADMAP.md A13 item 11) raise.

A serve mesh's ``model`` axis: ``state_sharding`` with the
``model_group`` of the same mesh (``ChainStateSharding.model_group``) and
``params`` with ``param_specs`` the mesh's layout (``ServeLayout.specs``):
the worker keeps ``shard_params`` of them over the mesh, and the model
function (the factory's, typically reading ``ServeLayout.at_use`` at each
call) runs over the model group.  Each model rank of a batch block holds
the same slot rows and steps them the same way; its programs run eagerly,
rank 0 of the whole mesh decides admission, and each model rank takes its
own batch gathers (over the batch ranks of its model coordinate).  At
every boundary, under any model group, the ranks of the group compare
their (9, S) counters, and a rank whose counters differ in any bit raises:
the ranks of a block never diverge silently.  A ``model_group`` from
elsewhere beside ``state_sharding`` (the sharded front end or the model
flags beside a mesh, ROADMAP.md A13 item 12) raises.

Every chain draws from its key as the JAX worker's does: a request's own
``key``, or else ``fold_in(serve key, rid)`` (the serve key is
``PRNGKey(seed)`` until ``serve(key=...)`` replaces it), split once for y0
when the request brings none.  ``noise_mode="counter"`` keeps two keys a
chain in place of the (K+theta+1)-step buffers.  Keys are split on the
host and copied to the device, and each y0 is drawn there, outside the
admission program (as the JAX worker draws them outside its jit), so
admission reads nothing back from the device.

Budget auto-tiering (``round_budget="auto"``, packed execution, with
``budget_hysteresis``), auto ``rounds_per_sync``, ``overcommit`` and the
``tracer``'s boundary spans follow the JAX worker rule for rule.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.asd import (ASDChainState, asd_superstep, chain_sample,
                                  init_chain_state)
from repro_torch.core.controller import (BranchController, StaticBranches, StaticTheta,
                                         ThetaController)
from repro_torch.core.schedules import Schedule
from repro_torch.core.sequential import init_y0
from repro_torch.device import resolve_device
from repro_torch.distributed.group import MeshGroups
from repro_torch.distributed.sharding import (ChainStateSharding,
                                              measure_collective_seconds_by_kind,
                                              shard_params)
from repro_torch.programs import SuperstepProgram
from repro_torch.serving.metrics import EngineStats, RequestMetrics
from repro_torch.serving.packing import (WaterfillingAllocator, packed_superstep)
from repro_torch.serving.scheduler import (AdmissionContext, SchedulingPolicy,
                                           SlotScheduler)

log = logging.getLogger("repro_torch.serving.worker")

# sync-packet rows: the (9, S) int32 array each superstep leaves beside the
# new slot state
_SYNC_ROWS = ("a", "theta_live", "rounds", "head_calls", "model_evals",
              "accepts", "proposals", "b_live", "draft_points")

# the power-of-two ladder auto rounds_per_sync picks from
_AUTO_MAX_R = 16


@dataclasses.dataclass
class Request:
    """A sampling request.  ``key`` (2,) is the chain's PRNG key (a JAX key
    as a numpy uint32 array will do); without one the worker derives it
    from (serve key, rid).  In buffer mode ``u_buf`` (K+theta+1,) and
    ``xi_buf`` (K+theta+1, *event) may inject the chain's noise instead of
    drawing it from the key."""

    rid: int
    cond: Optional[np.ndarray] = None  # (d_cond,) or None
    key: Optional[Any] = None  # per-request PRNG key (else derived)
    u_buf: Optional[Any] = None  # array or tensor (K+theta+1,)
    xi_buf: Optional[Any] = None  # array or tensor (K+theta+1, *event)
    y0: Optional[np.ndarray] = None  # explicit start state (else init_y0)
    priority: float = 0.0  # Priority policy: higher admits first
    deadline: Optional[float] = None  # absolute SLO deadline (perf_counter s)
    expected_accept_rate: Optional[float] = None  # SERR/deadline hint


def _pow2_ladder(lo: int, hi: int) -> tuple:
    """Power-of-two rungs from the smallest power of two >= lo, topped by
    ``hi`` itself (the covering budget) where the next would overshoot."""
    tier = 1
    while tier < lo:
        tier *= 2
    ladder = [min(tier, hi)]
    while ladder[-1] < hi:
        ladder.append(min(ladder[-1] * 2, hi))
    return tuple(ladder)


def _as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(device, dtype)


def admission_program(w: "ShardWorker", width: int, states: ASDChainState,
                      conds: Optional[torch.Tensor], pool, eager: bool = False
                      ) -> SuperstepProgram:
    """The admission program of ``width`` chains with worker ``w``'s
    statics: ``init_chain_state`` over the staged y0 rows and keys, every
    field written into ``states`` at the staged row indices, and the staged
    condition rows into ``conds``.  Its staging tensors are ``prog.stage``.
    The worker passes its own slot tensors; the sharded engine's fused
    dispatch passes the stacked batch flattened to (shards * S_local) rows."""
    dev = w.device
    stage = dict(y0=torch.zeros((width,) + w.event_shape, device=dev),
                 keys=torch.zeros((width, 2), dtype=torch.int64, device=dev),
                 slots=torch.zeros((width,), dtype=torch.int64, device=dev))
    if w.d_cond:
        stage["conds"] = torch.zeros((width, w.d_cond), device=dev)
    schedule, theta, keep, controller = w.schedule, w.theta, w.keep_trajectory, w.controller
    noise_mode, nb, bctl = w.noise_mode, w.num_branches, w.branch_controller

    def body():
        with torch.no_grad():
            new = init_chain_state(schedule, stage["y0"], theta, keep, controller,
                                   key=stage["keys"], noise_mode=noise_mode,
                                   num_branches=nb, branch_controller=bctl)
            # a padded lane repeats the first record: the same rows written
            # twice into one slot
            for f in dataclasses.fields(ASDChainState):
                rows = getattr(new, f.name)
                if rows is not None:  # counter mode holds no buffers
                    getattr(states, f.name).index_copy_(0, stage["slots"], rows)
            if "conds" in stage:
                conds.index_copy_(0, stage["slots"], stage["conds"])

    prog = SuperstepProgram(body, dev, pool, eager=eager)
    prog.stage = stage
    return prog


def run_admission(prog: SuperstepProgram, rows: list, records: list, reqs: list,
                  d_cond: int) -> None:
    """Stage the (key, y0) ``records`` of ``reqs`` for the rows ``rows``,
    padded to the program's width by repeating the first, and run it."""
    stage = prog.stage
    width = stage["slots"].shape[0]
    pad = width - len(rows)
    with torch.no_grad():
        torch.stack([y0 for _, y0 in records] + [records[0][1]] * pad, out=stage["y0"])
        stage["keys"].copy_(torch.stack([key for key, _ in records] + [records[0][0]] * pad),
                            non_blocking=True)
        stage["slots"].copy_(torch.tensor(rows + rows[:1] * pad), non_blocking=True)
        if d_cond:
            conds = np.zeros((width, d_cond), np.float32)
            for i, req in enumerate(reqs + reqs[:1] * pad):
                if req.cond is not None:
                    conds[i] = req.cond
            stage["conds"].copy_(torch.from_numpy(conds), non_blocking=True)
        prog()


def inject_noise(states: ASDChainState, slot: int, req: "Request", device) -> None:
    """Write the noise a request injects (buffer mode) over its slot's rows,
    after its admission program."""
    for name in ("u_buf", "xi_buf"):
        if getattr(req, name) is not None:
            getattr(states, name)[slot] = _as_tensor(getattr(req, name), device)


class ShardWorker:
    """One shard's slot batch, superstep and admission queue.

    Args:
      model_fn: ``model_fn(t, y)`` over any leading batch of points, or,
        when ``d_cond > 0``, ``model_fn(t, y, cond)`` with one (d_cond,)
        condition row per point.  Built once (``make_sl_model_fn`` casts the
        weights when it is made), and every model call of a round is one
        batched call.  With ``params``: a factory ``params -> model_fn``
        (the JAX worker's ``model_fn_factory``), called once with this
        rank's share of them.
      schedule: the affine step schedule shared by all requests.
      event_shape: per-chain sample shape.
      num_slots: chains stepped together.
      theta: speculation window cap theta_max.
      noise_mode: "buffer" (each chain's noise drawn at admission into
        (K+theta+1)-step buffers) or "counter" (drawn a round at a time
        from the chain's two keys).
      keep_trajectory: keep each chain's whole trajectory (else the live
        window only).
      controller: per-chain window controller (default StaticTheta).
      num_branches: branched speculation cap B: each round rolls up to B
        draft branches a chain from the same proposal output and commits
        the longest accepted prefix (1: the single-draft round).  Packed
        demand is ``b_live * min(theta_live, K - a)`` a slot, so the
        covering budget, the budget ladder and the default allocator's
        ``theta_max`` scale by B.
      branch_controller: per-chain live branch count (default
        StaticBranches: always the cap).
      policy: admission policy of the queue (default FCFS).
      execution: "unpacked" (theta-shaped windows per slot) or "packed"
        (each round verifies only the live points, at most ``round_budget``).
      round_budget: packed points per round (>= num_slots; default slots *
        theta, never binding), or "auto" (a power-of-two tier re-picked at
        each boundary from the live-demand EWMA, with hysteresis).
      allocator: ``BudgetAllocator`` (default waterfilling).
      round_impl: "packed" or "fused" (packed execution only; the budget
        tier is then data and the pack width is the ladder's top).
      rounds_per_sync: rounds per superstep R, or "auto".
      overcommit: admission multiplexing factor (>= 1): ``BudgetAware``
        admits until live demand reaches overcommit * round_budget.
      budget_hysteresis: the auto budget drops a rung only once the demand
        EWMA sits at or below this fraction of the rung below.
      device: where the slot batch lives (None means "cuda").
      tracer: optional ``repro_torch.serving.obs.TraceRecorder``: the
        boundary spans (dispatch, device wait, harvest, and under a model
        group the estimated collective span) and each request's queued and
        request spans, from the host clock readings the stats take anyway.
      model_group: a ``ModelGroup`` whose every rank runs this worker: the
        verify runs model-parallel over it (see the module docstring).
        ``device`` defaults to the group's.
      params, param_specs: the whole params and their ``mp_param_pspecs``
        layout (required with ``model_group``); the worker keeps
        ``shard_params`` of them for its rank.
      collective_payloads: per-point collective bytes of one model call,
        ``{"psum": [...], "all_to_all": [...]}`` (``mp_collective_payloads``):
        calibrates the collective lanes at init, over ``budget_cap + (1 + B) * slots``
        points a packed round, ``slots * (theta * B + 1)`` an unpacked one.
      state_sharding: a ``chain_state_shardings(mesh)`` layout: this rank
        holds its block of the slots (see the module docstring); unpacked
        execution only where the mesh has more than one batch rank.  A
        ``model_group`` beside it must be its ``model_group`` (the mesh's
        model axis), and the params are then sharded over the mesh.
        ``device`` defaults to the mesh's.
    """

    def __init__(self, model_fn: Callable, schedule: Schedule, event_shape: tuple,
                 num_slots: int = 8, theta: int = 8, d_cond: int = 0,
                 eager_head: bool = True, noise_mode: str = "buffer",
                 keep_trajectory: bool = False,
                 seed: int = 0, controller: Optional[ThetaController] = None,
                 num_branches: int = 1,
                 branch_controller: Optional[BranchController] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 execution: str = "unpacked", round_budget=None, allocator=None,
                 round_impl: str = "packed", rounds_per_sync=1,
                 overcommit: float = 1.0, budget_hysteresis: float = 0.75,
                 device=None, shard_id: int = 0, tracer=None, model_group=None,
                 params=None, param_specs=None, collective_payloads=None,
                 state_sharding=None):
        if state_sharding is not None:
            if not isinstance(state_sharding, ChainStateSharding):
                raise ValueError(f"state_sharding {state_sharding!r}: a "
                                 "chain_state_shardings(mesh) layout over a mesh of ranks")
            if model_group is not None and model_group is not state_sharding.model_group:
                raise ValueError("state_sharding with a model_group of another mesh: "
                                 "data-parallel slots beside shards or a model group of "
                                 "their own are ROADMAP.md A13 item 12")
            if execution == "packed" and state_sharding.ranks > 1:
                raise ValueError(
                    "state_sharding over several batch ranks with execution='packed': "
                    "packed rounds over batch ranks (a global allocation over the "
                    "gathered demand) are ROADMAP.md A13 item 11")
            if device is None:
                device = state_sharding.mesh.device
        if model_group is not None and (params is None or param_specs is None):
            raise ValueError(
                "model_group model parallelism needs explicit params AND param_specs "
                "(an mp_param_pspecs tree) — a factory closure cannot be sharded over "
                "the model group")
        self.device = resolve_device(device if device is not None or model_group is None
                                     else model_group.device)
        self.model_group = model_group
        # this rank's block of the slot axis, and the group of the batch
        # ranks that the boundary's gathers run over (None: one rank)
        self.slot_rows = (slice(0, num_slots) if state_sharding is None
                          else state_sharding.rows(num_slots))
        rows = self.slot_rows.stop - self.slot_rows.start
        self._batch_group = (state_sharding.group if state_sharding is not None
                             and state_sharding.ranks > 1 else None)
        # the ranks whose rank 0 decides admission: the whole mesh, or the
        # model group (None: one rank)
        mesh = None if state_sharding is None else state_sharding.mesh
        self._lead_group = (mesh.group(mesh.axis_names) if mesh is not None and mesh.world > 1
                            else model_group if model_group is not None
                            and model_group.world > 1 else None)
        # a host-staged collective cannot be captured: a group's programs run eagerly
        self._eager = model_group is not None
        self.schedule = schedule.to(self.device)
        self.event_shape = tuple(event_shape)
        self.num_slots = num_slots
        self.theta = int(min(theta, schedule.K))
        self.d_cond = d_cond
        self.eager_head = eager_head
        self.noise_mode = noise_mode
        self.keep_trajectory = keep_trajectory
        self.shard_id = shard_id
        self._tracer = tracer
        self.draining = False
        self.controller = controller if controller is not None else StaticTheta()
        self.num_branches = max(int(num_branches), 1)
        self.branch_controller = (branch_controller if branch_controller is not None
                                  else StaticBranches())
        self._params = None
        if params is not None:
            self._params = (params if model_group is None else shard_params(
                params, param_specs, mesh if mesh is not None else
                MeshGroups((model_group.world,), ("model",), model_group.rank)))
            model_fn = model_fn(self._params)
        self._model_fn = model_fn
        if execution not in ("unpacked", "packed"):
            raise ValueError(f"unknown execution mode {execution!r}")
        self.execution = execution
        if round_impl not in ("packed", "fused"):
            raise ValueError(f"unknown round_impl {round_impl!r}")
        if round_impl == "fused" and execution != "packed":
            raise ValueError('round_impl="fused" requires execution="packed" (the '
                             "fused kernels run the packed round body)")
        self.round_impl = round_impl
        if overcommit < 1.0:
            raise ValueError(f"overcommit must be >= 1, got {overcommit}")
        self.overcommit = float(overcommit)
        self.budget_hysteresis = float(budget_hysteresis)
        # up to full coverage: slots * theta * branches
        covering = num_slots * self.theta * self.num_branches
        self._budget_ladder = _pow2_ladder(num_slots, covering)
        if round_budget == "auto":
            if execution != "packed":
                raise ValueError('round_budget="auto" requires execution="packed" '
                                 "(the unpacked engine has no budget-shaped call)")
            self._budget_auto = True
            self.round_budget = self._budget_ladder[-1]  # open at the covering tier
        else:
            self._budget_auto = False
            self.round_budget = covering if round_budget is None else int(round_budget)
        if execution == "packed" and self.round_budget < num_slots:
            raise ValueError(
                f"round_budget {self.round_budget} < num_slots {num_slots}: every "
                "live chain needs at least one verification point per round")
        # budget-as-data (fused round): the pack width is this cap, and the
        # tier granted arrives at each call in _budget_dev
        self._budget_as_data = round_impl == "fused"
        self._budget_cap = (self._budget_ladder[-1] if self._budget_auto
                            else self.round_budget)
        # the per-round collective seconds by kind, calibrated once on the
        # group with the payloads of a round's points: the verify lanes, the
        # plan's head call and the eager head lanes a branch
        self._collective_kind_s: dict = {}
        if model_group is not None and collective_payloads:
            points = (self._budget_cap + (1 + self.num_branches) * rows
                      if execution == "packed"
                      else rows * (self.theta * self.num_branches + 1))
            self._collective_kind_s = measure_collective_seconds_by_kind(
                model_group, {k: [int(b) * points for b in v]
                              for k, v in collective_payloads.items()})
        self._collective_s_per_round = sum(self._collective_kind_s.values())
        if rounds_per_sync == "auto":
            self._auto_rps = True
            self._rps = 1
        else:
            self._auto_rps = False
            self._rps = int(rounds_per_sync)
            if self._rps < 1:
                raise ValueError(f"rounds_per_sync must be >= 1 or 'auto', got "
                                 f"{rounds_per_sync!r}")
        self.scheduler = SlotScheduler(num_slots, policy=policy)
        self.stats = EngineStats(shard=shard_id)
        self._key = prng.PRNGKey(seed)  # the serve key, on the host
        self._results: dict[int, np.ndarray] = {}
        self.dropped_rids: list[int] = []
        self._accept_ewma = 1.0
        self._spr_ewma = 0.0
        self._live_demand = 0
        self._demand_ewma = 0.0
        # a fresh chain's opening demand: the controller's initial window
        # times the opening branch count
        self._theta_open = int(self.controller.init(self.theta, 1, "cpu")[1][0])
        self._b_open = int(self.branch_controller.init(self.num_branches, 1, "cpu")[1][0])
        self._points_open = self._theta_open * max(self._b_open, 1)
        if execution == "packed":
            # the waterfill level scan must reach a slot's largest demand,
            # theta * branches
            self.allocator = (allocator if allocator is not None else
                              WaterfillingAllocator(theta_max=self.theta * self.num_branches))
        else:
            self.allocator = allocator
        self._weights = np.ones((rows,), np.float32)
        self._weights_dev = torch.ones((rows,), dtype=torch.float32, device=self.device)
        self._budget_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        # one program per (R, budget) key; the auto modes draw both
        # coordinates from power-of-two ladders, so this stays O(log * log)
        self._superstep_fns: dict[tuple, SuperstepProgram] = {}
        self._compiled_supersteps = 0  # this worker's own cache misses
        # the memory pool every graph of this worker captures into
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" and not self._eager else None)

        # every slot starts as an already finished dummy chain, frozen by
        # the rounds until a request is admitted over it (zero buffers in
        # buffer mode: nothing reads them)
        K, dev = schedule.K, self.device
        n = K + self.theta + 1
        bufs = {} if noise_mode == "counter" else dict(
            u_buf=torch.zeros((rows, n), device=dev),
            xi_buf=torch.zeros((rows, n) + self.event_shape, device=dev))
        states = init_chain_state(
            self.schedule, torch.zeros((rows,) + self.event_shape, device=dev),
            self.theta, keep_trajectory, self.controller,
            key=prng.split(prng.PRNGKey(seed), num_slots)[self.slot_rows].to(dev),
            noise_mode=noise_mode, num_branches=self.num_branches,
            branch_controller=self.branch_controller, **bufs)
        # a tensor of its own for every field (init_chain_state hands the
        # counters one zero tensor): the programs write each field back in
        # place, and these tensors are never rebound
        self._states = dataclasses.replace(states, **{
            f.name: getattr(states, f.name).clone()
            for f in dataclasses.fields(ASDChainState)
            if getattr(states, f.name) is not None})
        self._states.a.fill_(K)
        self._conds = (torch.zeros((rows, d_cond), device=dev) if d_cond
                       else None)
        # the sync packet every superstep program leaves behind, and the two
        # buffers it is copied into after each replay (the pipelined serve
        # reads packet s after it dispatches s + 1): the counters to pinned
        # host memory, the samples on the device; all made once, here
        cuda = dev.type == "cuda"
        self._packet_info = torch.zeros((len(_SYNC_ROWS), rows), dtype=torch.int32,
                                        device=dev)
        self._packet_samples = torch.zeros((rows,) + self.event_shape, device=dev)
        self._info_out = [torch.empty(self._packet_info.shape, dtype=torch.int32,
                                      pin_memory=cuda) for _ in range(2)]
        self._samples_out = [torch.empty_like(self._packet_samples) for _ in range(2)]
        self._ready = [torch.cuda.Event() for _ in range(2)] if cuda else [None, None]
        self._packet_turn = 0
        # one admission program per power-of-two width
        self._admit_fns: dict[int, SuperstepProgram] = {}
        log.debug("shard %d worker up: slots=%d theta=%d execution=%s budget=%s "
                  "R=%s policy=%s device=%s", shard_id, num_slots, self.theta,
                  execution, "auto" if self._budget_auto else self.round_budget,
                  "auto" if self._auto_rps else self._rps,
                  self.scheduler.policy.name, dev)

    # -- the superstep -------------------------------------------------------

    def _run_rounds(self, states: ASDChainState, R: int, budget) -> ASDChainState:
        """R rounds over the slot batch, launched with no host read."""
        statics = dict(eager_head=self.eager_head,
                       keep_trajectory=self.keep_trajectory,
                       controller=self.controller, noise_mode=self.noise_mode,
                       num_branches=self.num_branches,
                       branch_controller=self.branch_controller)
        with torch.no_grad():
            if self.execution == "packed":
                fused = self.round_impl == "fused"
                return packed_superstep(
                    self._model_fn, self.schedule, states, self._conds,
                    self._weights_dev, rounds=R, theta=self.theta,
                    budget=self._budget_cap if fused else budget,
                    budget_data=budget if fused else None,
                    allocator=self.allocator, round_impl=self.round_impl, **statics)
            return asd_superstep(self._model_fn, self.schedule, states, self.theta,
                                 R, conds=self._conds, **statics)

    def _make_superstep(self, R: int, budget) -> SuperstepProgram:
        """The program of one ``(R, budget)`` key: R rounds over the slot
        tensors, every field the rounds change written back into them.
        ``budget`` "data" (the fused round) reads the tier from
        ``_budget_dev``, which ``_launch_superstep`` fills before each call."""
        tier = self._budget_dev if budget == "data" else budget
        return SuperstepProgram(lambda: self._step_slots(R, tier), self.device,
                                self._graph_pool, eager=self._eager)

    def _step_slots(self, R: int, tier) -> None:
        """A superstep's body: R rounds over the slot tensors, every field
        they change written back, and the sync packet."""
        states = self._states
        new = self._run_rounds(states, R, tier)
        with torch.no_grad():
            for f in dataclasses.fields(ASDChainState):
                dst, src = getattr(states, f.name), getattr(new, f.name)
                if src is not dst:  # the keys and noise buffers come back as is
                    dst.copy_(src)
            self._pack_sync(states)

    def _pack_sync(self, st: ASDChainState) -> None:
        """The sync packet, written into the worker's packet tensors at the
        end of every superstep program (the JAX worker's ``_pack_sync``):
        the (9, S) int32 rows of ``_SYNC_ROWS`` and every slot's sample."""
        self._packet_info.copy_(torch.stack([getattr(st, name) for name in _SYNC_ROWS]))
        self._packet_samples.copy_(chain_sample(st, self.schedule.K, self.keep_trajectory))

    def _get_superstep(self, R: int, budget) -> SuperstepProgram:
        # budget-as-data: one program per R serves every tier, the budget
        # coordinate collapses to "data"
        key = (R, "data" if self._budget_as_data else budget)
        fn = self._superstep_fns.get(key)
        if fn is None:
            fn = self._superstep_fns[key] = self._make_superstep(R, key[1])
            self._compiled_supersteps += 1
            assert self._compiled_supersteps <= self._program_bound(), (
                f"worker built more superstep programs than its ladders allow: "
                f"{sorted(self._superstep_fns)}")
        return fn

    def _program_bound(self) -> int:
        """The most programs this worker's ladders allow: O(log R * log
        budget), one R coordinate when budget is data."""
        max_r = _AUTO_MAX_R.bit_length() if self._auto_rps else 1
        max_b = (1 if self._budget_as_data
                 else len(self._budget_ladder) if self._budget_auto else 1)
        return max_r * max_b + 1

    def _launch_superstep(self, R: int, budget) -> bool:
        """Run the superstep of ``(R, budget)`` on the slot tensors; returns
        True when it was the program's cold dispatch (on the card, the
        capture)."""
        prog = self._get_superstep(R, budget)
        if self._budget_as_data:
            self._budget_dev.fill_(budget)
        return prog()

    def _sync_packet(self):
        """The packet the superstep left, copied into the next of the two
        buffers: the counters to the host (asynchronously on the card, with
        an event that marks when they are there) and the samples on the
        device.  Two copies, no allocation."""
        k = self._packet_turn
        self._packet_turn ^= 1
        host, samples, ready = self._info_out[k], self._samples_out[k], self._ready[k]
        host.copy_(self._packet_info, non_blocking=True)
        samples.copy_(self._packet_samples)
        if ready is not None:
            ready.record(torch.cuda.current_stream(self.device))
        return host, ready, samples

    # -- request lifecycle ---------------------------------------------------

    def _request_key(self, rid: int) -> torch.Tensor:
        """The key of a request submitted without one: the serve key folded
        on the request id, a pure function of (serve key, rid) and not of
        admission order, slot or re-admission, as in the JAX worker."""
        return prng.fold_in(self._key, int(rid) & 0xFFFFFFFF)

    def _admit_record(self, req: Request):
        """The (key, y0) a request's chain starts from: its key split once
        for y0 where the request brings none, as the JAX worker does
        outside its jit (the key on the host, y0 drawn on the device)."""
        if self.noise_mode == "counter" and (req.u_buf is not None or req.xi_buf is not None):
            raise ValueError("counter noise draws from the chains' keys: pass key "
                             "and no u_buf / xi_buf")
        key = (prng.as_key(req.key) if req.key is not None
               else self._request_key(req.rid))
        if req.y0 is not None:
            return key, _as_tensor(req.y0, self.device)
        key, k0 = prng.split(key, 2).unbind(0)
        return key, init_y0(self.schedule, self.event_shape, device=self.device,
                            key=k0.to(self.device, non_blocking=True))

    def _admit_bound(self) -> int:
        """The most admission programs: one per power of two up to the
        first at or above num_slots."""
        return (self.num_slots - 1).bit_length() + 1

    def _get_admit(self, width: int) -> SuperstepProgram:
        """The admission program of ``width`` chains (the JAX worker's
        ``_admit_fn`` at one padded width), see ``admission_program``."""
        prog = self._admit_fns.get(width)
        if prog is not None:
            return prog
        prog = self._admit_fns[width] = admission_program(
            self, width, self._states, self._conds, self._graph_pool, self._eager)
        assert len(self._admit_fns) <= self._admit_bound(), (
            f"worker built more admission programs than widths: {sorted(self._admit_fns)}")
        return prog

    def _admission_context(self, now: float) -> AdmissionContext:
        return AdmissionContext(
            K=self.schedule.K, theta_max=self.theta, accept_rate=self._accept_ewma,
            seconds_per_round=self._spr_ewma, now=now,
            round_budget=self.round_budget, live_demand=self._live_demand,
            theta_open=self._points_open, rounds_per_sync=self._rps,
            overcommit=self.overcommit)

    @property
    def load(self) -> float:
        """Occupancy + queue pressure, in units of full slot batches."""
        busy = self.num_slots - len(self.scheduler.free_slots())
        return (busy + self.scheduler.queue_depth) / max(self.num_slots, 1)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # -- health / drain ------------------------------------------------------

    def begin_drain(self) -> None:
        """Close the admission gate: in-flight and queued requests finish,
        new submissions raise."""
        if not self.draining:
            self.draining = True
            self.stats.draining = True
            log.info("shard %d draining: %d queued, %d active", self.shard_id,
                     self.scheduler.queue_depth, len(self.scheduler.active_slots()))

    def _refresh_health(self) -> None:
        s, sched = self.stats, self.scheduler
        s.queue_depth = sched.queue_depth
        s.queue_depth_peak = max(s.queue_depth_peak, sched.queue_depth_peak)
        s.slot_occupancy = ((self.num_slots - len(sched.free_slots()))
                            / max(self.num_slots, 1))
        s.admission_pressure = self._admission_context(
            time.perf_counter()).budget_pressure
        s.draining = self.draining

    def health(self) -> dict:
        """This shard's health document; ``saturated`` means more than a
        full slot batch is queued behind the busy slots."""
        self._refresh_health()
        s = self.stats
        saturated = s.queue_depth > self.num_slots
        status = ("draining" if self.draining
                  else "backpressure" if saturated else "ok")
        return {"status": status, "shard": self.shard_id,
                "queue_depth": s.queue_depth, "queue_depth_peak": s.queue_depth_peak,
                "slot_occupancy": s.slot_occupancy,
                "admission_pressure": s.admission_pressure,
                "draining": self.draining, "saturated": saturated}

    def healthz(self) -> dict:
        h = self.health()
        return {"status": h["status"], "shards": [h]}

    # -- boundaries ----------------------------------------------------------

    def _pick_rounds(self) -> int:
        """R for the next superstep: fixed, or sized to the accept-rate EWMA
        (a retiring chain idles its slot for at most ~1/8 of its expected
        service) and snapped down to the power-of-two ladder."""
        if not self._auto_rps:
            return self._rps
        p = min(max(self._accept_ewma, 0.0), 0.999)
        adv = (1.0 - p ** self.theta) / max(1.0 - p, 1e-3)
        target = max(1, int(self.schedule.K / max(adv, 1.0) / 8.0))
        R = 1
        while R * 2 <= min(target, _AUTO_MAX_R):
            R *= 2
        self._rps = R
        return R

    def _pick_budget(self) -> Optional[int]:
        """The budget for the next superstep: fixed, or the auto tier
        (upshift at once to the covering tier, downshift one rung only once
        the demand EWMA sits at or below ``budget_hysteresis`` of it)."""
        if self.execution != "packed":
            return None
        if not self._budget_auto:
            return self.round_budget
        demand = max(self._demand_ewma, 1.0)
        target = next((t for t in self._budget_ladder if t >= demand),
                      self._budget_ladder[-1])
        cur = self.round_budget
        if target > cur:
            self.round_budget = target
        elif target < cur and cur > self._budget_ladder[0]:
            lower = max(t for t in self._budget_ladder if t < cur)
            if self._demand_ewma <= self.budget_hysteresis * lower:
                self.round_budget = lower
        if self.round_budget != cur:
            log.debug("shard %d budget tier %d -> %d (demand ewma %.1f)",
                      self.shard_id, cur, self.round_budget, self._demand_ewma)
        return self.round_budget

    def _local_row(self, slot: int) -> Optional[int]:
        """Slot ``slot``'s row in this rank's tensors, or None outside its
        block."""
        lo, hi = self.slot_rows.start, self.slot_rows.stop
        return slot - lo if lo <= slot < hi else None

    def _set_weight(self, slot: int, w: float) -> None:
        """One-lane update of the allocator weights, on the device too (a
        slot of this rank's block)."""
        row = self._local_row(slot)
        if row is not None and self._weights[row] != w:
            self._weights[row] = w
            self._weights_dev[row] = w

    def _observe_round_time(self, dt: float) -> None:
        # cold dispatches (captures) never reach here, see _harvest
        self._spr_ewma = dt if self._spr_ewma == 0.0 else 0.7 * self._spr_ewma + 0.3 * dt

    def _collect_admissions(self, now: float):
        """Run the admission policy and its host bookkeeping; returns the
        placed [(slot, request)].  Under a model group or over a mesh of
        ranks, rank 0 of them all decides (see ``_agree_admissions``)."""
        group = self._lead_group
        if group is None:
            placed = self.scheduler.admit(now, self.stats.rounds_total,
                                          self._admission_context(now))
        else:
            placed = self._agree_admissions(now, group)
        for entry in self.scheduler.drain_dropped():
            self.stats.observe_drop()
            self.dropped_rids.append(entry.request.rid)
            log.info("shard %d dropped rid=%s at admission (deadline unmeetable)",
                     self.shard_id, entry.request.rid)
        for slot, req in placed:
            self._set_weight(slot, max(1.0 + float(req.priority or 0.0), 0.1))
            self._live_demand += self._points_open
            self.stats.requests += 1
        return placed

    def _agree_admissions(self, now: float, group):
        """Rank 0 runs the admission policy on its own clock, deadlines and
        EWMAs, and broadcasts what it placed and dropped; the other ranks
        apply that (``SlotScheduler.follow``), so every rank's slot batch
        holds the same chains whatever its own clock or deadlines say."""
        rounds = self.stats.rounds_total
        if group.rank == 0:
            deferred = self.scheduler.deferred
            placed = self.scheduler.admit(now, rounds, self._admission_context(now))
            body = [v for slot, req in placed for v in (slot, req.rid)]
            body += [entry.request.rid for entry in self.scheduler.dropped]
            if any(not isinstance(v, (int, np.integer)) or abs(v) >= 1 << 53 for v in body):
                raise ValueError("a group's requests need integer rids below 2**53 "
                                 f"(rank 0 broadcasts its admissions as floats): {body}")
            head = [len(placed), len(self.scheduler.dropped),
                    self.scheduler.deferred - deferred]
        else:
            head = [0, 0, 0]
        n_placed, n_dropped, deferred = (int(v) for v in group.broadcast_floats(head))
        if group.rank != 0:
            body = [0] * (2 * n_placed + n_dropped)
        if body:
            body = [int(v) for v in group.broadcast_floats(body)]
        if group.rank == 0:
            return placed
        return self.scheduler.follow(
            now, rounds, list(zip(body[:2 * n_placed:2], body[1:2 * n_placed:2])),
            body[2 * n_placed:], deferred=bool(deferred))

    def _admit_pending(self) -> None:
        """Admit at the boundary (see ``_admit``)."""
        placed = self._collect_admissions(time.perf_counter())
        if placed:
            self._admit(placed)

    def _admit(self, placed) -> None:
        """Write the chains of the placed [(slot, request)] of this rank's
        block into its rows of the slot tensors, by one admission program
        (``run_admission``)."""
        placed = [(row, req) for slot, req in placed
                  if (row := self._local_row(slot)) is not None]
        if not placed:
            return
        records = [self._admit_record(req) for _, req in placed]
        width = 1 << (len(placed) - 1).bit_length()
        run_admission(self._get_admit(width), [row for row, _ in placed], records,
                      [req for _, req in placed], self.d_cond)
        with torch.no_grad():
            for row, req in placed:
                inject_noise(self._states, row, req, self.device)

    def _dispatch_superstep(self):
        """Admit, launch one superstep, and return its pending harvest."""
        self._admit_pending()
        R = self._pick_rounds()
        B = self._pick_budget()
        t0 = time.perf_counter()
        # a cold dispatch pays the capture: keep it out of dispatch_s and
        # the seconds-per-round EWMA, as the JAX worker keeps its compiles
        cold = self._launch_superstep(R, B)
        sync = self._sync_packet()
        t1 = time.perf_counter()
        if not cold:
            self.stats.dispatch_s += t1 - t0
        self.stats.rounds_total += R
        self.stats.supersteps += 1
        tr = self._tracer
        if tr is not None and tr.enabled:
            tr.add_span("dispatch", t0, t1, pid=self.shard_id, tid=self.num_slots,
                        pname=f"shard-{self.shard_id}", tname="dispatch",
                        args={"superstep": self.stats.supersteps, "R": R, "budget": B,
                              "cold": cold})
        return sync, self.stats.rounds_total, R, t0, cold

    def _harvest(self, pending, done_at: Optional[float] = None) -> None:
        """Read one superstep's sync packet: retire every chain that finished
        in it, refresh the budget-pressure signal, update the EWMAs.  Slots
        admitted at or after the packet's round count hold chains the packet
        does not show yet and are not retired against it.  ``done_at`` is
        the sharded fused front end's one completion stamp for the whole
        boundary (a ready event of None: it has waited already), so a later
        shard's seconds-per-round EWMA does not take in its siblings'
        harvests."""
        (info_host, ready, samples_dev), snapshot_rounds, R, t_dispatch, cold = pending
        tr = self._tracer
        if tr is not None and not tr.enabled:
            tr = None
        t0 = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        t1 = time.perf_counter()
        self.stats.device_s += t1 - t0
        if tr is not None:
            tr.add_span("device_wait", t0, t1, pid=self.shard_id, tid=self.num_slots + 1,
                        pname=f"shard-{self.shard_id}", tname="device",
                        args={"R": R, "cold": cold})
        if self._collective_s_per_round and not cold:
            # the calibrated estimate: the collectives run inside the
            # superstep, so a boundary is charged R x the probe
            est = R * self._collective_s_per_round
            self.stats.collective_s += est
            self.stats.collective_psum_s += R * self._collective_kind_s.get("psum", 0.0)
            self.stats.collective_a2a_s += R * self._collective_kind_s.get("all_to_all", 0.0)
            if tr is not None:
                tr.add_span("collective", max(t1 - est, t_dispatch), t1, pid=self.shard_id,
                            tid=self.num_slots + 3, tname="collective",
                            args={"estimated": True, "R": R})
        if self._batch_group is not None:
            # every rank's (9, rows) counters in rank order: the (9, S) packet
            t_gather = time.perf_counter()
            info_host = self._batch_group.all_gather(info_host, axis=1)
            self.stats.gather_s += time.perf_counter() - t_gather
        if self.model_group is not None and self.model_group.world > 1:
            self._check_model_ranks_agree(info_host)
        info = info_host.numpy()
        row = {name: info[i] for i, name in enumerate(_SYNC_ROWS)}
        a, theta_live = row["a"], row["theta_live"]
        now = time.perf_counter()
        K = self.schedule.K
        occupied = np.zeros((self.num_slots,), bool)
        occupied[self.scheduler.active_slots()] = True
        live = occupied & (a < K)
        # each live branch wants its own copy of the window
        b_live = np.maximum(row["b_live"], 1)
        self._live_demand = int(
            (b_live[live] * np.minimum(theta_live[live], (K - a)[live])).sum())
        if self._live_demand == 0:
            self._demand_ewma *= 0.5
        else:
            self._demand_ewma = (
                float(self._live_demand) if self._demand_ewma == 0.0
                else 0.5 * self._demand_ewma + 0.5 * self._live_demand)
        finished = [slot for slot in self.scheduler.active_slots()
                    if self.scheduler.slot_info(slot).admit_round < snapshot_rounds
                    and a[slot] >= K]
        if finished:
            samples = self._finished_samples(samples_dev, finished)
            for slot in finished:
                sinfo = self.scheduler.retire(slot)
                self._set_weight(slot, 1.0)
                if slot in samples:
                    self._results[sinfo.request.rid] = samples[slot].copy()
                if tr is not None:
                    rid = sinfo.request.rid
                    tr.add_span("queued", sinfo.submit_time, sinfo.admit_time,
                                pid=self.shard_id, tid=slot, pname=f"shard-{self.shard_id}",
                                tname=f"slot-{slot}", args={"rid": rid})
                    tr.add_span("request", sinfo.admit_time, now, pid=self.shard_id,
                                tid=slot, args={"rid": rid, "rounds": int(row["rounds"][slot]),
                                                "accepts": int(row["accepts"][slot]),
                                                "theta_live": int(theta_live[slot])})
                deadline = sinfo.request.deadline
                rm = RequestMetrics(
                    rid=sinfo.request.rid,
                    queue_latency=sinfo.admit_time - sinfo.submit_time,
                    service_time=now - sinfo.admit_time,
                    rounds=int(row["rounds"][slot]),
                    head_calls=int(row["head_calls"][slot]),
                    model_evals=int(row["model_evals"][slot]),
                    accepts=int(row["accepts"][slot]),
                    proposals=int(row["proposals"][slot]),
                    draft_points=int(row["draft_points"][slot]),
                    deadline=deadline,
                    slo_met=None if deadline is None else now <= deadline)
                self.stats.observe(rm)
                self._accept_ewma = 0.8 * self._accept_ewma + 0.2 * rm.accept_rate
        if not self.scheduler.active_slots() and self.scheduler.queue_depth == 0:
            # fully idle: reset the demand signal so the next admission
            # re-tiers from its own demand
            self._live_demand = 0
            self._demand_ewma = 0.0
        t_end = time.perf_counter()
        self.stats.host_sync_s += t_end - t1
        if tr is not None:
            tr.add_span("harvest", t1, t_end, pid=self.shard_id, tid=self.num_slots + 2,
                        tname="harvest", args={"retired": len(finished),
                                               "live_demand": self._live_demand})
        self._refresh_health()
        if not cold:
            end = done_at if done_at is not None else time.perf_counter()
            self._observe_round_time((end - t_dispatch) / R)

    def _check_model_ranks_agree(self, info_host: torch.Tensor) -> None:
        """The model group's ranks hold the same slots and step them the
        same way, so their counters agree in every bit; raise where they
        do not (a tie is not broken: the ranks' results have diverged)."""
        t0 = time.perf_counter()
        every = self.model_group.all_gather(info_host[None], axis=0)
        self.stats.gather_s += time.perf_counter() - t0
        bad = [r for r in range(1, every.shape[0]) if not torch.equal(every[0], every[r])]
        if bad:
            raise RuntimeError(
                f"model ranks {bad} of this block hold other counters than model rank 0 "
                f"at round {self.stats.rounds_total}: the model group's ranks diverged")

    def _finished_samples(self, samples_dev: torch.Tensor, finished: list) -> dict:
        """{slot: sample} of the ``finished`` slots: all of them on one rank
        or on rank 0 of the batch ranks (each rank sends the rows of its
        block that finished, point to point), this rank's own on the
        others."""
        group = self._batch_group
        if group is None:
            return dict(enumerate(samples_dev.cpu().numpy()))
        mine = [s for s in finished if self._local_row(s) is not None]
        rows = samples_dev[torch.tensor([self._local_row(s) for s in mine], dtype=torch.int64,
                                        device=samples_dev.device)]
        per = self.slot_rows.stop - self.slot_rows.start
        counts = [sum(r * per <= s < (r + 1) * per for s in finished)
                  for r in range(group.world)]
        t0 = time.perf_counter()
        every = group.gather_rows_to_lead(rows, counts)
        self.stats.gather_s += time.perf_counter() - t0
        if every is None:
            return dict(zip(mine, rows.cpu().numpy()))
        # rank order is slot order: the blocks are contiguous and ascending
        return dict(zip(sorted(finished), every.numpy()))

    def drain_results(self) -> dict:
        out, self._results = self._results, {}
        return out

    def chain_state(self, slot: int) -> ASDChainState:
        """One slot's resumable state: views into the slot tensors (a slot
        of this rank's block)."""
        row = self._local_row(slot)
        if row is None:
            raise ValueError(f"slot {slot} is not in this rank's block {self.slot_rows}")
        return dataclasses.replace(self._states, **{
            f.name: getattr(self._states, f.name)[row]
            for f in dataclasses.fields(ASDChainState)
            if getattr(self._states, f.name) is not None})

    def _program_statics(self) -> tuple:
        """What shapes a superstep program besides its key."""
        return (self.device, self.schedule.K, self.event_shape, self.num_slots,
                self.slot_rows, self.theta,
                self.d_cond, self.eager_head, self.noise_mode, self.keep_trajectory,
                self.controller, self.num_branches, self.branch_controller,
                self.execution, self.round_impl, self._budget_ladder, self._budget_cap,
                self.allocator, self._eager)

    def adopt_programs(self, warm: "ShardWorker") -> "ShardWorker":
        """Share a warm worker's program build (same statics and shapes).

        A JAX executable takes the slot pytree as an argument, so the JAX
        worker hands its siblings the executables themselves.  A CUDA graph
        binds the slot tensors it was captured on and cannot serve another
        worker's slots, so here each worker still captures its own programs
        (supersteps and admissions) against its own slot tensors.  What is
        shared is the graph memory pool that all of them capture into
        (sibling graphs take their transients from the same memory;
        they replay one at a time on the stream they are called on) and
        the kernels the donor built and set up, which are the process's.
        Raises ValueError where the statics differ, which the JAX callers
        assume never happens."""
        if self._program_statics() != warm._program_statics():
            raise ValueError("adopt_programs: the workers' statics or shapes differ")
        self._graph_pool = warm._graph_pool
        return self
