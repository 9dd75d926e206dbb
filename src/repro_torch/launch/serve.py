"""The ASD server: batched diffusion sampling from the command line, the
port's counterpart of the JAX package's ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --model paper-diffusion-policy-smoke --K 20
    PYTHONPATH=src python -m repro_torch.launch.serve --shards 2 \\
        --router round-robin --dispatch fused --execution packed --round-impl fused

Two serving modes, both with counter noise and the live window only
(``noise_mode="counter"``, ``keep_trajectory=False``), as the JAX CLI runs
them:

  --engine fused       ``asd_sample_batched`` over --chains chains (y0 from
                       ``numpy.random.default_rng(0)``, key ``PRNGKey(1)``):
                       the batch runs to its slowest chain.
  --engine continuous  ``ContinuousASDEngine`` over --slots slots; request i
                       carries ``PRNGKey(1000 + i)``, finished chains retire
                       at superstep boundaries and their slots are refilled.
                       With ``--shards`` N > 1, ``ShardedASDEngine``: N
                       workers of --slots / N slots behind ``--router``,
                       dispatched per shard or, with ``--dispatch fused``,
                       as one program a boundary; ``--round-budget`` is then
                       per shard (default slots / N * theta * B).

Model parallelism inside a shard, with the JAX CLI's mode resolution and
messages: ``--model-shards`` N > 1 (tensor parallelism), ``--seq-shards``
N > 1 (Ulysses sequence parallelism; not with ``--model-shards`` > 1, and
only where ``sp_compatible`` says so) and ``--expert-parallel`` (the MoE
expert stacks over the same group, which one of the two must make).  The
CLI starts the group's ranks itself (``repro_torch.distributed.group
.run_group``), all on ``--device``: on one card every rank shares it.
Every rank runs the same engine on the same requests; rank 0 prints the
summary, with the JAX CLI's ``, mp=N (sequence-parallel)
(expert-parallel)`` clause and its ``collectives:`` line (the calibrated
lanes: host-staged gloo here), and the other ranks print nothing.

``--mesh`` ``DxM`` or ``PxDxM`` (the JAX CLI's axes, ``launch/mesh.py
::parse_mesh``): the CLI starts prod(dims) ranks (``run_group``, gloo,
every rank on ``--device``), each running ``serve_rank`` over
``make_rank_mesh``.  The batch axes split the work: the continuous engine
shards its slots by ``chain_state_shardings(mesh)`` (``--slots`` a
multiple of pod * data, or derived and rounded up to one, with the JAX
CLI's message); the fused engine gives each rank its block of the
``default_rng(0)`` y0 rows and of ``split(PRNGKey(1), chains)``
(``--chains`` must split over pod * data, as ``NamedSharding`` requires)
and gathers samples and counters to rank 0.  The ``model`` axis, where
it is above 1, splits the weights as the JAX CLI's ``_build`` lays them
out (``ServeLayout``: ``param_pspecs`` over the mesh, cast once to the
compute dtype): a rank keeps its blocks, the blocks of ``tp_paths`` run
tensor-parallel over the mesh's model group, and every other cut leaf is
all-gathered at each model call; every program then runs eagerly (the
fused sampler's rounds too, ``asd_sample_batched(eager=True)``), since a
host-staged collective cannot be captured.  Rank 0 prints the JAX CLI's
lines; the other ranks print nothing.  Over the batch axes alone every
request gets the 1 x 1 run's sample bits and counters; a model axis
changes the order of the tensor-parallel sums, so ``DxM`` gives the bits
of ``1xM``, within float rounding of 1 x 1.

The flags, their names and defaults are the JAX CLI's, with two
differences: ``--mesh`` defaults to ``1x1`` (the JAX CLI's ``2x4`` would
put eight ranks on one card), and ``--device`` picks the device (default
the card; ``cpu`` runs the kernels' plain versions).  The weights are
``denoiser_init_params`` at seed 0, the JAX init's law.  ``--num-branches`` B > 1 runs branched speculation in the
continuous engine (B draft branches a chain a round, the longest accepted
prefix committed; ``--branch-controller`` static or gain), and the summary
line then gives the mean accepted prefix a round and the wasted share of
the drafted points; as in the JAX CLI, the fused engine runs one branch.
What the port has no counterpart for yet is refused with exit status 2 and
the ROADMAP.md item that brings it, never ignored: packed execution over
several batch ranks (A13 item 11; ``--mesh 1xM --execution packed``
serves), a mesh of several ranks with ``--shards``,
``--model-shards``, ``--seq-shards`` or ``--expert-parallel`` (A13 item
12), and ``--grs-impl`` / ``--pack-impl``, since the device picks the
plain version (CPU) or the CUDA kernel (card).  The MoE denoiser
``qwen3-moe-a3b-smoke`` is served with every expert on the device.

Observability: ``--metrics-port`` serves /metrics, /metrics.json and
/healthz on 127.0.0.1 and scrapes itself once after the run;
``--trace-out`` writes the engine's spans as Chrome trace-event JSON;
``--profile-supersteps N`` brackets N warm supersteps in ``torch.profiler``
and writes its Chrome trace into ``--profile-dir``.

On the card every superstep program is a CUDA graph, captured at its first
call and replayed after (``repro_torch.programs``): the
``[continuous]`` line's time includes the captures, as the JAX CLI's
includes its compiles.  With ``--device cpu`` the supersteps run eagerly.

``main(argv)`` returns the engine's ``summary()`` (continuous) or the
sampler's numbers (fused), with ``finite``, so a script can drive it in
process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import math
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from repro_torch.configs.registry import get_denoiser_config
from repro_torch.core import prng
from repro_torch.core.asd import asd_sample_batched
from repro_torch.core.controller import (BRANCH_CONTROLLERS, CONTROLLERS,
                                         make_branch_controller, make_controller)
from repro_torch.core.schedules import ddpm as ddpm_schedule
from repro_torch.device import resolve_device
from repro_torch.distributed.group import run_group
from repro_torch.distributed.sharding import (ServeLayout, chain_state_shardings,
                                              mp_param_pspecs)
from repro_torch.launch.mesh import Mesh, make_rank_mesh, parse_mesh
from repro_torch.models.diffusion import (compute_params, make_ddpm_model_fn,
                                          mp_collective_payloads, sp_compatible)
from repro_torch.nn.param import param_axes
from repro_torch.serving.engine import ContinuousASDEngine, Request
from repro_torch.serving.obs import (MetricsRegistry, MetricsServer, TraceRecorder,
                                     instrument_engine)
from repro_torch.serving.packing import ALLOCATORS, make_allocator
from repro_torch.serving.router import ROUTERS, make_router
from repro_torch.serving.scheduler import POLICIES, make_policy
from repro_torch.serving.sharded import ShardedASDEngine
from repro_torch.weights import denoiser_init_params, param_shapes

log = logging.getLogger("repro_torch.serving.serve")


def _refusal(args):
    """The message for a flag the port cannot honour yet, or None."""
    try:
        dims, names = parse_mesh(args.mesh)
    except ValueError as exc:
        return str(exc)
    if math.prod(dims) > 1 and args.engine == "continuous":
        if args.execution == "packed" and _batch_ranks(args.mesh) > 1:
            return (f"--mesh {args.mesh} with --execution packed: packed rounds over "
                    "several batch ranks (a global allocation over the gathered demand) "
                    "are ROADMAP.md A13 item 11")
        for flag, on in (("--shards", args.shards > 1), ("--model-shards", args.model_shards > 1),
                         ("--seq-shards", args.seq_shards > 1),
                         ("--expert-parallel", args.expert_parallel)):
            if on:
                return (f"--mesh {args.mesh} with {flag}: a mesh of several ranks beside "
                        "shards or a model group is ROADMAP.md A13 item 12")
    for flag, value in (("--grs-impl", args.grs_impl), ("--pack-impl", args.pack_impl)):
        if value is not None:
            return (f"{flag} {value}: no counterpart in the port, whose device picks "
                    "the plain version (CPU) or the CUDA kernel (card); see ROADMAP.md A8")
    return None


def _batch_ranks(spec: str) -> int:
    """pod * data of ``--mesh`` ``spec``: the ranks the slots (or chains)
    split over."""
    dims, names = parse_mesh(spec)
    return math.prod(n for a, n in zip(names, dims) if a != "model")


def _params(dc, dev):
    """The weights drawn on ``dev`` at seed 0 (the same weights on every
    card and every rank: one seed, one counter-based generator)."""
    return denoiser_init_params(dc, torch.Generator(device=dev).manual_seed(0), device=dev)


def _model_fn(dc, dev):
    return make_ddpm_model_fn(_params(dc, dev), dc)


def model_parallelism(args) -> int:
    """The JAX CLI's mode resolution: the ranks of the model group
    (``mp_total``, 1 without one).  TP and SP both consume the attention
    head axis, so they are mutually exclusive; EP rides whichever is on.
    A bad combination exits with the JAX CLI's message."""
    mp, sp, ep = args.model_shards, args.seq_shards, args.expert_parallel
    if mp > 1 and sp > 1:
        raise SystemExit(
            "--model-shards > 1 and --seq-shards > 1 are mutually "
            "exclusive: both consume the attention head axis (TP's FFN "
            "psum would sum partial products of different token slices)")
    if sp > 1:
        ok, reason = sp_compatible(get_denoiser_config(args.model), sp)
        if not ok:
            raise SystemExit(f"--seq-shards {sp}: {reason}")
    mp_total = mp if mp > 1 else sp  # ranks per model group
    if ep and mp_total <= 1:
        raise SystemExit(
            "--expert-parallel needs a model group to shard experts over: "
            "set --model-shards > 1 (or --seq-shards > 1)")
    return max(mp_total, 1)


def _model_parallel_kwargs(args, dc, dev, group) -> tuple:
    """(factory, engine kwargs) of the model group: the specs of
    ``mp_param_pspecs(tensor=mp > 1, expert=ep)``, the payloads of
    ``mp_collective_payloads``, and the model function over the group's
    axes."""
    mp, sp, ep = args.model_shards, args.seq_shards, args.expert_parallel
    mesh = Mesh((group.world,), ("model",), ())
    specs = mp_param_pspecs(param_axes(dc), param_shapes(dc), mesh, tensor=mp > 1,
                            expert=ep)
    params = _params(dc, dev)

    def factory(p):
        return make_ddpm_model_fn(p, dc, tp_axis=group if mp > 1 else None,
                                  sp_axis=group if sp > 1 else None, sp_size=sp,
                                  ep_axis=group if ep else None)

    return factory, dict(
        model_shards=group.world, model_group=group, params=params, param_specs=specs,
        collective_payloads=mp_collective_payloads(params, specs, dc, mp_size=group.world,
                                                   sp_size=sp))


def _mesh_model(dc, mesh) -> tuple:
    """(model function or factory, the worker's kwargs, layout) of a serve
    mesh (this rank's ``MeshGroups``).  With a model axis of 1: the whole
    weights' model function, no kwargs, no layout.  Else the
    ``ServeLayout`` of the mesh, the whole weights cast once to the compute
    dtype (the worker keeps this rank's blocks of them and drops the rest),
    and a factory whose model function reads ``layout.at_use`` of the
    blocks at every call, tensor-parallel over the model group."""
    dev = mesh.device
    if mesh.sizes()["model"] == 1:
        return _model_fn(dc, dev), {}, None
    layout = ServeLayout(param_axes(dc), param_shapes(dc), mesh)

    def factory(blocks):
        return make_ddpm_model_fn(blocks, dc, tp_axis=layout.tp_axis, at_use=layout.at_use)

    return factory, dict(model_group=layout.model_group,
                         params=compute_params(_params(dc, dev), dc),
                         param_specs=layout.specs), layout


def _build(args):
    dev = resolve_device(args.device)
    dc = get_denoiser_config(args.model)
    return dev, dc, _model_fn(dc, dev)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_fused(args, mesh=None) -> dict | None:
    """The fused sampler over --chains chains; over ``mesh`` (this rank's
    ``MeshGroups``) the rank samples its block of the chains and rank 0
    gathers the rest, prints and returns the numbers (the others None)."""
    eager = False
    if mesh is None:
        dev, dc, model_fn = _build(args)
    else:
        dev, dc = mesh.device, get_denoiser_config(args.model)
        model_fn, kw, weights = _mesh_model(dc, mesh)
        if weights is not None:  # the rank keeps its blocks only
            model_fn = model_fn(weights.shard(kw.pop("params")))
            eager = True
        del kw
    sched = ddpm_schedule(args.K)
    y0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.chains, dc.seq_len, dc.d_data), np.float32))
    keys = dict(key=prng.PRNGKey(1))
    if mesh is not None:
        layout = chain_state_shardings(mesh)
        rows = layout.rows(args.chains)
        y0, keys = y0[rows], dict(keys=prng.split(prng.PRNGKey(1), args.chains)[rows])
    t0 = time.perf_counter()
    with torch.no_grad():
        res = asd_sample_batched(model_fn, sched, y0, args.theta, eager_head=True,
                                 keep_trajectory=False,
                                 controller=make_controller(args.theta_controller),
                                 device=dev, noise_mode="counter", eager=eager, **keys)
    _sync(dev)
    fields = (res.sample, res.rounds, res.head_calls, res.accepts, res.proposals)
    if mesh is not None and layout.ranks > 1:
        counts = [y0.shape[0]] * layout.ranks
        fields = [layout.group.gather_rows_to_lead(f, counts) for f in fields]
        if layout.group.rank != 0:
            return None
    dt = time.perf_counter() - t0
    out, rounds, heads, accepts, proposals = (f.cpu().numpy() for f in fields)
    depth = float(np.mean(rounds + heads))
    finite = bool(np.isfinite(out).all())
    print(f"[fused] sampled {args.chains} chains (K={args.K}) in {dt:.1f}s "
          f"(includes compile); sequential depth {depth:.0f} "
          f"=> {args.K / depth:.1f}x algorithmic speedup")
    print(f"output {tuple(out.shape)}, finite={finite}")
    accepts, proposals = int(accepts.sum()), int(proposals.sum())
    return {"chains": args.chains, "wall_time_s": dt, "throughput_rps": args.chains / dt,
            "rounds_total": int(rounds.max()), "mean_parallel_depth": depth,
            "accept_rate": accepts / max(proposals, 1),
            "mean_window": proposals / max(int(rounds.sum()), 1), "finite": finite}


def _profile_supersteps(eng, args, slots, dev, lead: bool = True) -> dict:
    """Bracket N warm supersteps in ``torch.profiler``.  A warm pool fills
    the slots and runs its first superstep before the bracket opens (on the
    card: the capture, so the window replays); its results are discarded
    (its work does land in the stats).  Returns the window's host wall
    time, the device's busy time (the kernels' own times, one stream) and
    the programs built inside the window (0 unless an auto ladder moved),
    and writes the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(slots):
        eng.submit(Request(-1 - i, key=prng.PRNGKey(10**6 + i)))
    eng.step()
    _sync(dev)
    built = eng._compiled_supersteps
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < args.profile_supersteps and eng.has_work():
            eng.step()
            n += 1
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    built = eng._compiled_supersteps - built
    while eng.step():
        pass
    eng.drain_results()
    path = os.path.join(args.profile_dir, "serve_trace.json")
    if lead:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(path)
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    idle = max(0.0, 1.0 - busy / wall_ms) if busy > 0 else None
    print(f"[profile] {n} warm supersteps -> {path} (view in Perfetto): wall "
          f"{wall_ms:.1f}ms, device busy "
          + (f"{busy:.1f}ms, idle share {idle:.3f}" if idle is not None
             else "not measured (no device kernels traced)")
          + f", {built} programs built in the window")
    return {"supersteps": n, "wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": idle, "programs_built": built, "trace": path}


def _slots(args, batch_world: int) -> int:
    """The JAX CLI's slot rule and message: ``--slots`` a multiple of the
    mesh's batch ranks, or ~half the requests rounded up to one."""
    if args.slots:
        if args.slots % batch_world:
            raise SystemExit(
                f"--slots {args.slots} must be a multiple of the mesh batch axes "
                f"(pod*data = {batch_world}) so the slot batch shards evenly")
        return args.slots
    slots = max(args.chains // 2, batch_world)
    return ((slots + batch_world - 1) // batch_world) * batch_world


def run_continuous(args, group=None, mesh=None) -> dict:
    """The continuous engine; with ``group`` (a ``ModelGroup``: this process
    is one of its ranks) the engine runs model-parallel over it, with
    ``mesh`` (this rank's ``MeshGroups``) its slots shard over the mesh's
    batch axes and its weights over the mesh's model axis
    (``_mesh_model``); either way only rank 0 serves metrics and writes
    the trace and the profile."""
    lead = (group is None or group.rank == 0) and (mesh is None or mesh.rank == 0)
    if group is not None:
        dev, dc = group.device, get_denoiser_config(args.model)
        model_fn, mp_kwargs = _model_parallel_kwargs(args, dc, dev, group)
    elif mesh is not None:
        dev, dc = mesh.device, get_denoiser_config(args.model)
        model_fn, mp_kwargs, _ = _mesh_model(dc, mesh)
    else:
        dev, dc, model_fn = _build(args)
        mp_kwargs = {}
    sched = ddpm_schedule(args.K)
    batch_world = 1 if mesh is None else chain_state_shardings(mesh).ranks
    slots = _slots(args, batch_world)
    if args.shards > 1 and slots % args.shards:
        raise SystemExit(f"--slots {slots} must divide evenly over --shards {args.shards}")
    # with shards the budget is per shard: each shard's round is one
    # budget-shaped call over its own slots
    slots_local = slots // max(args.shards, 1)
    budget = allocator = None
    if args.execution == "packed":
        budget = ("auto" if args.round_budget == "auto"
                  else int(args.round_budget) or slots_local * args.theta * args.num_branches)
        # a slot's largest demand is theta * branches: the waterfill level
        # scan must reach it
        allocator = make_allocator(args.allocator, theta_max=args.theta * args.num_branches)
    tracer = TraceRecorder(capacity=args.trace_capacity) if args.trace_out else None
    common = dict(
        theta=args.theta, eager_head=True, noise_mode="counter", keep_trajectory=False,
        controller=make_controller(args.theta_controller), policy=make_policy(args.policy),
        num_branches=args.num_branches,
        branch_controller=make_branch_controller(args.branch_controller),
        execution=args.execution, round_budget=budget, allocator=allocator,
        round_impl=args.round_impl,
        rounds_per_sync=(args.rounds_per_sync if args.rounds_per_sync == "auto"
                         else int(args.rounds_per_sync)),
        overcommit=args.overcommit, device=dev, tracer=tracer)
    if group is not None:
        eng = ShardedASDEngine(
            model_fn, sched, (dc.seq_len, dc.d_data), num_slots=slots, shards=args.shards,
            router=make_router(args.router), dispatch=args.dispatch, **mp_kwargs, **common)
        del mp_kwargs  # the rank keeps its share of the weights only
    elif args.shards > 1:
        # shards on other cards draw the same weights there
        eng = ShardedASDEngine(
            model_fn, sched, (dc.seq_len, dc.d_data), num_slots=slots, shards=args.shards,
            router=make_router(args.router), dispatch=args.dispatch,
            model_fn_for=lambda d: model_fn if d == dev else _model_fn(dc, d), **common)
    else:
        eng = ContinuousASDEngine(
            model_fn, sched, (dc.seq_len, dc.d_data), num_slots=slots,
            state_sharding=(chain_state_shardings(mesh) if mesh is not None
                            and mesh.world > 1 else None), **mp_kwargs, **common)
        del mp_kwargs  # the rank keeps its blocks of the weights only
    server = None
    if args.metrics_port >= 0 and lead:
        registry = instrument_engine(MetricsRegistry(), eng)
        server = MetricsServer(registry, health_fn=eng.healthz, port=args.metrics_port)
        server.start()
        print(f"[metrics] serving /metrics and /healthz at {server.url}")
    try:
        profiled = (_profile_supersteps(eng, args, slots, dev, lead)
                    if args.profile_supersteps > 0 else None)
        reqs = [Request(i, key=prng.PRNGKey(1000 + i)) for i in range(args.chains)]
        workers = getattr(eng, "workers", [eng])
        before = [w.stats.supersteps for w in workers]
        t0 = time.perf_counter()
        out = eng.serve(reqs)
        dt = time.perf_counter() - t0
        # the serve's superstep boundaries (a shard's supersteps: they run
        # side by side)
        boundaries = max(w.stats.supersteps - b for w, b in zip(workers, before))
        s = eng.stats
        exec_desc = (f"packed B={budget}/{slots_local * args.theta} alloc={args.allocator}"
                     if args.execution == "packed" else "unpacked")
        shard_desc = (f", shards={args.shards} router={args.router}"
                      + (" dispatch=fused" if args.dispatch == "fused" else "")
                      if args.shards > 1 else "")
        if group is not None:
            shard_desc += (f", mp={group.world}"
                           + (" (sequence-parallel)" if args.seq_shards > 1 else "")
                           + (" (expert-parallel)" if args.expert_parallel else ""))
        grs = "cuda" if dev.type == "cuda" else "plain"
        print(f"[continuous] served {s.retired} requests on {slots} slots "
              f"({exec_desc}{shard_desc}, K={args.K}, policy={args.policy}, "
              f"controller={args.theta_controller}, grs={grs}, "
              f"R={args.rounds_per_sync}) in {dt:.1f}s "
              f"({'includes capture' if dev.type == 'cuda' else 'eager'}): "
              f"{s.rounds_total} fused rounds in {s.supersteps} supersteps, "
              f"accept rate {s.accept_rate():.2f}, "
              f"mean live window {s.mean_window():.1f}/{args.theta}, "
              + (f"branch depth {s.branch_accept_depth():.2f} "
                 f"(waste {s.wasted_draft_frac():.2f}, B={args.num_branches}), "
                 if args.num_branches > 1 else "")
              + f"mean queue latency {s.mean_queue_latency() * 1e3:.0f}ms, "
              f"SLO attainment {s.slo_attainment():.2f}, "
              f"{s.throughput():.2f} samples/s")
        if args.shards > 1 or group is not None:
            for w, n in zip(eng.workers, eng.routed_counts):
                log.info("shard %d: %d routed, %d retired, %d rounds, budget %s, device %s",
                         w.shard_id, n, w.stats.retired, w.stats.rounds_total,
                         w.round_budget, w.device)
        if group is not None:
            tb = s.timing_breakdown()
            print(f"  collectives: {tb['collective_s'] * 1e3:.1f}ms "
                  f"({tb['collective_frac']:.1%} of wall, calibrated; "
                  f"psum {tb['collective_psum_s'] * 1e3:.1f}ms, "
                  f"all_to_all {tb['collective_a2a_s'] * 1e3:.1f}ms)")
        sample = next(iter(out.values()))
        finite = all(bool(np.isfinite(v).all()) for v in out.values())
        print(f"output {sample.shape} per request, finite={finite}")
        # the samples by request id too, for a script that drives main()
        summary = dict(s.summary(), finite=finite, slots=slots, samples=out,
                       serve_boundaries=boundaries)
        if profiled is not None:
            summary["profile"] = profiled
        if server is not None:
            # self-scrape: the endpoints answer with the numbers just made
            body = urllib.request.urlopen(server.url + "/metrics", timeout=5).read().decode()
            try:
                hz_body = urllib.request.urlopen(server.url + "/healthz", timeout=5).read()
            except urllib.error.HTTPError as e:  # a 503 carries the document too
                hz_body = e.read()
            hz = json.loads(hz_body)
            n_samples = sum(1 for ln in body.splitlines() if ln and not ln.startswith("#"))
            print(f"[metrics] scraped {n_samples} samples from {server.url}/metrics; "
                  f"/healthz status={hz['status']}")
            summary["metrics"] = {"samples": n_samples, "healthz": hz["status"]}
    finally:
        if server is not None:
            server.stop()
    if tracer is not None and lead:
        doc = tracer.export_chrome_trace(args.trace_out)
        print(f"[trace] {len(doc['traceEvents'])} events ({doc['droppedEvents']} dropped) "
              f"-> {args.trace_out} (load in Perfetto / chrome://tracing)")
        summary["trace"] = {"events": len(doc["traceEvents"]),
                            "dropped": doc["droppedEvents"]}
    return summary


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--model", default="paper-diffusion-policy")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL or PODxDATAxMODEL ranks: the slots (or the fused "
                         "engine's chains) shard over the batch axes, the weights over "
                         "MODEL (param_pspecs; tensor-parallel where tp_paths says so, "
                         "the other cut leaves gathered at use)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--engine", default="continuous", choices=("continuous", "fused"))
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous engine slots (default: ~chains/2)")
    ap.add_argument("--theta", type=int, default=8,
                    help="speculation window cap theta_max")
    ap.add_argument("--K", type=int, default=100)
    ap.add_argument("--theta-controller", default="static", choices=sorted(CONTROLLERS),
                    help="per-chain speculation-window controller")
    ap.add_argument("--num-branches", type=int, default=1,
                    help="branched speculation cap B: draft branches rolled per round "
                         "per chain, committing the branch with the longest accepted "
                         "prefix (1: single-draft)")
    ap.add_argument("--branch-controller", default="static",
                    choices=sorted(BRANCH_CONTROLLERS),
                    help="per-chain live branch-count controller (b_live <= "
                         "--num-branches)")
    ap.add_argument("--policy", default="fcfs", choices=sorted(POLICIES),
                    help="continuous-engine admission policy")
    ap.add_argument("--grs-impl", default=None, choices=("core", "kernel"),
                    help="refused: the device picks the GRS version")
    ap.add_argument("--execution", default="unpacked", choices=("unpacked", "packed"),
                    help="packed: gather only live verification points into a "
                         "fixed --round-budget model call per round")
    ap.add_argument("--round-budget", default="0",
                    help="packed verification points per round (default: slots * "
                         'theta, never binding), or "auto" for live-demand tiers')
    ap.add_argument("--allocator", default="waterfill", choices=sorted(ALLOCATORS),
                    help="packed budget split across slots")
    ap.add_argument("--pack-impl", default=None, choices=("ref", "kernel"),
                    help="refused: the device picks the gather/scatter version")
    ap.add_argument("--round-impl", default="packed", choices=("packed", "fused"),
                    help="packed-round body: per-phase kernels, or the fused "
                         "gather and verify-commit kernels")
    ap.add_argument("--rounds-per-sync", default="1",
                    help="speculation rounds per superstep: an integer, or 'auto'")
    ap.add_argument("--shards", type=int, default=1,
                    help="shard-local workers, --slots / N slots each, behind --router "
                         "(they share the card, or take one a card with several)")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="tensor parallelism inside each shard: the ranks of the model "
                         "group the CLI starts (all on --device; heads and the FFN's "
                         "hidden dim shard over them, psums inside each model call)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="shard MoE expert stacks over the model group (each rank owns "
                         "E/mp experts; tokens reach them by all_to_all).  Needs a "
                         "model group: --model-shards > 1 or --seq-shards > 1")
    ap.add_argument("--seq-shards", type=int, default=1,
                    help="Ulysses sequence parallelism inside each shard: weights "
                         "replicate, the stream is sequence-sharded and attention "
                         "trades sequence for heads around its core.  Mutually "
                         "exclusive with --model-shards > 1; needs attn-only groups, "
                         "heads %% sp == 0, seq_len %% sp == 0")
    ap.add_argument("--router", default="least-loaded", choices=sorted(ROUTERS),
                    help="sharded serving request router")
    ap.add_argument("--dispatch", default="per-shard", choices=("per-shard", "fused"),
                    help="sharded execution: per-shard (each worker replays its own "
                         "programs; per-shard budget tiers) or fused (one program a "
                         "boundary over every shard's stacked slots)")
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="BudgetAware admission multiplexing factor (>= 1)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="serve /metrics, /metrics.json and /healthz on "
                         "127.0.0.1:PORT (0 = ephemeral port; default off)")
    ap.add_argument("--trace-out", default=None,
                    help="export request and superstep spans as Chrome trace JSON")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="trace ring-buffer capacity (drop-oldest beyond)")
    ap.add_argument("--profile-supersteps", type=int, default=0,
                    help="bracket N warm supersteps in torch.profiler before the "
                         "timed serve (0 = off)")
    ap.add_argument("--profile-dir", default="results/profile",
                    help="--profile-supersteps output directory")
    ap.add_argument("--log-level", default="info",
                    choices=("debug", "info", "warning", "error"),
                    help="repro_torch.serving.* logger threshold")
    return ap


def _logging(args, quiet: bool = False) -> None:
    logging.basicConfig(format="%(levelname)s %(name)s: %(message)s")
    level = logging.ERROR if quiet else getattr(logging, args.log_level.upper())
    logging.getLogger("repro_torch.serving").setLevel(level)


def serve_rank(group, argv) -> dict | None:
    """One rank of the spawn ``main`` starts (``run_group``): the
    continuous engine model-parallel over ``group`` where the model flags
    ask for a model group, else the engine of ``--engine`` over the mesh
    of ``--mesh`` (``make_rank_mesh``).  Module-level, so a script can run
    it in a group of its own.  Rank 0 prints and returns the summary; the
    others print nothing and return None."""
    args = parser().parse_args(list(argv))
    _logging(args, quiet=group.rank > 0)
    if model_parallelism(args) > 1:
        def run():
            return run_continuous(args, group)
    else:
        if group.device.type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // group.world))
        mesh = make_rank_mesh(group, args.mesh)

        def run():
            return (run_fused if args.engine == "fused" else run_continuous)(args, mesh=mesh)
    if group.rank == 0:
        return run()
    with contextlib.redirect_stdout(io.StringIO()):
        run()
    return None


def main(argv=None) -> dict:
    ap = parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    refused = _refusal(args)
    if refused is not None:
        ap.error(refused)
    ranks, batch = math.prod(parse_mesh(args.mesh)[0]), _batch_ranks(args.mesh)
    if args.engine == "fused":  # as the JAX CLI, the fused sampler runs no model group
        if ranks > 1:
            if args.chains % batch:
                raise ValueError(f"--chains {args.chains} does not split over the {batch} "
                                 f"batch ranks of --mesh {args.mesh}: its size must be "
                                 f"divisible by {batch}")
            return run_group(serve_rank, ranks, args.device, (argv,))[0]
        _logging(args)
        return run_fused(args)
    if ranks > 1:
        _slots(args, batch)  # the JAX CLI's message, before any rank starts
    world = model_parallelism(args) if ranks == 1 else ranks
    if world > 1:
        return run_group(serve_rank, world, args.device, (argv,))[0]
    _logging(args)
    return run_continuous(args)


if __name__ == "__main__":
    main()
