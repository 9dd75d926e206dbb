"""The ranks' side of ``tests/test_torch_model_parallel.py``: what each rank of
a two-rank model group computes, in a module that imports no JAX (the
ranks are spawned processes, and import this module by name).

``rank_cases(group, inputs)`` runs every sharded forward and engine of the
test module on this rank, from the numpy inputs the test wrote (params as a
flat ``{"<config>/<path>": array}`` map), and returns numpy results."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs.registry import get_denoiser_config
from repro_torch.core import schedules as t_sch
from repro_torch.distributed.group import MeshGroups
from repro_torch.distributed.sharding import mp_param_pspecs, shard_params
from repro_torch.launch.mesh import Mesh
from repro_torch.models.diffusion import (denoiser_fwd, make_ddpm_model_fn,
                                          mp_collective_payloads)
from repro_torch.nn.param import param_axes
from repro_torch.serving.router import make_router
from repro_torch.serving.scheduler import make_policy
from repro_torch.serving.sharded import ShardedASDEngine
from repro_torch.serving.worker import Request
from repro_torch.weights import from_jax_params, param_shapes

POLICY, MOE = "paper-diffusion-policy-smoke", "qwen3-moe-a3b-smoke"
# name -> (config, seq_len (None: the config's), tensor, expert, sp)
FORWARDS = {
    "tp2": (POLICY, None, True, False, 1),
    "sp2": (POLICY, None, False, False, 2),
    "ep2": (MOE, None, False, True, 1),
    "ep2_sp2": (MOE, None, False, True, 2),
    "ep2_odd_L": (MOE, 7, False, True, 1),  # L % mp: the exchange-free EP
}
# name -> (config, tensor, expert, sp, engine kwargs): all on the MoE
# config, so that one JAX replicated engine is the reference of every one
ENGINES = {
    "tp2_ep2": (MOE, True, True, 1, {}),
    "ep2_sp2_fused": (MOE, False, True, 2, dict(
        shards=2, dispatch="fused", execution="packed", round_impl="fused",
        round_budget=2 * 4)),
}
K, THETA, SLOTS, N_REQ = 10, 4, 4, 4
# engines run a second time to hold their bits (one: each run costs seconds)
RERUN = ("tp2_ep2",)
COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals")


def config(name: str, seq_len=None):
    dc = get_denoiser_config(name)
    return dc if seq_len is None else dataclasses.replace(dc, seq_len=seq_len)


def params_tree(flat: dict, name: str, dc):
    """The numpy params of config ``name`` from the flat map, as a tree."""
    shapes = param_shapes(dc)
    leaves = [flat[f"{name}/{'/'.join(path)}"] for path, _ in pytree.paths(shapes)]
    return pytree.unflatten(shapes, leaves)


def layout(dc, world: int, tensor: bool, expert: bool):
    return mp_param_pspecs(param_axes(dc), param_shapes(dc), Mesh((world,), ("model",), ()),
                           tensor=tensor, expert=expert)


def axes_of(group, tensor, expert, sp):
    return dict(tp_axis=group if tensor and sp == 1 else None,
                sp_axis=group if sp > 1 else None, sp_size=sp,
                ep_axis=group if expert else None)


def requests(dc, seed0=100, n=N_REQ):
    rng = np.random.default_rng(seed0)
    return [Request(i, key=np.array([0, seed0 + i], np.uint32),
                    y0=rng.standard_normal((dc.seq_len, dc.d_data)).astype(np.float32))
            for i in range(n)]


def engine(group, dc, params, tensor, expert, sp, **kw):
    specs = layout(dc, group.world, tensor, expert)
    mp = axes_of(group, tensor, expert, sp)
    return ShardedASDEngine(
        lambda p: make_ddpm_model_fn(p, dc, **mp), t_sch.ddpm(K), (dc.seq_len, dc.d_data),
        num_slots=SLOTS, model_shards=group.world, model_group=group, params=params,
        param_specs=specs, collective_payloads=mp_collective_payloads(
            params, specs, dc, mp_size=group.world, sp_size=sp),
        router=make_router("round-robin"), device="cpu", theta=THETA, eager_head=True,
        noise_mode="counter", keep_trajectory=False, **kw)


def counters(eng) -> dict:
    return {m.rid: tuple(getattr(m, c) for c in COUNTERS) for m in eng.stats.per_request}


def rank_cases(group, inputs: str) -> dict:
    torch.set_num_threads(1)  # two ranks share the test's CPU
    data = dict(np.load(inputs))
    out = {"rank": group.rank, "forwards": {}, "engines": {}, "shards": {},
           "collectives": collectives(group), "deadline": deadline_case(group, data)}
    for name, (cfg, L, tensor, expert, sp) in FORWARDS.items():
        dc = config(cfg, L)
        params = from_jax_params(params_tree(data, cfg, dc), dc, "cpu")
        local = shard_params(params, layout(dc, group.world, tensor, expert),
                             MeshGroups((group.world,), ("model",), group.rank))
        t, y = (torch.from_numpy(data[f"{name}/{k}"]) for k in ("t", "y"))
        mp = axes_of(group, tensor, expert, sp)
        runs = [denoiser_fwd(local, t, y, dc, **mp).numpy() for _ in range(2)]
        out["forwards"][name] = runs
        out["shards"][name] = {
            ".".join(path): (tuple(leaf.shape), tuple(pytree_get(params, path).shape),
                             leaf is pytree_get(params, path))
            for path, leaf in pytree.paths(local)}
    for name, (cfg, tensor, expert, sp, kw) in ENGINES.items():
        dc = config(cfg)
        params = from_jax_params(params_tree(data, cfg, dc), dc, "cpu")
        runs = []
        for _ in range(2 if name in RERUN else 1):
            eng = engine(group, dc, params, tensor, expert, sp, **kw)
            samples = eng.serve(requests(dc))
            s = eng.stats
            runs.append(dict(
                samples=samples, counters=counters(eng),
                collective=[(w.stats.collective_s, w.stats.collective_psum_s,
                             w.stats.collective_a2a_s) for w in eng.workers],
                merged=(s.collective_s, s.collective_psum_s, s.collective_a2a_s),
                breakdown=s.timing_breakdown(), eager=[w._eager for w in eng.workers]))
        out["engines"][name] = runs
    return out


def deadline_case(group, data) -> dict:
    """Six requests on four slots under the deadline policy: rids 4 and 5
    queue behind the first four, with deadlines that differ by rank (on
    rank 0 rid 4's has passed and rid 5's is far off, on rank 1 the other
    way round).  Each rank's own policy would drop a different request;
    the ranks follow rank 0's decision."""
    dc = config(POLICY)
    params = from_jax_params(params_tree(data, POLICY, dc), dc, "cpu")
    eng = engine(group, dc, params, True, False, 1,
                 policy=make_policy("deadline", drop_late=True))
    reqs = requests(dc, n=6)
    for r in reqs[:4]:
        eng.submit(r)
    eng.step()  # a warm round: the policy has a seconds-per-round estimate
    late, far = (4, 5) if group.rank == 0 else (5, 4)
    reqs[late].deadline, reqs[far].deadline = 0.0, time.perf_counter() + 1e6
    for r in reqs[4:]:
        eng.submit(r)
    while eng.step():
        pass
    return dict(samples=eng.drain_results(), counters=counters(eng),
                dropped=[rid for w in eng.workers for rid in w.dropped_rids])


def pytree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def raise_on_rank_1(group):
    """A rank function whose rank 1 raises while rank 0 waits for it in a
    collective."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails")
    group.psum(torch.zeros(1))
    return group.rank


def collectives(group) -> dict:
    """The group's collectives on small tensors whose every element names
    its rank and position (rank r holds x + 100 r)."""
    x = torch.arange(24, dtype=torch.float32).view(2, 3, 4) + 100 * group.rank
    return dict(x=x, psum=group.psum(x), pmean=group.pmean(x),
                psum_bf16=group.psum(x.to(torch.bfloat16)),
                gather0=group.all_gather(x, 0), gather2=group.all_gather(x, 2),
                a2a_2_0=group.all_to_all(x, 2, 0), a2a_0_1=group.all_to_all(x, 0, 1),
                a2a_ints=group.all_to_all(x.long(), 2, 2),
                floats=group.broadcast_floats([group.rank + 0.5, -1.0]),
                index=group.axis_index())
