"""The sharded front end's pieces against the JAX package's, on the CPU:
the routers (the same shard on the same stub workers), ``allocate_sharded``
and ``build_sharded_pack_maps`` (equal as integers, shard-local slots) and
``EngineStats.merged`` (equal to JAX's on the same per-shard stats).
``sharded_packed_superstep`` is held in ``test_torch_sharded_superstep.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import packing as j_pack
from repro.serving import router as j_router
from repro.serving.metrics import EngineStats as JStats
from repro.serving.metrics import RequestMetrics as JRM
from repro_torch.serving import packing as t_pack
from repro_torch.serving import router as t_router
from repro_torch.serving.metrics import EngineStats, RequestMetrics
from tests.test_torch_packed_round import THETA

SHARDS = 3


# ---------------------------------------------------------------- routers


class _Stub:
    """What a router reads of a worker: its load and its scheduler."""

    def __init__(self, load, free=1):
        self.load = load
        self.scheduler = type("S", (), {"free_slots": lambda s: [0] * free,
                                        "queue_depth": 0})()


class _Req:
    def __init__(self, deadline=None):
        self.deadline = deadline


@pytest.mark.parametrize("name", sorted(j_router.ROUTERS))
def test_routers_pick_the_shard_jax_picks(name):
    """A seeded stream of loads (ties included) and requests with and
    without deadlines: every pick equal, stateful routers included."""
    assert sorted(t_router.ROUTERS) == sorted(j_router.ROUTERS)
    jr, tr = j_router.make_router(name), t_router.make_router(name)
    assert tr.name == jr.name == name
    rng = np.random.default_rng(0)
    picks = []
    for step in range(200):
        n = int(rng.integers(1, 6))
        loads = rng.choice([0.0, 0.25, 0.5, 1.0, 1.5, 2.0], size=n)
        workers = [_Stub(float(x)) for x in loads]
        req = _Req(deadline=None if rng.random() < 0.5 else float(step))
        j, t = jr.route(req, workers), tr.route(req, workers)
        assert t == j, (step, loads.tolist(), req.deadline)
        picks.append(t)
    assert len(set(picks)) > 2


def test_router_behaviours():
    rr = t_router.RoundRobin()
    assert [rr.route(None, [0, 0, 0]) for _ in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    ll = t_router.LeastLoaded()
    assert ll.route(None, [_Stub(0.5), _Stub(0.25), _Stub(0.25)]) == 1
    da = t_router.DeadlineAware()
    ws = [_Stub(0.0), _Stub(0.75), _Stub(1.5)]
    assert da.route(_Req(deadline=1.0), ws) == 0  # urgent: least loaded
    assert da.route(_Req(), ws) == 1  # best effort: busiest with room
    assert da.route(_Req(), [_Stub(1.0), _Stub(2.0)]) == 0  # all saturated


def test_make_router_refuses_an_unknown_name_as_jax_does():
    for mk in (j_router.make_router, t_router.make_router):
        with pytest.raises(ValueError, match="unknown router"):
            mk("random")


# ---------------------------------------------------------------- allocation


def _demands(seed, s_local=6, theta=THETA):
    rng = np.random.default_rng(seed)
    demand = rng.integers(0, theta + 1, size=(SHARDS, s_local)).astype(np.int32)
    demand[0, :2] = 0  # retired slots
    weights = rng.uniform(0.5, 3.0, size=(SHARDS, s_local)).astype(np.float32)
    weights[1, :3] = 1.0  # equal weights: the stable sort's ties
    # binding, generous and minimal budgets, one a shard
    budgets = np.array([demand[0].sum() // 2 + 1, demand[1].sum() + 3, s_local], np.int32)
    return demand, weights, budgets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(j_pack.ALLOCATORS))
def test_allocate_sharded_equals_jax_and_is_per_row(name, seed):
    demand, weights, budgets = _demands(seed)
    ja = j_pack.make_allocator(name, theta_max=THETA)
    ta = t_pack.make_allocator(name, theta_max=THETA)
    jg = np.asarray(ja.allocate_sharded(jnp.asarray(demand), jnp.asarray(budgets),
                                        jnp.asarray(weights)))
    tg = ta.allocate_sharded(torch.from_numpy(demand), torch.from_numpy(budgets),
                             torch.from_numpy(weights))
    assert tg.shape == (SHARDS, demand.shape[1])
    assert tg.tolist() == jg.tolist()
    for i in range(SHARDS):  # each row is that shard's own allocation
        row = ta.allocate(torch.from_numpy(demand[i]), int(budgets[i]),
                          torch.from_numpy(weights[i]))
        assert tg[i].tolist() == row.tolist()
        assert int(tg[i].sum()) <= max(int(budgets[i]), 0)
        assert (tg[i] <= torch.from_numpy(demand[i])).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_pack_maps_equal_jax_and_are_shard_local(seed):
    demand, weights, budgets = _demands(seed)
    grants = t_pack.WaterfillingAllocator(theta_max=THETA).allocate_sharded(
        torch.from_numpy(demand), torch.from_numpy(budgets), torch.from_numpy(weights))
    width = int(grants.sum(1).max()) + 2
    jmaps = j_pack.build_sharded_pack_maps(jnp.asarray(grants.numpy().astype(np.int32)),
                                           width)
    tmaps = t_pack.build_sharded_pack_maps(grants, width)
    for f in dataclasses.fields(tmaps):
        t, j = getattr(tmaps, f.name), np.asarray(getattr(jmaps, f.name))
        assert t.shape[0] == SHARDS, f.name
        assert t.tolist() == j.tolist(), f.name
    s_local = demand.shape[1]
    assert ((tmaps.slot_id >= 0) & (tmaps.slot_id < s_local)).all()
    for i in range(SHARDS):  # row i is build_pack_maps on shard i's grants
        one = t_pack.build_pack_maps(grants[i], width)
        assert torch.equal(tmaps.slot_id[i], one.slot_id)
        assert torch.equal(tmaps.valid[i], one.valid)


# ---------------------------------------------------------------- merged stats


def _shard_stats(cls, rm_cls, shard, rids, **health):
    s = cls(shard=shard)
    for k, rid in enumerate(rids):
        s.observe(rm_cls(rid=rid, queue_latency=0.01 * k, service_time=0.1 + k,
                         rounds=3 + k, head_calls=2 + k, model_evals=10 + k, accepts=4 + k,
                         proposals=6 + k, draft_points=8 + k,
                         deadline=None if k % 2 else 5.0, slo_met=None if k % 2 else True))
    s.requests, s.rounds_total, s.supersteps = len(rids) + 1, 7 + shard, 3
    s.dispatch_s, s.device_s, s.host_sync_s, s.wall_time = 0.5, 0.25 * shard, 0.125, 2.0 + shard
    s.dropped = shard
    for k, v in health.items():
        setattr(s, k, v)
    return s


_HEALTH = [dict(queue_depth=2, queue_depth_peak=5, slot_occupancy=0.5,
                admission_pressure=0.75, draining=False),
           dict(queue_depth=1, queue_depth_peak=9, slot_occupancy=1.0,
                admission_pressure=1.5, draining=True),
           dict(queue_depth=0, queue_depth_peak=1, slot_occupancy=0.25,
                admission_pressure=0.1, draining=False)]


@pytest.mark.parametrize("wall", [None, 3.5])
def test_merged_stats_equal_jax(wall):
    rids = [[0, 3, 4], [1, 5], [2]]
    t = EngineStats.merged([_shard_stats(EngineStats, RequestMetrics, i, r, **h)
                            for i, (r, h) in enumerate(zip(rids, _HEALTH))], wall_time=wall)
    j = JStats.merged([_shard_stats(JStats, JRM, i, r, **h)
                       for i, (r, h) in enumerate(zip(rids, _HEALTH))], wall_time=wall)
    # gather_s: the port's measured lane of the boundary gathers over batch
    # ranks, which the JAX engine (one program over the mesh) has not
    shared = {f.name for f in dataclasses.fields(EngineStats)} - {"per_request", "gather_s"}
    assert shared <= {f.name for f in dataclasses.fields(JStats)}
    for name in sorted(shared):
        assert getattr(t, name) == pytest.approx(getattr(j, name)), name
    assert [m.rid for m in t.per_request] == [m.rid for m in j.per_request]
    assert t.summary()["accept_rate"] == j.summary()["accept_rate"]
    assert t.slo_attainment() == j.slo_attainment()
    assert t.wall_time == (wall if wall is not None else 4.0)
    assert (t.queue_depth, t.queue_depth_peak, t.draining) == (3, 9, True)


def test_merged_refuses_a_duplicate_rid_and_keeps_fused_dispatch_on_the_merged_view():
    a = _shard_stats(EngineStats, RequestMetrics, 0, [0, 1])
    b = _shard_stats(EngineStats, RequestMetrics, 1, [1])
    with pytest.raises(ValueError, match=r"duplicate request ids .*\[1\]"):
        EngineStats.merged([a, b])
    with pytest.raises(ValueError):
        JStats.merged([_shard_stats(JStats, JRM, 0, [0, 1]), _shard_stats(JStats, JRM, 1, [1])])
    assert a.fused_dispatch_s == 0.0 and EngineStats().merged([]).retired == 0
    m = EngineStats.merged([a])
    m.fused_dispatch_s += 0.25
    tb = m.timing_breakdown()
    assert tb["fused_dispatch_s"] == 0.25 and a.timing_breakdown()["fused_dispatch_s"] == 0.0
    assert tb["fused_dispatch_frac"] == pytest.approx(0.25 / max(m.wall_time, 0.25 + 0.5
                                                                  + 0.0 + 0.125))
