"""Branched speculation in the port's packed and fused rounds and in
``ContinuousASDEngine``, against the JAX package's on the CPU: the same
slot states (``from_jax_chain_state``) or the same request keys, the same
weights.

Pack maps equal integer for integer; at B 2 and 3 integer state and
per-request counters (drafted points and branch counts included) equal,
the branch controller's state equal to the bit, samples within 1e-4.  At
covering and at shedding budgets; the min-1 grant sheds branches before
chains under all three allocators.  One branch is the single-branch round
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as j_ctl
from repro.core import schedules as j_sch
from repro.serving import packing as j_pack
from repro.serving.engine import ContinuousASDEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.metrics import EngineStats as JStats
from repro_torch.core import controller as t_ctl
from repro_torch.core import schedules as t_sch
from repro_torch.serving import packing as t_pack
from repro_torch.serving.engine import ContinuousASDEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.metrics import EngineStats, RequestMetrics
from tests.test_branched_speculation import _branch_split
from tests.test_torch_branched import CASES, assert_states_close, controllers, slot_states
from tests.test_torch_packed_round import SLOTS, THETA, smoke_case

ALLOCATORS = ("proportional", "waterfill", "priority")


# ---------------------------------------------------------------- pack maps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_branched_pack_maps_equal_jax(seed):
    rng = np.random.default_rng(seed)
    S, budget = 6, 40
    pts1 = rng.integers(0, 6, S)
    b_r = rng.integers(1, 4, S)
    while (pts1 * b_r).sum() > budget:
        pts1 = np.maximum(pts1 - 1, 0)
    jm = j_pack.build_branched_pack_maps(jnp.asarray(pts1, jnp.int32),
                                         jnp.asarray(b_r, jnp.int32), budget)
    tm = t_pack.build_branched_pack_maps(torch.from_numpy(pts1), torch.from_numpy(b_r), budget)
    for f in dataclasses.fields(tm):
        assert getattr(tm, f.name).tolist() == np.asarray(getattr(jm, f.name)).tolist(), f.name
    for nb, theta in ((3, 5), (4, 6)):
        assert tm.row_id(nb, theta).tolist() == np.asarray(jm.row_id(nb, theta)).tolist()
    # padding maps to the drop row one past the S * NB * theta table
    assert (tm.row_id(3, 5)[~tm.valid] == S * 3 * 5).all()


def test_branched_pack_maps_are_branch_major():
    """The JAX package's layout example: branch 0's window first; b_r 1
    everywhere is the single-branch maps with a zero branch lane."""
    pts1, b_r = torch.tensor([2, 3, 0, 1]), torch.tensor([2, 1, 1, 3])
    maps = t_pack.build_branched_pack_maps(pts1, b_r, 16)
    v = maps.valid
    assert int(v.sum()) == int(maps.total) == 10
    assert maps.slot_id[v].tolist() == [0, 0, 0, 0, 1, 1, 1, 3, 3, 3]
    assert maps.branch_id[v].tolist() == [0, 0, 1, 1, 0, 0, 0, 0, 1, 2]
    assert maps.step_id[v].tolist() == [0, 1, 0, 1, 0, 1, 2, 0, 0, 0]
    one = t_pack.build_branched_pack_maps(pts1, torch.ones(4, dtype=torch.long), 16)
    single = t_pack.build_pack_maps(pts1, 16)
    for name in ("offsets", "total", "slot_id", "step_id", "valid"):
        assert torch.equal(getattr(one, name), getattr(single, name)), name
    assert not one.branch_id.any()


@pytest.mark.parametrize("alloc", ALLOCATORS)
def test_min1_grant_sheds_branches_before_chains(alloc):
    """budget == chains: every chain keeps one point and every branch is
    shed, as in the JAX package (the grants equal its own)."""
    n1, b_live = np.full(4, 3), np.full(4, 2)
    demand = b_live * n1
    weights = np.ones(4, np.float32)
    tg = t_pack.make_allocator(alloc, theta_max=6).allocate(
        torch.from_numpy(demand), 4, torch.from_numpy(weights))
    jg = j_pack.make_allocator(alloc, theta_max=6).allocate(
        jnp.asarray(demand, jnp.int32), 4, jnp.asarray(weights))
    assert tg.tolist() == np.asarray(jg).tolist()
    assert int(tg.sum()) <= 4 and (tg >= 1).all()
    b_r, pts1 = _branch_split(jnp.asarray(np.asarray(tg), jnp.int32),
                              jnp.asarray(n1, jnp.int32), jnp.asarray(b_live, jnp.int32))
    assert (b_r == 1).all() and (pts1 == tg.numpy()).all()
    # budget 16 of 24: every chain gets its whole window before any extra
    # branch does
    tg = t_pack.make_allocator(alloc, theta_max=6).allocate(
        torch.from_numpy(demand), 16, torch.from_numpy(weights))
    assert (tg >= 3).all()


# ---------------------------------------------------------------- rounds


PACKED_CASES = {
    "gmm-packed-covering-B2-static-buffer": ("gmm", "packed", None, 2, "static", "buffer"),
    "smoke-packed-shedding-B3-gain-counter": ("smoke", "packed", 7, 3, "gain", "counter"),
    "smoke-fused-covering-B3-gain-buffer": ("smoke", "fused", None, 3, "gain", "buffer"),
    "gmm-fused-shedding-B2-static-counter": ("gmm", "fused", 6, 2, "static", "counter"),
    "gmm-packed-min1-B3-gain-buffer": ("gmm", "packed", SLOTS, 3, "gain", "buffer"),
    "smoke-fused-shedding-B2-gain-tuned-buffer": ("smoke", "fused", 9, 2, "gain-tuned",
                                                  "buffer"),
}


def _run_packed(case, jst, tst, nb, ctl, noise_mode, *, rounds, budget, round_impl,
                eager=True, budget_data=None):
    jc, tc = controllers(ctl)
    weights = np.array([1.0, 2.0, 1.0, 1.5], np.float32)
    jout = jax.jit(lambda st: j_pack.packed_superstep(
        case.j_make, None, case.js, st, None, jnp.asarray(weights), rounds=rounds,
        theta=THETA, budget=budget,
        allocator=j_pack.WaterfillingAllocator(theta_max=THETA * nb), eager_head=eager,
        noise_mode=noise_mode, keep_trajectory=False, round_impl=round_impl,
        budget_data=None if budget_data is None else jnp.int32(budget_data),
        num_branches=nb, branch_controller=jc))(jst)
    tout = t_pack.packed_superstep(
        case.t_fn, case.ts, tst, None, torch.from_numpy(weights), rounds=rounds,
        theta=THETA, budget=budget,
        allocator=t_pack.WaterfillingAllocator(theta_max=THETA * nb), eager_head=eager,
        noise_mode=noise_mode, keep_trajectory=False, round_impl=round_impl,
        budget_data=budget_data, num_branches=nb, branch_controller=tc)
    return jout, tout


@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_branched_packed_superstep_matches_jax(name):
    model, impl, budget, nb, ctl, noise_mode = PACKED_CASES[name]
    case = CASES[model]()
    budget = budget or SLOTS * THETA * nb
    jst, tst = slot_states(case, nb, ctl, noise_mode, seed=6)
    jout, tout = _run_packed(case, jst, tst, nb, ctl, noise_mode, rounds=3, budget=budget,
                             round_impl=impl)
    assert_states_close(jout, tout, case.tol, name)
    spent = tout.draft_points - tst.draft_points
    assert int(spent.sum()) <= 3 * budget
    if budget < SLOTS * THETA:  # shedding: some round ran fewer branches
        assert int(spent.sum()) < int((tout.proposals - tst.proposals).sum()) * nb


def test_branched_fused_budget_data_and_no_eager_head_match_jax():
    case, nb = smoke_case(), 2
    jst, tst = slot_states(case, nb, "gain", "counter", seed=7)
    jout, tout = _run_packed(case, jst, tst, nb, "gain", "counter", rounds=2,
                             budget=SLOTS * THETA * nb, budget_data=10, round_impl="fused")
    assert_states_close(jout, tout, case.tol, "budget_data")
    jout, tout = _run_packed(case, jst, tst, nb, "static", "counter", rounds=2, budget=12,
                             round_impl="packed", eager=False)
    assert_states_close(jout, tout, case.tol, "no eager head")


@pytest.mark.parametrize("round_impl", ["packed", "fused"])
def test_one_branch_is_the_single_branch_packed_round(round_impl):
    case = smoke_case()
    _, tst = slot_states(case, 1, seed=8)
    kw = dict(rounds=2, theta=THETA, budget=6, round_impl=round_impl,
              allocator=t_pack.WaterfillingAllocator(theta_max=THETA))
    plain = t_pack.packed_superstep(case.t_fn, case.ts, tst, None, torch.ones(SLOTS), **kw)
    one = t_pack.packed_superstep(case.t_fn, case.ts, tst, None, torch.ones(SLOTS),
                                  num_branches=1, branch_controller=t_ctl.GainBranches(),
                                  **kw)
    for f in dataclasses.fields(one):
        if getattr(plain, f.name) is not None:
            assert torch.equal(getattr(plain, f.name), getattr(one, f.name)), f.name


@pytest.mark.parametrize("nb", [2, 3])
def test_branched_packed_and_fused_give_equal_bits(nb):
    """Both round_impls move the same rows through the same GRS row code."""
    case = smoke_case()
    _, tst = slot_states(case, nb, "gain", seed=9)
    outs = [t_pack.packed_superstep(
        case.t_fn, case.ts, tst, None, torch.ones(SLOTS), rounds=3, theta=THETA, budget=9,
        allocator=t_pack.WaterfillingAllocator(theta_max=THETA * nb), round_impl=impl,
        num_branches=nb, branch_controller=t_ctl.GainBranches()) for impl in ("packed",
                                                                               "fused")]
    for f in dataclasses.fields(outs[0]):
        if getattr(outs[0], f.name) is not None:
            assert torch.equal(getattr(outs[0], f.name), getattr(outs[1], f.name)), f.name


# ---------------------------------------------------------------- engine


K_ENGINE, N_REQ = 20, 6
ENGINE_CASES = {
    "unpacked-B2-static-counter": (dict(), 2, "static", "counter"),
    "unpacked-B3-gain-buffer": (dict(rounds_per_sync=2), 3, "gain", "buffer"),
    "packed-B2-gain-counter-shedding": (dict(execution="packed", round_budget=10), 2, "gain",
                                        "counter"),
    "fused-B3-static-counter-auto": (dict(execution="packed", round_impl="fused",
                                          round_budget="auto", rounds_per_sync=2), 3,
                                     "static", "counter"),
    "fused-B2-gain-buffer-covering": (dict(execution="packed", round_impl="fused"), 2, "gain",
                                      "buffer"),
}


@pytest.fixture(scope="module")
def smoke():
    case = smoke_case()
    return dict(case=case, js=j_sch.sl_geometric(K_ENGINE, 0.05, 10.0),
                ts=t_sch.sl_geometric(K_ENGINE, 0.05, 10.0))


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_branched_engine_matches_jax(smoke, name):
    """6 requests on 4 slots, odd ones keyed, the rest fold_in(serve key,
    rid): per-request counters (drafted points included) equal, samples
    within 1e-4, the same rounds, supersteps and budget tier."""
    kw, nb, ctl, noise_mode = ENGINE_CASES[name]
    case = smoke["case"]
    jc, tc = controllers(ctl)
    common = dict(num_slots=SLOTS, theta=THETA, seed=3, noise_mode=noise_mode,
                  num_branches=nb, **kw)
    jeng = JEngine(lambda cond: case.j_make(None, None), smoke["js"], case.event,
                   branch_controller=jc, **common)
    teng = TEngine(case.t_fn, smoke["ts"], case.event, branch_controller=tc, device="cpu",
                   **common)
    keys = {i: jax.random.PRNGKey(500 + i) for i in range(1, N_REQ, 2)}
    jout = jeng.serve([JRequest(i, key=keys.get(i)) for i in range(N_REQ)])
    tout = teng.serve([TRequest(i, key=None if i not in keys else np.asarray(keys[i]))
                       for i in range(N_REQ)])
    assert sorted(tout) == sorted(jout) == list(range(N_REQ))
    jm = {m.rid: m for m in jeng.stats.per_request}
    tm = {m.rid: m for m in teng.stats.per_request}
    for rid in range(N_REQ):
        for f in ("rounds", "head_calls", "model_evals", "accepts", "proposals",
                  "draft_points"):
            assert getattr(tm[rid], f) == getattr(jm[rid], f), (rid, f)
        np.testing.assert_allclose(tout[rid], np.asarray(jout[rid]), rtol=1e-4, atol=1e-4)
    assert (teng.stats.rounds_total, teng.stats.supersteps, teng.round_budget) == (
        jeng.stats.rounds_total, jeng.stats.supersteps, jeng.round_budget)
    assert teng.stats.draft_points_total > teng.stats.proposals_total
    assert teng.stats.branch_accept_depth() == pytest.approx(jeng.stats.branch_accept_depth())
    assert teng.stats.wasted_draft_frac() == pytest.approx(jeng.stats.wasted_draft_frac())
    if kw.get("execution") == "packed" and kw.get("round_budget") is None:
        assert teng.round_budget == SLOTS * THETA * nb  # the covering budget


def test_worker_scales_the_budget_by_branches(smoke):
    case = smoke["case"]
    eng = TEngine(case.t_fn, smoke["ts"], case.event, num_slots=SLOTS, theta=THETA,
                  execution="packed", round_budget="auto", num_branches=3,
                  branch_controller=t_ctl.StaticBranches(value=2), device="cpu")
    assert eng._budget_ladder[-1] == SLOTS * THETA * 3
    assert eng.allocator.theta_max == THETA * 3
    assert eng._points_open == THETA * 2  # the opening window times branches


# ---------------------------------------------------------------- metrics


def test_branch_lanes_equal_jax_and_idle_is_zero():
    t, j = EngineStats(), JStats()
    assert t.wasted_draft_frac() == 0.0 and t.branch_accept_depth() == 0.0
    assert RequestMetrics(rid=0, queue_latency=0.0, service_time=0.0, rounds=0, head_calls=0,
                          model_evals=0, accepts=0, proposals=0).wasted_draft_frac == 0.0
    from repro.serving.metrics import RequestMetrics as JRM
    for rid, (r, a, p, d) in enumerate([(5, 12, 20, 40), (7, 9, 30, 30)]):
        kw = dict(rid=rid, queue_latency=0.1, service_time=0.2, rounds=r, head_calls=r,
                  model_evals=d + r, accepts=a, proposals=p, draft_points=d)
        t.observe(RequestMetrics(**kw))
        j.observe(JRM(**kw))
    assert t.draft_points_total == j.draft_points_total == 70
    assert t.branch_accept_depth() == j.branch_accept_depth()
    assert t.wasted_draft_frac() == j.wasted_draft_frac()
    assert [m.wasted_draft_frac for m in t.per_request] == pytest.approx([0.7, 0.7])
    assert t.summary()["branch_accept_depth"] == j.summary()["branch_accept_depth"]
