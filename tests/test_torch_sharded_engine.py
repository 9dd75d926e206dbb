"""``ShardedASDEngine`` against the JAX package's, and against the port's
own single-shard and per-shard runs, on the CPU: the analytic GMM mean
oracle on a uniform schedule, keyed requests (both packages draw each
chain's noise from its key).

  * shards 1 is ``ContinuousASDEngine`` per ``ASDChainState`` field at every
    boundary, and within 1e-5 of JAX's ``ShardedASDEngine(shards=1)``;
  * shards 2 and 4 with per-shard dispatch (unpacked, and packed at a
    covering per-shard budget): per request within 1e-5 of JAX's per-shard
    engine with counters and ``routed_counts`` equal, and equal in bits to
    the port's single-shard run;
  * fused dispatch equals per-shard dispatch in bits and counters (binding
    budgets, ``round_impl="fused"`` with auto budgets and auto R too)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import analytic as j_an
from repro.core import schedules as j_sch
from repro.serving.engine import Request as JRequest
from repro.serving.router import make_router as j_router
from repro.serving.sharded import ShardedASDEngine as JSharded
from repro_torch.core import analytic as t_an
from repro_torch.core import controller as t_ctl
from repro_torch.core import schedules as t_sch
from repro_torch.serving.engine import ContinuousASDEngine, Request
from repro_torch.serving.router import make_router
from repro_torch.serving.sharded import ShardedASDEngine

K, THETA, SLOTS, N_REQ, TOL = 16, 5, 4, 9, 1e-5
COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals", "draft_points")
_BASE = dict(theta=THETA, eager_head=True, keep_trajectory=True)
_T_MODEL = t_an.sl_mean_fn(t_an.default_gmm(2))
_J_MODEL = j_an.sl_mean_fn(j_an.default_gmm(2))


def _keys(n, seed0=100):
    return [jax.random.PRNGKey(seed0 + i) for i in range(n)]


def _t_requests(n=N_REQ, seed0=100):
    return [Request(i, key=np.asarray(k), y0=np.zeros((2,), np.float32))
            for i, k in enumerate(_keys(n, seed0))]


def _j_requests(n=N_REQ, seed0=100):
    return [JRequest(i, key=k, y0=np.zeros((2,), np.float32))
            for i, k in enumerate(_keys(n, seed0))]


def _port(shards=1, num_slots=SLOTS, router="round-robin", **kw):
    return ShardedASDEngine(_T_MODEL, t_sch.sl_uniform(K, t_max=8.0), (2,),
                            num_slots=num_slots, shards=shards, router=make_router(router),
                            device="cpu", **dict(_BASE, **kw))


def _jax(shards=1, router="round-robin", **kw):
    return JSharded(lambda cond: _J_MODEL, j_sch.sl_uniform(K, t_max=8.0), (2,),
                    num_slots=SLOTS, shards=shards, router=j_router(router),
                    **dict(_BASE, **kw))


def _metrics(eng):
    return {m.rid: tuple(getattr(m, c) for c in COUNTERS) for m in eng.stats.per_request}


def _assert_bits(a, b):
    assert sorted(a) == sorted(b) == list(range(N_REQ))
    for rid in a:
        assert np.array_equal(a[rid], b[rid]), rid


def _assert_close(t, j):
    assert sorted(t) == sorted(j) == list(range(N_REQ))
    for rid in t:
        np.testing.assert_allclose(t[rid], np.asarray(j[rid]), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def single():
    """The port's single-shard reference: unpacked, and packed at the
    covering budget of 4 slots."""
    out = {}
    for name, kw in (("unpacked", {}), ("packed", dict(execution="packed",
                                                       round_budget=SLOTS * THETA))):
        eng = ContinuousASDEngine(_T_MODEL, t_sch.sl_uniform(K, t_max=8.0), (2,),
                                  num_slots=SLOTS, device="cpu", **_BASE, **kw)
        out[name] = (eng.serve(_t_requests()), _metrics(eng))
    return out


def test_shards_1_is_the_continuous_engine_per_field_and_close_to_jax(single):
    eng = ContinuousASDEngine(_T_MODEL, t_sch.sl_uniform(K, t_max=8.0), (2,),
                              num_slots=SLOTS, device="cpu", **_BASE)
    sh = _port(shards=1)
    for r in _t_requests(7, seed0=400):
        eng.submit(r)
        sh.submit(r)
    more = True
    while more:
        more, more_sh = eng.step(), sh.step()
        assert more == more_sh
        for f in dataclasses.fields(eng._states):
            a, b = getattr(eng._states, f.name), getattr(sh.workers[0]._states, f.name)
            assert (a is None and b is None) or torch.equal(a, b), f.name
    assert sorted(eng.drain_results()) == sorted(sh.drain_results()) == list(range(7))

    out, jeng = _port(shards=1).serve(_t_requests()), _jax(shards=1)
    jout = jeng.serve(_j_requests())
    _assert_close(out, jout)
    _assert_bits(out, single["unpacked"][0])


@pytest.mark.parametrize("execution", ["unpacked", "packed"])
@pytest.mark.parametrize("shards", [2, 4])
def test_more_shards_match_jax_and_the_single_shard_bits(single, shards, execution):
    kw = ({} if execution == "unpacked"
          else dict(execution="packed", round_budget=SLOTS // shards * THETA))
    eng = _port(shards=shards, **kw)
    out = eng.serve(_t_requests())
    jeng = _jax(shards=shards, **kw)
    jout = jeng.serve(_j_requests())
    _assert_close(out, jout)
    jm = {m.rid: tuple(getattr(m, c) for c in COUNTERS) for m in jeng.stats.per_request}
    assert _metrics(eng) == jm
    assert eng.routed_counts.tolist() == jeng.routed_counts.tolist()
    assert (eng.routed_counts > 0).all()
    assert (eng.stats.retired, eng.stats.rounds_total) == (jeng.stats.retired,
                                                           jeng.stats.rounds_total)
    # sharding is scheduling: the single-shard run's bits and counters
    ref_out, ref_m = single[execution]
    _assert_bits(out, ref_out)
    assert _metrics(eng) == ref_m


FUSED_CASES = {
    "unpacked-2": (2, {}),
    "packed-binding-R2-2": (2, dict(execution="packed", round_budget=7, rounds_per_sync=2)),
    "packed-binding-4": (4, dict(execution="packed", round_budget=3)),
    "fused-round-auto-budget-2": (2, dict(execution="packed", round_impl="fused",
                                          round_budget="auto",
                                          controller="accept-rate")),
    "fused-round-auto-budget-auto-R-4": (4, dict(execution="packed", round_impl="fused",
                                                 round_budget="auto",
                                                 rounds_per_sync="auto")),
}


@pytest.mark.parametrize("name", sorted(FUSED_CASES))
def test_fused_dispatch_equals_per_shard_dispatch(name):
    shards, kw = FUSED_CASES[name]
    kw = dict(kw)
    if "controller" in kw:
        kw["controller"] = t_ctl.make_controller(kw["controller"])
    runs = {}
    for dispatch in ("per-shard", "fused"):
        eng = _port(shards=shards, num_slots=8, router="least-loaded", dispatch=dispatch,
                    **kw)
        runs[dispatch] = (eng.serve(_t_requests(13)), _metrics(eng), eng.routed_counts)
    (a, am, ar), (b, bm, br) = runs["per-shard"], runs["fused"]
    assert sorted(a) == sorted(b) == list(range(13))
    for rid in a:
        assert np.array_equal(a[rid], b[rid]), rid
    assert am == bm and ar.tolist() == br.tolist()


def test_fused_dispatch_and_auto_budget_need_the_fused_round_as_in_jax():
    kw = dict(shards=2, dispatch="fused", execution="packed", round_budget="auto")
    with pytest.raises(ValueError, match="round_impl"):
        _port(**kw)
    with pytest.raises(ValueError):
        _jax(**kw)
    _port(round_impl="fused", **kw)  # budget-as-data carries the tiers


def test_a_points_row_of_the_denoiser_is_the_same_bits_in_any_batch():
    """The denoiser's per-point products run in fixed row blocks, so a
    point's output row does not depend on the batch it rides in: 2 shards
    of the smoke denoiser (nonzero out_proj) give the single-shard bits,
    packed at the covering budget."""
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.models.diffusion import _point_product, make_sl_model_fn
    from repro_torch.weights import init_denoiser_params

    x, w = torch.randn(37, 256), torch.randn(256, 64)
    for n in (1, 5, 16, 17):
        assert torch.equal(_point_product(x, w)[:n], _point_product(x[:n], w))
    dc = paper_diffusion_policy_smoke()
    model = make_sl_model_fn(init_denoiser_params(dc, 0, out_scale=1.0, device="cpu"), dc)
    outs = []
    for shards in (1, 2):
        eng = ShardedASDEngine(model, t_sch.sl_geometric(K, 0.05, 10.0),
                               (dc.seq_len, dc.d_data), num_slots=SLOTS, shards=shards,
                               router=make_router("round-robin"), device="cpu",
                               execution="packed", round_budget=SLOTS // shards * THETA,
                               theta=THETA, eager_head=True)
        outs.append((eng.serve([Request(i, key=np.array([0, 50 + i], np.uint32))
                                for i in range(6)]), _metrics(eng)))
    (a, am), (b, bm) = outs
    assert sorted(a) == sorted(b) == list(range(6)) and am == bm
    assert all(np.array_equal(a[r], b[r]) for r in a)
    assert sum(m[3] for m in am.values()) < sum(m[4] for m in am.values())  # rejections
