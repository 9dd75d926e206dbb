"""The port's continuous ASD engine against the JAX package's, on the CPU:
5 requests on 2 slots of the smoke denoiser, each request with the noise
the JAX engine draws from its key (``init_chain_state``), handed to the
port as ``u_buf`` / ``xi_buf``.

Per request, rounds, accepts and proposals must be equal and samples
within 1e-4; the FCFS admission order (superstep round, slot, request) must
be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import analytic as j_an
from repro.core import asd as j_asd
from repro.core import schedules as j_sch
from repro.models.diffusion import make_sl_model_fn as j_make_sl
from repro.serving.engine import ContinuousASDEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import analytic as t_an
from repro_torch.core import schedules as t_sch
from repro_torch.models.diffusion import make_sl_model_fn as t_make_sl
from repro_torch.serving.engine import ContinuousASDEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.weights import from_jax_params
from tests.test_torch_packed_round import smoke_tree

K, THETA, SLOTS, N_REQ = 12, 4, 2, 5

CONFIGS = {
    "unpacked": dict(execution="unpacked", rounds_per_sync=2),
    "packed-binding": dict(execution="packed", round_budget=3, rounds_per_sync=1),
    "fused": dict(execution="packed", round_impl="fused", round_budget=5,
                  rounds_per_sync=2),
    "fused-auto": dict(execution="packed", round_impl="fused", round_budget="auto",
                       rounds_per_sync=1),
}


def _record_admissions(engine, log):
    admit = engine.scheduler.admit

    def recording(now, round_idx, ctx=None):
        placed = admit(now, round_idx, ctx)
        log.extend((round_idx, slot, req.rid) for slot, req in placed)
        return placed

    engine.scheduler.admit = recording


@pytest.fixture(scope="module")
def smoke():
    jdc, tdc = j_smoke(), t_smoke()
    tree = smoke_tree(jdc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    js, ts = j_sch.sl_geometric(K, 0.05, 10.0), t_sch.sl_geometric(K, 0.05, 10.0)
    ev = (jdc.seq_len, jdc.d_data)
    y0 = np.zeros(ev, np.float32)
    keys = [jax.random.PRNGKey(100 + i) for i in range(N_REQ)]
    noise = [j_asd.init_chain_state(js, jnp.asarray(y0), k, THETA) for k in keys]
    jreqs = [JRequest(i, key=keys[i], y0=y0) for i in range(N_REQ)]
    treqs = [TRequest(i, u_buf=np.asarray(noise[i].u_buf), xi_buf=np.asarray(noise[i].xi_buf),
                      y0=y0) for i in range(N_REQ)]
    return dict(j_fn=lambda cond: j_make_sl(jparams, jdc, cond),
                t_fn=t_make_sl(from_jax_params(tree, tdc, device="cpu"), tdc),
                js=js, ts=ts, ev=ev, jreqs=jreqs, treqs=treqs)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_serve_matches_jax(smoke, config):
    kw = CONFIGS[config]
    jeng = JEngine(smoke["j_fn"], smoke["js"], smoke["ev"], num_slots=SLOTS, theta=THETA,
                   **kw)
    teng = TEngine(smoke["t_fn"], smoke["ts"], smoke["ev"], num_slots=SLOTS, theta=THETA,
                   device="cpu", **kw)
    jlog, tlog = [], []
    _record_admissions(jeng, jlog)
    _record_admissions(teng, tlog)
    jout = jeng.serve(smoke["jreqs"])
    tout = teng.serve(smoke["treqs"])

    assert sorted(tout) == sorted(jout) == list(range(N_REQ))
    assert tlog == jlog  # FCFS: same requests into the same slots at the same rounds
    jm = {m.rid: m for m in jeng.stats.per_request}
    tm = {m.rid: m for m in teng.stats.per_request}
    for rid in range(N_REQ):
        for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals"):
            assert getattr(tm[rid], name) == getattr(jm[rid], name), (rid, name)
        np.testing.assert_allclose(tout[rid], np.asarray(jout[rid]), rtol=1e-4, atol=1e-4)
        assert tout[rid].shape == smoke["ev"]
    assert [m.rid for m in teng.stats.per_request] == [m.rid for m in jeng.stats.per_request]
    assert (teng.stats.rounds_total, teng.stats.supersteps) == (
        jeng.stats.rounds_total, jeng.stats.supersteps)
    assert teng.round_budget == jeng.round_budget
    # the reject path ran
    assert sum(m.accepts for m in tm.values()) < sum(m.proposals for m in tm.values())


REFUSALS = {
    "budget below slots": dict(execution="packed", round_budget=1),
    "fused without packed": dict(round_impl="fused"),
    "auto budget without packed": dict(round_budget="auto"),
    "unknown execution": dict(execution="ragged"),
    "rounds_per_sync 0": dict(rounds_per_sync=0),
    "unknown round_impl": dict(round_impl="ragged"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_refuses_what_jax_refuses(what):
    kw = REFUSALS[what]
    js, ts = j_sch.sl_uniform(K, t_max=8.0), t_sch.sl_uniform(K, t_max=8.0)
    jmodel = j_an.sl_mean_fn(j_an.default_gmm(2))
    with pytest.raises(ValueError):
        JEngine(lambda cond: jmodel, js, (2,), num_slots=SLOTS, theta=THETA, **kw)
    with pytest.raises(ValueError):
        TEngine(t_an.sl_mean_fn(t_an.default_gmm(2)), ts, (2,), num_slots=SLOTS,
                theta=THETA, device="cpu", **kw)


def _gmm_engine(num_slots, **kw):
    return TEngine(t_an.sl_mean_fn(t_an.default_gmm(2)), t_sch.sl_uniform(K, t_max=8.0),
                   (2,), num_slots=num_slots, theta=THETA, device="cpu", seed=7, **kw)


def test_unkeyed_requests_draw_by_rid_not_by_slot_or_order():
    """A request without a key or injected noise draws from
    fold_in(serve key, rid), a pure function of (serve key, rid): the same
    rid gets the same sample whatever the slot count, arrival order or
    superstep length, and another one under another serve key."""
    a = _gmm_engine(2).serve([TRequest(i) for i in range(4)])
    b = _gmm_engine(3, rounds_per_sync=3).serve([TRequest(i) for i in (3, 1, 0, 2)])
    c = _gmm_engine(2).serve([TRequest(i) for i in range(4)], key=np.array([0, 99]))
    for rid in range(4):
        np.testing.assert_allclose(a[rid], b[rid], rtol=1e-5, atol=1e-5)
        assert not np.allclose(a[rid], c[rid])
    assert not np.allclose(a[0], a[1])


def test_step_drain_and_health():
    eng = _gmm_engine(2, execution="packed", round_impl="fused", round_budget="auto",
                      rounds_per_sync="auto")
    for i in range(3):
        eng.submit(TRequest(i))
    # three queued for two slots: more than a slot batch waits
    assert eng.health()["status"] == "backpressure" and eng.load == 1.5
    steps = 0
    while eng.step():
        steps += 1
        if steps == 1:
            eng.begin_drain()
            with pytest.raises(RuntimeError, match="draining"):
                eng.submit(TRequest(99))
            assert eng.healthz()["status"] == "draining"
    out = eng.drain_results()
    assert sorted(out) == [0, 1, 2] and eng.stats.retired == 3
    assert all(np.isfinite(v).all() for v in out.values())
    assert eng.stats.supersteps == steps + 1


def test_conditioned_requests_are_served():
    """d_cond > 0 through the packed engine (covering budget, so a chain's
    rounds do not depend on its neighbours): each request's condition row
    reaches its own points."""
    dc = dataclasses.replace(t_smoke(), d_cond=3)
    tree = smoke_tree(dataclasses.replace(j_smoke(), d_cond=3))
    fn = t_make_sl(from_jax_params(tree, dc, device="cpu"), dc)
    eng = TEngine(fn, t_sch.sl_geometric(K, 0.05, 10.0), (dc.seq_len, dc.d_data),
                  num_slots=2, theta=THETA, d_cond=3, device="cpu", execution="packed")
    cond = np.ones(3, np.float32)
    noise = dict(u_buf=np.full(K + THETA + 1, 0.5, np.float32),
                 xi_buf=np.zeros((K + THETA + 1, dc.seq_len, dc.d_data), np.float32))
    out = eng.serve([TRequest(0, cond=cond, **noise), TRequest(1, cond=-cond, **noise),
                     TRequest(2, cond=cond, **noise)])
    assert np.allclose(out[0], out[2], atol=1e-5)
    assert not np.allclose(out[0], out[1], atol=1e-3)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(t_an.sl_mean_fn(t_an.default_gmm(2)), t_sch.sl_uniform(K), (2,))
