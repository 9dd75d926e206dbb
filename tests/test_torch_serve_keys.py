"""The port's continuous engine against the JAX package's from the same
seed and request ids, with no noise handed over: each chain's key is the
request's own or ``fold_in(serve key, rid)``, split once for y0, and both
engines draw counter noise from it (the serve CLI's setting).

The smoke denoiser on the DDPM schedule (y0 drawn from the key), 5
requests on 2 slots, odd ones keyed.  Per request the counters must be
equal and the samples within 1e-4; the FCFS admissions (superstep round,
slot, request) equal.  Packed and fused rounds must give equal bits under
adaptive windows too.

The accept-bit law: the DDPM schedule's last step has sigma 0, where GRS
accepts iff m_hat == m to the bit, and m_hat and m come from model calls
over differently composed batches.  That row sits at the threshold by
construction, so its accept bit may differ (and then the sample differs by
rounding only, since z is m_hat or m): ``accepts`` may differ by at most
that one row, every other counter must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import controller as j_ctl
from repro.core import schedules as j_sch
from repro.models.diffusion import make_ddpm_model_fn as j_make_ddpm
from repro.serving.engine import ContinuousASDEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import make_policy as j_policy
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import controller as t_ctl
from repro_torch.core import schedules as t_sch
from repro_torch.models.diffusion import make_ddpm_model_fn as t_make_ddpm
from repro_torch.serving.engine import ContinuousASDEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.scheduler import make_policy as t_policy
from repro_torch.weights import from_jax_params
from tests.test_torch_packed_round import smoke_tree
from tests.test_torch_serving import _record_admissions

K, THETA, SLOTS, N_REQ = 12, 4, 2, 5
COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals")

# (engine kwargs, controller): every execution, controller and R, the
# budget policy with overcommit, buffer noise drawn from the keys, and a
# serve key passed to serve()
CASES = {
    "unpacked-static-R1-serve-key": (dict(rounds_per_sync=1, serve_key=5), "static"),
    "unpacked-aimd-R4": (dict(rounds_per_sync=4), "aimd"),
    "packed-accept-rate-R1-buffer-noise": (dict(execution="packed", round_budget=5,
                                                noise_mode="buffer"), "accept-rate"),
    "packed-aimd-R4": (dict(execution="packed", round_budget=6, rounds_per_sync=4), "aimd"),
    "fused-static-R4": (dict(execution="packed", round_impl="fused", round_budget=5,
                             rounds_per_sync=4), "static"),
    "fused-accept-rate-auto": (dict(execution="packed", round_impl="fused",
                                    round_budget="auto"), "accept-rate"),
    "budget-overcommit-1.5": (dict(execution="packed", round_budget=4, overcommit=1.5,
                                   policy="budget", rounds_per_sync=2), "aimd"),
}


@pytest.fixture(scope="module")
def smoke():
    jdc, tdc = j_smoke(), t_smoke()
    tree = smoke_tree(jdc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return dict(j_fn=j_make_ddpm(jparams, jdc),
                t_fn=t_make_ddpm(from_jax_params(tree, tdc, device="cpu"), tdc),
                js=j_sch.ddpm(K), ts=t_sch.ddpm(K), ev=(jdc.seq_len, jdc.d_data))


def _requests():
    keys = {i: jax.random.PRNGKey(1000 + i) for i in range(1, N_REQ, 2)}
    jreqs = [JRequest(i, key=keys.get(i)) for i in range(N_REQ)]
    treqs = [TRequest(i, key=None if i not in keys else np.asarray(keys[i]))
             for i in range(N_REQ)]
    return jreqs, treqs


def _engines(smoke, kw, ctl, num_slots=SLOTS):
    kw = dict(kw)
    kw.pop("serve_key", None)
    kw.setdefault("noise_mode", "counter")
    policy = kw.pop("policy", None)
    jeng = JEngine(lambda cond: smoke["j_fn"], smoke["js"], smoke["ev"], num_slots=num_slots,
                   theta=THETA, seed=3, controller=j_ctl.make_controller(ctl),
                   policy=None if policy is None else j_policy(policy), **kw)
    teng = TEngine(smoke["t_fn"], smoke["ts"], smoke["ev"], num_slots=num_slots, theta=THETA,
                   seed=3, controller=t_ctl.make_controller(ctl),
                   policy=None if policy is None else t_policy(policy), device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("case", sorted(CASES))
def test_keyed_serving_matches_jax(smoke, case):
    kw, ctl = CASES[case]
    jeng, teng = _engines(smoke, kw, ctl)
    jlog, tlog = [], []
    _record_admissions(jeng, jlog)
    _record_admissions(teng, tlog)
    jreqs, treqs = _requests()
    serve_key = kw.get("serve_key")
    jout = jeng.serve(jreqs, None if serve_key is None else jax.random.PRNGKey(serve_key))
    tout = teng.serve(treqs, None if serve_key is None
                      else np.asarray(jax.random.PRNGKey(serve_key)))

    assert sorted(tout) == sorted(jout) == list(range(N_REQ))
    assert tlog == jlog
    jm = {m.rid: m for m in jeng.stats.per_request}
    tm = {m.rid: m for m in teng.stats.per_request}
    for rid in range(N_REQ):
        for name in ("rounds", "head_calls", "model_evals", "proposals"):
            assert getattr(tm[rid], name) == getattr(jm[rid], name), (rid, name)
        assert abs(tm[rid].accepts - jm[rid].accepts) <= 1, rid  # the sigma-0 row
        np.testing.assert_allclose(tout[rid], np.asarray(jout[rid]), rtol=1e-4, atol=1e-4)
    assert (teng.stats.rounds_total, teng.stats.supersteps, teng.round_budget) == (
        jeng.stats.rounds_total, jeng.stats.supersteps, jeng.round_budget)
    assert sum(m.accepts for m in tm.values()) < sum(m.proposals for m in tm.values())
    if ctl != "static":  # the controller moved the windows
        assert any(m.mean_window != THETA for m in tm.values())


@pytest.mark.parametrize("ctl", ["aimd", "accept-rate"])
def test_adaptive_rounds_keep_packed_and_fused_equal(smoke, ctl):
    """The counterpart of the JAX package's
    ``test_adaptive_rounds_preserve_fused_equivalence``: under adaptive
    windows and a binding budget, packed and fused rounds serve equal
    counters and equal sample bits."""
    runs = {}
    for impl in ("packed", "fused"):
        _, eng = _engines(smoke, dict(execution="packed", round_impl=impl, round_budget=3,
                                      rounds_per_sync=2), ctl)
        out = eng.serve(_requests()[1])
        runs[impl] = (out, {m.rid: tuple(getattr(m, n) for n in COUNTERS)
                            for m in eng.stats.per_request})
    (op, cp), (of, cf) = runs["packed"], runs["fused"]
    assert cp == cf
    for rid in op:
        assert np.array_equal(op[rid], of[rid]), rid


def test_overcommit_is_refused_below_one(smoke):
    with pytest.raises(ValueError, match="overcommit"):
        _engines(smoke, dict(overcommit=0.5), "static")
