"""The port's superstep program cache against the JAX worker's executable
cache, on the CPU: the same request streams (the smoke denoiser, each
request with the noise the JAX engine draws from its key) through both
engines build the same ``(R, budget)`` keys and the same number of
programs, and building one more than the ladders allow raises in both.
The auto ladders, the fused round's ``"data"`` coordinate and two serve
waves are in ``test_torch_programs_ladders.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import asd as j_asd
from repro.core import schedules as j_sch
from repro.core.controller import AcceptRateTheta as JAcceptRate
from repro.models.diffusion import make_sl_model_fn as j_make_sl
from repro.serving.engine import ContinuousASDEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import schedules as t_sch
from repro_torch.core.controller import AcceptRateTheta as TAcceptRate
from repro_torch.models.diffusion import make_sl_model_fn as t_make_sl
from repro_torch.serving.engine import ContinuousASDEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.weights import from_jax_params
from tests.test_torch_packed_round import smoke_tree
from tests.test_torch_serving import CONFIGS

THETA, SLOTS = 4, 2


@functools.lru_cache(maxsize=None)
def _models():
    jdc, tdc = j_smoke(), t_smoke()
    tree = smoke_tree(jdc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return ((lambda cond: j_make_sl(jparams, jdc, cond)),
            t_make_sl(from_jax_params(tree, tdc, device="cpu"), tdc),
            (jdc.seq_len, jdc.d_data))


def _requests(K, rids, seed0=100):
    """The JAX requests (keys) and the port's (the noise JAX draws from
    those keys, injected)."""
    js = j_sch.sl_geometric(K, 0.05, 10.0)
    ev = _models()[2]
    y0 = np.zeros(ev, np.float32)
    jreqs, treqs = [], []
    for rid in rids:
        key = jax.random.PRNGKey(seed0 + rid)
        st = j_asd.init_chain_state(js, jnp.asarray(y0), key, THETA)
        jreqs.append(JRequest(rid, key=key, y0=y0))
        treqs.append(TRequest(rid, u_buf=np.asarray(st.u_buf), xi_buf=np.asarray(st.xi_buf),
                              y0=y0))
    return jreqs, treqs


def _engines(K, **kw):
    """A JAX engine and the port's with the same statics."""
    j_fn, t_fn, ev = _models()
    ctl = kw.pop("controller", None)
    jkw, tkw = dict(kw), dict(kw)
    if ctl == "accept-rate":
        jkw["controller"], tkw["controller"] = JAcceptRate(theta_min=1), TAcceptRate(theta_min=1)
    jeng = JEngine(j_fn, j_sch.sl_geometric(K, 0.05, 10.0), ev, num_slots=SLOTS,
                   theta=THETA, **jkw)
    teng = TEngine(t_fn, t_sch.sl_geometric(K, 0.05, 10.0), ev, num_slots=SLOTS,
                   theta=THETA, device="cpu", **tkw)
    return jeng, teng


def _serve_both(jeng, teng, K, rids, seed0=100):
    jreqs, treqs = _requests(K, rids, seed0)
    jout, tout = jeng.serve(jreqs), teng.serve(treqs)
    assert sorted(tout) == sorted(jout) == sorted(rids)


def _assert_same_cache(jeng, teng):
    assert sorted(teng._superstep_fns) == sorted(jeng._superstep_fns)
    assert teng._compiled_supersteps == jeng._compiled_supersteps
    assert (teng.stats.rounds_total, teng.stats.supersteps) == (
        jeng.stats.rounds_total, jeng.stats.supersteps)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_program_cache_matches_jax(config):
    """The same request stream builds the same (R, budget) keys and the
    same number of programs in both workers (the configs of
    tests/test_torch_serving.py)."""
    jeng, teng = _engines(12, **CONFIGS[config])
    _serve_both(jeng, teng, 12, range(5))
    _assert_same_cache(jeng, teng)


@pytest.mark.parametrize("kw,keys", [
    (dict(execution="unpacked"), [(1, None), (2, None), (3, None)]),
    (dict(execution="packed", round_budget="auto"), [(1, 2), (1, 4), (1, 8), (2, 2), (2, 4)]),
    (dict(execution="packed", round_impl="fused", round_budget="auto",
          rounds_per_sync="auto"), [(r, 2) for r in (1, 2, 4, 8, 16, 32, 64)]),
], ids=["fixed", "auto-budget", "fused-auto-R"])
def test_ladder_bound_assertion_matches_jax(kw, keys):
    """Building one program more than the ladders allow (max_r * max_b + 1)
    raises in both workers, at the same key."""
    jeng, teng = _engines(12, **kw)
    for i, (R, budget) in enumerate(keys):
        if i < len(keys) - 1:
            jeng._get_superstep(R, budget)
            teng._get_superstep(R, budget)
            continue
        with pytest.raises(AssertionError, match="ladders allow"):
            jeng._get_superstep(R, budget)
        with pytest.raises(AssertionError, match="ladders allow"):
            teng._get_superstep(R, budget)
    _assert_same_cache(jeng, teng)
