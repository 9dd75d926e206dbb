"""The port's chunked static engine, ``ASDServingEngine``, against the JAX
package's on the CPU: the smoke denoiser with the same weights, the same
requests and serve key, chunks padded to the batch size.

Both modes ("asd" and the sequential "ddpm"), on the SL schedule (y0
zeros) and the DDPM schedule (y0 drawn from the keys), with and without
conditions: samples within 1e-4, and the engine's counters (batches, the
chunks' rounds and head calls, requests) equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import schedules as j_sch
from repro.models import diffusion as j_diff
from repro.serving.engine import ASDServingEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import schedules as t_sch
from repro_torch.models import diffusion as t_diff
from repro_torch.serving.engine import ASDServingEngine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.weights import from_jax_params
from tests.test_torch_packed_round import smoke_tree

K, THETA, BATCH, N_REQ = 12, 4, 3, 5

# (mode, schedule, d_cond)
CASES = {
    "asd-sl": ("asd", "sl", 0),
    "asd-ddpm-conditioned": ("asd", "ddpm", 3),
    "ddpm-ddpm": ("ddpm", "ddpm", 0),
    "ddpm-sl-conditioned": ("ddpm", "sl", 3),
}


def _engines(mode, sched, d_cond):
    jdc = dataclasses.replace(j_smoke(), d_cond=d_cond)
    tdc = dataclasses.replace(t_smoke(), d_cond=d_cond)
    tree = smoke_tree(jdc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    if sched == "sl":
        js, ts = j_sch.sl_geometric(K, 0.05, 10.0), t_sch.sl_geometric(K, 0.05, 10.0)
        jmake, tmake = j_diff.make_sl_model_fn, t_diff.make_sl_model_fn
    else:
        js, ts = j_sch.ddpm(K), t_sch.ddpm(K)
        jmake, tmake = j_diff.make_ddpm_model_fn, t_diff.make_ddpm_model_fn
    jeng = JEngine(jparams, jdc, js, jmake, theta=THETA, batch_size=BATCH, mode=mode)
    teng = TEngine(tmake(from_jax_params(tree, tdc, device="cpu"), tdc), ts,
                   (tdc.seq_len, tdc.d_data), theta=THETA, batch_size=BATCH, mode=mode,
                   d_cond=d_cond, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("name", sorted(CASES))
def test_static_engine_matches_jax(name):
    mode, sched, d_cond = CASES[name]
    jeng, teng = _engines(mode, sched, d_cond)
    rng = np.random.default_rng(4)
    conds = [None if not d_cond or i == 2 else rng.standard_normal(d_cond).astype(np.float32)
             for i in range(N_REQ)]
    jout = jeng.serve([JRequest(i, cond=c) for i, c in enumerate(conds)],
                      jax.random.PRNGKey(21))
    tout = teng.serve([TRequest(i, cond=c) for i, c in enumerate(conds)],
                      np.asarray(jax.random.PRNGKey(21)))
    assert sorted(tout) == sorted(jout) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert tout[rid].shape == np.asarray(jout[rid]).shape
        np.testing.assert_allclose(tout[rid], np.asarray(jout[rid]), rtol=1e-4, atol=1e-4)
    for f in ("requests", "retired", "batches", "rounds_total", "head_calls_total"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert teng.stats.batches == 2
    if mode == "ddpm":
        assert teng.stats.rounds_total == 2 * K
    else:
        assert teng.stats.rounds_total < 2 * K  # speculation ran ahead
    # distinct requests drew distinct chains
    assert not np.allclose(tout[0], tout[1])


def test_static_engine_refuses_an_oversized_batch_and_an_unknown_mode():
    _, teng = _engines("asd", "sl", 0)
    with pytest.raises(ValueError, match="batch"):
        teng.submit_batch([TRequest(i) for i in range(BATCH + 1)], np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="mode"):
        TEngine(lambda t, y: y, t_sch.ddpm(K), (2,), mode="beam", device="cpu")
    out = teng.submit_batch([TRequest(7)], np.asarray(jax.random.PRNGKey(1)))
    assert list(out) == [7] and np.isfinite(out[7]).all()
