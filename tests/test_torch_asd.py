"""The port's ASD sampler against the JAX package on the GMM oracle.

Both packages get the same noise: the JAX package's ``init_chain_state``
draws each chain's ``u_buf`` / ``xi_buf`` from the keys ``asd_sample_batched``
splits, and the port is handed those arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as j_an
from repro.core import asd as j_asd
from repro.core import controller as j_ctl
from repro.core import schedules as j_sch
from repro_torch.core import analytic as t_an
from repro_torch.core import asd as t_asd
from repro_torch.core import controller as t_ctl
from repro_torch.core import schedules as t_sch

COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals")


def jax_noise(schedule, y0, key, theta, batched=True):
    """The (u_buf, xi_buf) the JAX sampler draws for each chain."""
    if not batched:
        st = j_asd.init_chain_state(schedule, jnp.asarray(y0), key, theta)
        return np.array(st.u_buf), np.array(st.xi_buf)
    keys = jax.random.split(key, y0.shape[0])
    sts = [j_asd.init_chain_state(schedule, jnp.asarray(y0[b]), keys[b], theta)
           for b in range(y0.shape[0])]
    return (np.stack([np.array(s.u_buf) for s in sts]),
            np.stack([np.array(s.xi_buf) for s in sts]))


def assert_same(jr, tr, tol=1e-5):
    # SL states grow like t (to ~24 here), so 1e-5 is both absolute and
    # relative: a few float32 ulps at that magnitude
    np.testing.assert_allclose(tr.sample.numpy(), np.array(jr.sample), atol=tol, rtol=tol)
    np.testing.assert_allclose(tr.trajectory.numpy(), np.array(jr.trajectory),
                               atol=tol, rtol=tol)
    for name in COUNTERS:
        assert getattr(tr, name).tolist() == np.array(getattr(jr, name)).tolist(), name


CONTROLLERS = {"full": (j_ctl.StaticTheta(), t_ctl.StaticTheta()),
               "value2": (j_ctl.StaticTheta(value=2), t_ctl.StaticTheta(value=2))}


@pytest.mark.parametrize("ctl", sorted(CONTROLLERS))
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("eager", [False, True])
def test_asd_sample_batched_matches_on_gmm(eager, keep, ctl):
    K, theta, B, d = 16, 4, 3, 2
    js, ts = j_sch.sl_uniform(K, t_max=8.0), t_sch.sl_uniform(K, t_max=8.0)
    key = jax.random.PRNGKey(7)
    y0 = np.zeros((B, d), np.float32)
    jc, tc = CONTROLLERS[ctl]
    jr = j_asd.asd_sample_batched(j_an.sl_mean_fn(j_an.default_gmm(d)), js,
                                  jnp.asarray(y0), key, theta, eager_head=eager,
                                  keep_trajectory=keep, controller=jc)
    u, xi = jax_noise(js, y0, key, theta)
    tr = t_asd.asd_sample_batched(t_an.sl_mean_fn(t_an.default_gmm(d)), ts,
                                  torch.from_numpy(y0), theta, eager_head=eager,
                                  keep_trajectory=keep, controller=tc,
                                  u_buf=torch.from_numpy(u), xi_buf=torch.from_numpy(xi),
                                  device="cpu")
    assert_same(jr, tr)
    assert tr.sample.shape == (B, d)


@pytest.mark.parametrize("ctl", sorted(CONTROLLERS))
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("eager", [False, True])
def test_asd_sample_matches_on_ddpm_gmm(eager, keep, ctl):
    """One chain on the DDPM schedule with a std-normal y0 and theta > K/2."""
    K, theta, d = 12, 7, 3
    js, ts = j_sch.ddpm(K), t_sch.ddpm(K)
    abar = j_sch.ddpm_coeffs(K)[2]
    key = jax.random.PRNGKey(11)
    y0 = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    jc, tc = CONTROLLERS[ctl]
    jr = j_asd.asd_sample(j_an.ddpm_x0_fn(j_an.default_gmm(d), abar), js,
                          jnp.asarray(y0), key, theta, eager_head=eager,
                          keep_trajectory=keep, controller=jc)
    u, xi = jax_noise(js, y0, key, theta, batched=False)
    tr = t_asd.asd_sample(
        t_an.ddpm_x0_fn(t_an.default_gmm(d), torch.from_numpy(np.array(abar))), ts,
        torch.from_numpy(y0), theta, eager_head=eager, keep_trajectory=keep,
        controller=tc, u_buf=torch.from_numpy(u), xi_buf=torch.from_numpy(xi),
        device="cpu")
    assert_same(jr, tr)
    assert tr.rounds.ndim == 0


def test_asd_infinity_and_parallel_depth():
    """theta >= K clamps to K; result helpers agree with the counters."""
    K = 8
    ts = t_sch.sl_uniform(K, t_max=4.0)
    model = t_an.sl_mean_fn(t_an.default_gmm(2))
    g = torch.Generator().manual_seed(0)
    r = t_asd.asd_sample_batched(model, ts, torch.zeros(2, 2), 50, generator=g,
                                 device="cpu")
    assert r.trajectory.shape == (2, K + 1, 2)
    assert torch.equal(r.parallel_depth(), r.rounds + r.head_calls)
    assert torch.all(r.accept_rate() <= 1)
    assert torch.all(r.proposals >= K) and torch.all(r.rounds <= K)


def test_round_is_identity_on_finished_chains():
    K, theta = 6, 3
    ts = t_sch.sl_uniform(K, t_max=4.0)
    model = t_an.sl_mean_fn(t_an.default_gmm(2))
    g = torch.Generator().manual_seed(1)
    st = t_asd.init_chain_state(ts, torch.zeros(2, 2), theta, generator=g)
    while not bool(t_asd.chain_done(st, K).all()):
        st = t_asd.asd_round(model, ts, st, theta)
    again = t_asd.asd_round(model, ts, st, theta)
    for name in ("y", "a", "v_cache", "v_valid", "rounds", "head_calls",
                 "model_evals", "accepts", "proposals", "theta_live"):
        assert torch.equal(getattr(again, name), getattr(st, name)), name


def test_injected_noise_shapes_are_checked():
    ts = t_sch.sl_uniform(4)
    with pytest.raises(ValueError, match="u_buf"):
        t_asd.init_chain_state(ts, torch.zeros(2, 3), 2, u_buf=torch.zeros(2, 5))
