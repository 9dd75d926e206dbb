"""The port's ``core/exchangeability.py`` (paper Theorem 1) and the GMM's
``sample`` and ``trace_cov`` against the JAX package's on the CPU.

On the same increments ``permutation_statistic``'s moment gaps equal JAX's
within float32 rounding and its ``sum_gap`` is exactly 0 (the port sums in
sorted order); ``marginal_of_future_increment`` equals JAX's within 1e-6.
From the same keys the port draws JAX's increments (within float32 ulps
of its normals) and mixture components; its draws pass the law tests of
the JAX package's ``tests/test_exchangeability.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from repro.core import analytic as j_an
from repro.core import exchangeability as j_ex
from repro_torch.core import analytic as t_an
from repro_torch.core import exchangeability as t_ex

J_GMM, T_GMM = j_an.default_gmm(d=2), t_an.default_gmm(d=2)


def _key(seed):
    return jax.random.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed))


def test_gmm_sample_and_trace_cov_match_jax():
    jk, tk = _key(5)
    js, ts = np.asarray(J_GMM.sample(jk, 6000)), T_GMM.sample(tk, 6000).numpy()
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)  # the same components
    for d in (2, 5):
        jg, tg = j_an.default_gmm(d=d), t_an.default_gmm(d=d)
        assert float(tg.trace_cov()) == pytest.approx(float(jg.trace_cov()), rel=1e-6)
    # the law: the mixture's mean and trace of covariance
    np.testing.assert_allclose(ts.mean(0), T_GMM.means.mean(0).numpy(), atol=0.06)
    assert ts.var(0).sum() == pytest.approx(float(T_GMM.trace_cov()), rel=0.05)


@pytest.mark.parametrize("m,eta", [(4, 0.3), (7, 1.0)])
def test_sl_increments_and_trajectory_match_jax(m, eta):
    jk, tk = _key(m)
    ji = np.asarray(j_ex.simulate_sl_increments(J_GMM, jk, 500, m, eta))
    ti = t_ex.simulate_sl_increments(T_GMM, tk, 500, m, eta).numpy()
    np.testing.assert_allclose(ti, ji, rtol=0, atol=2e-6)
    jt = np.asarray(j_ex.simulate_sl_trajectory(J_GMM, jk, 500, m, eta))
    tt = t_ex.simulate_sl_trajectory(T_GMM, tk, 500, m, eta).numpy()
    assert tt.shape == (500, m + 1, 2) and (tt[:, 0] == 0).all()
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)


@pytest.mark.parametrize("perm_seed,m,eta", [(0, 3, 0.05), (7, 5, 0.4), (123, 8, 1.0)])
def test_permutation_statistic_matches_jax(perm_seed, m, eta):
    """The JAX package's property on the port's draws (its thresholds), and
    the port's statistic on JAX's increments equal to JAX's."""
    jk, tk = _key(0)
    incs = t_ex.simulate_sl_increments(T_GMM, tk, 4000, m, eta)
    perm = np.random.default_rng(perm_seed).permutation(m)
    stats = t_ex.permutation_statistic(incs, perm)
    assert float(stats["sum_gap"]) == 0.0
    assert float(stats["mean_gap"]) < 0.15 and float(stats["second_gap"]) < 0.35
    j_incs = j_ex.simulate_sl_increments(J_GMM, jk, 4000, m, eta)
    j_stats = j_ex.permutation_statistic(j_incs, perm)
    t_stats = t_ex.permutation_statistic(torch.from_numpy(np.array(j_incs)), perm)
    for name in ("mean_gap", "second_gap", "cross_gap"):
        assert float(t_stats[name]) == pytest.approx(float(j_stats[name]), abs=1e-6), name
    assert float(t_stats["sum_gap"]) == 0.0 and float(j_stats["sum_gap"]) < 1e-5


@pytest.mark.parametrize("i,j", [(0, 5), (2, 3)])
def test_increment_marginals_are_equal_in_law(i, j):
    """Law(Delta_i) == Law(Delta_j) for equal steps (Thm 1): a two-sample
    KS test on the port's draws, and the mean eta E[x*]."""
    _, tk = _key(1)
    incs = t_ex.simulate_sl_increments(T_GMM, tk, 8000, 6, 0.3).numpy()
    assert scipy.stats.ks_2samp(incs[:, i, 0], incs[:, j, 0]).pvalue > 1e-4
    np.testing.assert_allclose(incs.mean((0, 1)), 0.3 * T_GMM.means.mean(0).numpy(),
                               atol=0.03)


def test_marginal_of_future_increment_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.standard_normal((6, 2)).astype(np.float32) * 2
    for t_a, eta in ((0.3, 0.25), (4.0, 1.0)):
        jm, jv = j_ex.marginal_of_future_increment(J_GMM, jnp.asarray(y), t_a, eta)
        tm, tv = t_ex.marginal_of_future_increment(T_GMM, torch.from_numpy(y), t_a, eta)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
        assert tv == jv == eta
