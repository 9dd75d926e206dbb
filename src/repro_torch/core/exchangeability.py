"""Hidden exchangeability of SL/DDPM increments, paper Theorem 1.

The exact simulation of SL (Theorem 8, El Alaoui and Montanari):
    ybar_t = t x* + W_t,   x* ~ mu,  W a standard Brownian motion,
so equal-step increments are Delta_i = eta x* + (W_{t_{i+1}} - W_{t_i}):
given x* they are iid N(eta x*, eta I), hence exchangeable.

These helpers simulate exact SL increments and trajectories for the
property tests (from a key, as the JAX package draws them) and compute
permutation-invariance statistics.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import prng
from repro_torch.core.analytic import GMM, _posterior_mean


def simulate_sl_increments(gmm: GMM, key, n_chains: int, m: int, eta: float):
    """Exact equal-step SL increments Delta_i, shape (n_chains, m, d), on
    the key's device."""
    kx, kw = prng.split(prng.as_key(key), 2).unbind(-2)
    xstar = gmm.sample(kx, n_chains)  # (n, d)
    brownian = prng.normal(kw, (n_chains, m, gmm.d)) * math.sqrt(eta)
    return eta * xstar[:, None, :] + brownian


def simulate_sl_trajectory(gmm: GMM, key, n_chains: int, m: int, eta: float):
    """The partial sums of ``simulate_sl_increments``, from 0: (n, m+1, d)."""
    traj = torch.cumsum(simulate_sl_increments(gmm, key, n_chains, m, eta), dim=1)
    return torch.cat([torch.zeros_like(traj[:, :1]), traj], dim=1)


def permutation_statistic(incs: torch.Tensor, perm) -> dict:
    """Compare the joint law of increments (n, m, d) with that of their
    permutation ``perm`` of the m positions: the largest gaps of the
    per-position first and second moments, of the mean cross-position
    product, and of the sums.  Exchangeability (Thm 1) says each statistic
    agrees in law.  The sums are taken over each chain's increments in
    sorted order, so they do not depend on the order of the positions and
    ``sum_gap`` is exactly 0 (a float32 sum in the given order, as the JAX
    package takes it, differs by rounding)."""
    permuted = incs[:, torch.as_tensor(perm, device=incs.device)]

    def stats(x):
        cross = torch.einsum("nmd,nkd->mk", x, x) / (x.shape[0] * x.shape[2])
        return x.mean(dim=0), (x ** 2).mean(dim=0), cross

    f0, s0, c0 = stats(incs)
    f1, s1, c1 = stats(permuted)
    return dict(
        mean_gap=torch.max(torch.abs(f0 - f1)),
        second_gap=torch.max(torch.abs(s0 - s1)),
        cross_gap=torch.max(torch.abs(c0.mean() - c1.mean())),
        sum_gap=torch.max(torch.abs(incs.sort(dim=1).values.sum(1)
                                    - permuted.sort(dim=1).values.sum(1))),
    )


def marginal_of_future_increment(gmm: GMM, y_a, t_a, eta):
    """Law(Delta_j | y_a) is the same for every j >= a (Thm 1): the mixture
    over the posterior of x* given y_a of N(eta x*, eta I), the proposal
    ASD samples.  Returns (eta x the posterior mean, the common variance)."""
    y_a = torch.as_tensor(y_a, dtype=torch.float32)
    t = torch.as_tensor(t_a, dtype=torch.float32, device=y_a.device)
    return eta * _posterior_mean(gmm, y_a, t), eta
