"""Analytic mean oracles for Gaussian-mixture targets.

For mu = sum_k w_k N(mu_k, s_k^2 I) every conditional mean the samplers need
is closed-form, so these stand in for a trained network wherever a test
needs ground truth:

  * SL observation y = t x* + sqrt(t) xi  =>  x* | y is a Gaussian mixture
    with component means (mu_k / s_k^2 + y) / (1/s_k^2 + t).
  * DDPM x_s = sqrt(abar) x0 + sqrt(1-abar) eps: the same formula with
    t_eff = abar / (1 - abar), y_eff = sqrt(abar) x_s / (1 - abar).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class GMM:
    means: torch.Tensor  # (ncomp, d)
    scales: torch.Tensor  # (ncomp,) isotropic component stds
    weights: torch.Tensor  # (ncomp,)

    @property
    def d(self) -> int:
        return self.means.shape[-1]

    def to(self, device) -> "GMM":
        return GMM(self.means.to(device), self.scales.to(device),
                   self.weights.to(device))

    def sample(self, key, n: int) -> torch.Tensor:
        """n draws (n, d) from the mixture on the key's device, as the JAX
        package draws them: the key split into (component, noise) keys, the
        component by the Gumbel-max trick (``jax.random.categorical``), the
        noise ``normal`` (``repro_torch.core.prng``)."""
        kc, kx = prng.split(prng.as_key(key), 2).unbind(-2)
        gmm = self.to(kc.device)
        u = prng.uniform(kc, (n, gmm.weights.shape[0]),
                         minval=float(np.finfo(np.float32).tiny), maxval=1.0)
        comp = torch.argmax(-torch.log(-torch.log(u)) + torch.log(gmm.weights), dim=-1)
        eps = prng.normal(kx, (n, gmm.d))
        return gmm.means[comp] + gmm.scales[comp][:, None] * eps

    def trace_cov(self) -> torch.Tensor:
        """Tr(Cov[mu]), the beta * d of the paper's Thm 4 assumption."""
        mean = torch.sum(self.weights[:, None] * self.means, dim=0)
        second = torch.sum(self.weights[:, None]
                           * ((self.means - mean) ** 2 + self.scales[:, None] ** 2), dim=0)
        return torch.sum(second)


def default_gmm(d: int = 2, ncomp: int = 3, spread: float = 2.0) -> GMM:
    angles = torch.arange(ncomp, dtype=torch.float32) * (2 * math.pi / ncomp)
    base = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1) * spread
    if d > 2:
        base = torch.cat([base, torch.zeros(ncomp, d - 2)], dim=-1)
    else:
        base = base[:, :d]
    return GMM(means=base.float(), scales=torch.full((ncomp,), 0.5),
               weights=torch.full((ncomp,), 1.0 / ncomp))


def _posterior_mean(gmm: GMM, y_eff: torch.Tensor, t_eff: torch.Tensor):
    """E[x | y_eff] for the likelihood N(x; y_eff / t_eff, I / t_eff) under
    the GMM prior; batched over the leading axes of y_eff."""
    gmm = gmm.to(y_eff.device)
    prec_k = 1.0 / gmm.scales**2  # (ncomp,)
    y_e = y_eff[..., None, :]  # (..., 1, d)
    t_e = t_eff[..., None, None]  # (..., 1, 1)
    post_prec = prec_k[:, None] + t_e  # (..., ncomp, 1)
    post_mean = (gmm.means * prec_k[:, None] + y_e) / post_prec
    var_k = t_e**2 * gmm.scales[:, None] ** 2 + t_e  # (..., ncomp, 1)
    var_k = torch.clamp(var_k, min=1e-12)
    diff = y_e - t_e * gmm.means
    loglik = -0.5 * torch.sum(diff**2 / var_k, dim=-1) - 0.5 * gmm.d * torch.log(
        var_k[..., 0])
    r = torch.softmax(torch.log(gmm.weights) + loglik, dim=-1)  # (..., ncomp)
    return torch.sum(r[..., None] * post_mean, dim=-2)


def sl_mean_fn(gmm: GMM):
    """m(t, y) = E[x* | t x* + sqrt(t) xi = y] as a batched model_fn."""

    def model_fn(t, y):
        t = torch.clamp(t.float(), min=1e-12)
        t_b = t.reshape(t.shape + (1,) * (y.ndim - t.ndim - 1))
        return _posterior_mean(gmm, y.float(), t_b).to(y.dtype)

    return model_fn


def ddpm_x0_fn(gmm: GMM, abar: torch.Tensor):
    """E[x0 | x_s] for the discrete DDPM forward with cumulative alpha
    ``abar`` (K,), as a batched model_fn over timestep indices."""

    def model_fn(t, y):
        ab = abar.to(y.device)[t.long()]
        ab = ab.reshape(ab.shape + (1,) * (y.ndim - ab.ndim))
        t_eff = ab / torch.clamp(1.0 - ab, min=1e-12)
        y_eff = torch.sqrt(ab) * y / torch.clamp(1.0 - ab, min=1e-12)
        return _posterior_mean(gmm, y_eff, t_eff[..., 0]).to(y.dtype)

    return model_fn
