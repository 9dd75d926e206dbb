"""Gaussian Rejection Sampler — paper Algorithm 3 (plain PyTorch).

Given a proposal N(m_hat, sigma^2 I) and target N(m, sigma^2 I) sharing a
variance, and the *same* standard normal ``xi`` that built the proposal
sample ``y_hat = m_hat + sigma * xi``:

  accept with prob  min(1, N(xi + v/sigma | 0, I) / N(xi | 0, I)),  v = m_hat - m
    -> return the proposal sample  m_hat + sigma * xi
  else
    -> return the reflected sample m + sigma * (xi - 2 v <v, xi> / ||v||^2)

The output is exactly N(m, sigma^2 I), and P[reject] = TV = 2 Phi(||v|| /
(2 sigma)) - 1.  This function is the plain version the CUDA GRS kernel
(``repro_torch.kernels.grs``) is held against.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-20


def bcast_right(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until ``x.ndim == ndim``."""
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.ndim))


def grs(u, xi, m_hat, m, sigma, event_ndim: int = 1):
    """Vectorized GRS.

    u: (*batch,) uniforms; xi, m_hat, m: (*batch, *event); sigma: (*batch,).
    Returns (x in xi's dtype, accept bool (*batch,)).  sigma == 0 degenerates
    to: accept iff m_hat == m, x = m.
    """
    batch_ndim = xi.ndim - event_ndim
    ev_axes = tuple(range(batch_ndim, xi.ndim))

    v = (m_hat - m).float()
    xi32 = xi.float()
    vnorm2 = torch.sum(v * v, dim=ev_axes)
    vdotxi = torch.sum(v * xi32, dim=ev_axes)

    sigma = sigma.float()
    safe_sigma = torch.where(sigma > 0, sigma, torch.ones_like(sigma))
    log_ratio = -(vdotxi / safe_sigma + vnorm2 / (2.0 * safe_sigma**2))
    log_u = torch.log(torch.clamp(u.float(), min=_EPS))
    accept = log_u <= torch.clamp(log_ratio, max=0.0)
    accept = torch.where(sigma > 0, accept, vnorm2 <= 0.0)

    safe_vnorm2 = torch.where(vnorm2 > 0, vnorm2, torch.ones_like(vnorm2))
    coef = 2.0 * vdotxi / safe_vnorm2
    xi_ref = xi32 - bcast_right(coef, xi.ndim) * v
    xi_ref = torch.where(bcast_right(vnorm2 > 0, xi.ndim), xi_ref, xi32)

    sig_b = bcast_right(sigma, xi.ndim)
    acc_b = bcast_right(accept, xi.ndim)
    x = torch.where(acc_b, m_hat + sig_b * xi32, m + sig_b * xi_ref)
    return x.to(xi.dtype), accept


def grs_reject_prob(m_hat, m, sigma, event_ndim: int = 1):
    """Closed-form P[reject] = TV of the two Gaussians."""
    ev_axes = tuple(range(m.ndim - event_ndim, m.ndim))
    dist = torch.sqrt(torch.sum((m_hat - m) ** 2, dim=ev_axes))
    return torch.erf(dist / (2.0 * sigma) / math.sqrt(2.0))
