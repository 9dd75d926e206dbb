"""Verifier — paper Algorithm 2.

Runs GRS on every speculated step in parallel, finds the first rejection,
and returns exact samples for the accepted prefix plus the reflected sample
at the first rejected index.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.grs.ops import grs


def leading_true_count(acc: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Number of leading True values along ``dim`` (int32)."""
    return torch.cumprod(acc.to(torch.int32), dim=dim).sum(dim=dim,
                                                           dtype=torch.int32)


def verify(u, xi, m_hat, m, sigma, n_valid=None, event_ndim: int = 1):
    """Parallel verification of a window of theta speculated steps.

    u: (theta,); xi, m_hat, m: (theta, *event); sigma: (theta,).  Slots at
    or beyond ``n_valid`` (default theta) are masked out.

    Returns (z (theta, *event), advance () int32, accepted (theta,) bool).
    """
    theta = u.shape[0]
    if n_valid is None:
        n_valid = theta
    z, acc = grs(u, xi, m_hat, m, sigma, event_ndim=event_ndim)
    slot = torch.arange(theta, device=u.device)
    acc = acc & (slot < n_valid)
    lead = leading_true_count(acc)
    advance = lead + (lead < n_valid).to(torch.int32)
    return z, advance, acc
