"""Speculation-window controllers: per-chain live theta.

A controller is a frozen dataclass (static configuration); its dynamic
state is a small float32 tensor per chain carried in ``ASDChainState.ctrl``
beside the live window ``theta_live``.  The window of round r depends only
on rounds < r, so adapting it leaves the committed chain's law unchanged.
Updates are tensor ops on every chain at once, with no read on the host,
so they run inside a superstep.

  ``StaticTheta``      theta_live == theta_max (or a fixed smaller value).
  ``AIMDTheta``        additive increase on a fully accepted window,
                       multiplicative backoff on a rejection.
  ``AcceptRateTheta``  the window tracks the expected accepted run length
                       1 / (1 - p_hat) of a discounted accept-rate estimate.

The float32 arithmetic follows the JAX package's jitted order (XLA's one
FMA included), so the windows are equal to its integer for integer and the
state bit for bit (``torch.round`` rounds half to even, as ``jnp.round``
does).  The branch controllers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ThetaController:
    """Interface: ``init`` and ``update`` over a batch of chains."""

    name = "base"

    def init(self, theta_max: int, batch: int, device):
        """-> (ctrl: (batch, n) f32 state, theta_live: (batch,) int32)."""
        raise NotImplementedError

    def update(self, ctrl, theta_live, accepts, n_valid, rejected, theta_max: int):
        """Observe one round (all arguments per chain), emit the next
        window, 1 <= theta_live' <= theta_max."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticTheta(ThetaController):
    """A constant window: ``value=None`` means the full ``theta_max``; a
    smaller ``value`` runs on the same theta_max-shaped buffers."""

    name = "static"
    value: typing.Optional[int] = None

    def _theta(self, theta_max: int, like: torch.Tensor):
        v = theta_max if self.value is None else min(self.value, theta_max)
        return torch.full_like(like, v, dtype=torch.int32)

    def init(self, theta_max: int, batch: int, device):
        ctrl = torch.zeros((batch, 0), dtype=torch.float32, device=device)
        like = torch.empty((batch,), dtype=torch.int32, device=device)
        return ctrl, self._theta(theta_max, like)

    def update(self, ctrl, theta_live, accepts, n_valid, rejected, theta_max: int):
        return ctrl, self._theta(theta_max, theta_live)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: scalars stay on the host
    (a tensor made from one would be copied to the device and wait on it)."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class AIMDTheta(ThetaController):
    """Additive increase / multiplicative decrease of the live window: a
    round without a rejection grows it by ``increase``, a rejection
    multiplies it by ``backoff``.  The state is the unrounded float window,
    so repeated small backoffs compound."""

    name = "aimd"
    increase: float = 1.0
    backoff: float = 0.5
    theta_min: int = 1

    def init(self, theta_max: int, batch: int, device):
        ctrl = torch.full((batch, 1), float(theta_max), dtype=torch.float32, device=device)
        return ctrl, torch.full((batch,), theta_max, dtype=torch.int32, device=device)

    def update(self, ctrl, theta_live, accepts, n_valid, rejected, theta_max: int):
        th = ctrl[:, 0]
        th = torch.where(rejected, torch.clamp(th * self.backoff, min=_f32(self.theta_min)),
                         torch.clamp(th + self.increase, max=_f32(theta_max)))
        live = torch.clamp(torch.round(th).to(torch.int32), self.theta_min, theta_max)
        return th[:, None], live


@dataclasses.dataclass(frozen=True)
class AcceptRateTheta(ThetaController):
    """Window sized to a discounted-counts estimate of the accept rate.

    The state is (discounted accepted slots, discounted verified slots);
    p_hat = (prior + s_acc) / (prior + s_prop) is a Beta-posterior mean
    under an optimistic prior, so a fresh chain opens fully.  ``decay``
    discounts old rounds, and the window is headroom / (1 - p_hat) clipped
    to [theta_min, theta_max]."""

    name = "accept-rate"
    decay: float = 0.95
    headroom: float = 1.0
    prior: float = 4.0
    theta_min: int = 1

    def init(self, theta_max: int, batch: int, device):
        ctrl = torch.zeros((batch, 2), dtype=torch.float32, device=device)
        return ctrl, torch.full((batch,), theta_max, dtype=torch.int32, device=device)

    def update(self, ctrl, theta_live, accepts, n_valid, rejected, theta_max: int):
        # XLA contracts decay * ctrl + obs into one FMA; in float64 the
        # float32 product is exact, so the sum rounds to float32 as it does
        obs = torch.stack([accepts, n_valid], dim=-1).to(torch.float64)
        s = (ctrl.double() * _f32(self.decay) + obs).to(torch.float32)
        p = (self.prior + s[:, 0]) / (self.prior + s[:, 1])
        # a true division (a Python float over a tensor would multiply by
        # the reciprocal)
        run = torch.full_like(p, self.headroom) / torch.clamp(
            1.0 - p, min=_f32(1.0 / (2.0 * theta_max)))
        live = torch.clamp(torch.floor(run).to(torch.int32), self.theta_min, theta_max)
        return s, live


CONTROLLERS = {c.name: c for c in (StaticTheta, AIMDTheta, AcceptRateTheta)}


def make_controller(name: str, **kwargs) -> ThetaController:
    """The serve CLI's factory: ``make_controller("aimd", backoff=0.75)``."""
    try:
        return CONTROLLERS[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown theta controller {name!r}; have {sorted(CONTROLLERS)}") from None
