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
does).

Branch controllers (branched speculation, ``num_branches`` B > 1) decide
each chain's live branch count ``b_live`` <= B the same way, from state
``bctrl`` carried beside it:

  ``StaticBranches``   b_live == B (or a fixed smaller value).
  ``GainBranches``     the count steps up or down with a discounted average
                       of the accepted slots each extra branch bought.
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


# -- branch controllers: the live draft-branch count of each chain ----------


@dataclasses.dataclass(frozen=True)
class BranchController:
    """Interface: ``init`` and ``update`` over a batch of chains."""

    name = "base"

    def init(self, b_max: int, batch: int, device):
        """-> (bctrl: (batch, n) f32 state, b_live: (batch,) int32)."""
        raise NotImplementedError

    def update(self, bctrl, b_live, gain, lead, rejected, b_max: int):
        """Observe one branched round, emit the next branch count.

        ``b_live``: branches the round ran; ``gain``: accepted slots the
        winning branch bought over branch 0 (0 when branch 0 won); ``lead``
        and ``rejected``: the selected branch's accepted prefix and whether
        it hit a rejection; all per chain.  Returns (bctrl', b_live'), with
        1 <= b_live' <= b_max."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StaticBranches(BranchController):
    """A constant branch count: ``value=None`` means the full ``b_max``;
    ``b_max == 1`` is the single-draft sampler."""

    name = "static"
    value: typing.Optional[int] = None

    def _b(self, b_max: int, like: torch.Tensor):
        v = b_max if self.value is None else min(self.value, b_max)
        return torch.full_like(like, max(v, 1), dtype=torch.int32)

    def init(self, b_max: int, batch: int, device):
        bctrl = torch.zeros((batch, 0), dtype=torch.float32, device=device)
        return bctrl, self._b(b_max, torch.empty((batch,), dtype=torch.int32, device=device))

    def update(self, bctrl, b_live, gain, lead, rejected, b_max: int):
        return bctrl, self._b(b_max, b_live)


@dataclasses.dataclass(frozen=True)
class GainBranches(BranchController):
    """Branch count tracked to a discounted average of the realised gain.

    The state is one float32 a chain: an EWMA of ``gain / (b_live - 1)``,
    the accepted slots each extra branch bought (a round with one branch
    carries no information and leaves it as it was).  At or above ``grow``
    the count steps up, below ``shrink`` it steps down, so chains that
    accept everything fall back to one branch and early-rejecting chains
    widen toward the cap."""

    name = "gain"
    decay: float = 0.9
    grow: float = 0.35
    shrink: float = 0.1

    def init(self, b_max: int, batch: int, device):
        # an optimistic start: open at the cap with a prior above ``grow``
        bctrl = torch.full((batch, 1), 2.0 * self.grow, dtype=torch.float32, device=device)
        return bctrl, torch.full((batch,), max(b_max, 1), dtype=torch.int32, device=device)

    def update(self, bctrl, b_live, gain, lead, rejected, b_max: int):
        extra = torch.clamp(b_live - 1, min=0).to(torch.float32)
        per_branch = gain.to(torch.float32) / torch.clamp(extra, min=1.0)
        # XLA rounds decay * g, then contracts (1 - decay) * per_branch + that
        # into one FMA; the float32 product is exact in float64, so the sum
        # there rounds to float32 as the FMA does
        kept = bctrl[:, 0] * _f32(self.decay)
        g = (per_branch.double() * _f32(1.0 - self.decay) + kept.double()).to(torch.float32)
        g = torch.where(extra > 0, g, bctrl[:, 0])
        b_next = torch.where(g >= _f32(self.grow), b_live + 1,
                             torch.where(g < _f32(self.shrink), b_live - 1, b_live))
        return g[:, None], torch.clamp(b_next, 1, max(b_max, 1)).to(torch.int32)


BRANCH_CONTROLLERS = {c.name: c for c in (StaticBranches, GainBranches)}


def make_branch_controller(name: str, **kwargs) -> BranchController:
    """The serve CLI's factory: ``make_branch_controller("gain", grow=0.5)``."""
    try:
        return BRANCH_CONTROLLERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown branch controller {name!r}; "
                         f"have {sorted(BRANCH_CONTROLLERS)}") from None
