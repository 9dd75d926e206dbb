"""Speculation-window controllers: per-chain live theta.

A controller is a frozen dataclass (static configuration); its dynamic
state is a small float32 tensor per chain carried in ``ASDChainState.ctrl``
beside the live window ``theta_live``.  The window of round r depends only
on rounds < r, so adapting it leaves the committed chain's law unchanged.

Only ``StaticTheta`` is ported so far.
"""

from __future__ import annotations

import dataclasses
import typing

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
