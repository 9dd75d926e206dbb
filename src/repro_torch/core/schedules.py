"""Diffusion step schedules in the unified affine form of the paper (Eq. 5).

Every sampler step (sequential DDPM, sequential SL, and ASD) is

    y_{i+1} = A_i * y_i + B_i * g(t_i, y_i) + sigma_i * xi_{i+1}

with ``g`` the model ("mean oracle").  SL: A = 1, B = eta_i, sigma =
sqrt(eta_i).  DDPM ancestral sampling over an x0-predicting model: the
posterior-mean coefficients in denoising order (paper Remark 2).

Tables are built in float64 with numpy and stored as float32 tensors, as
the JAX package builds them.  They are made on the CPU; a sampler moves
them to its device with ``Schedule.to``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Affine step schedule (all tensors have length K).

    Step ``i`` (0-based) advances ``y_i -> y_{i+1}``:
      mean = A[i] * y_i + B[i] * g(t_model[i], y_i);  y_{i+1} = mean + sigma[i] * xi.
    """

    t_model: torch.Tensor  # (K,) model conditioning per step
    A: torch.Tensor  # (K,)
    B: torch.Tensor  # (K,)
    sigma: torch.Tensor  # (K,) std of the noise injected by step i
    kind: str = "sl"
    y0_mode: str = "zeros"

    @property
    def K(self) -> int:
        return self.t_model.shape[0]

    def to(self, device) -> "Schedule":
        return dataclasses.replace(
            self, t_model=self.t_model.to(device), A=self.A.to(device),
            B=self.B.to(device), sigma=self.sigma.to(device))

    def pad(self, extra: int) -> "Schedule":
        """Pad by ``extra`` inert slots (A=1, B=0, sigma=0) so fixed-size
        speculation windows may run past step K."""
        def padc(x, c):
            return torch.cat([x, x.new_full((extra,), c)])

        return dataclasses.replace(
            self,
            t_model=torch.cat([self.t_model, self.t_model[-1:].expand(extra)]),
            A=padc(self.A, 1.0),
            B=padc(self.B, 0.0),
            sigma=padc(self.sigma, 0.0),
        )


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _sl(t: np.ndarray) -> Schedule:
    eta = np.diff(t)
    K = eta.shape[0]
    return Schedule(t_model=_f32(t[:-1]), A=torch.ones(K), B=_f32(eta),
                    sigma=_f32(np.sqrt(eta)), kind="sl", y0_mode="zeros")


def sl_uniform(K: int, t_min: float = 0.0, t_max: float = 20.0) -> Schedule:
    """Uniform SL grid (equal increments => exchangeable increments)."""
    return _sl(np.linspace(t_min, t_max, K + 1))


def sl_geometric(K: int, t_min: float = 1e-2, t_max: float = 100.0) -> Schedule:
    """Geometric SL grid, fine near the data end."""
    return _sl(np.concatenate([[0.0], np.geomspace(t_min, t_max, K)]))


def _betas(K: int, kind: Literal["linear", "cosine"]) -> np.ndarray:
    if kind == "linear":
        return np.linspace(1e-4 * (1000 / K), 0.02 * (1000 / K), K).clip(0, 0.999)
    if kind == "cosine":
        s = 0.008
        steps = np.arange(K + 1, dtype=np.float64) / K
        abar = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
        betas = 1.0 - abar[1:] / abar[:-1]
        return betas.clip(0, 0.999)
    raise ValueError(kind)


def ddpm(K: int, beta_schedule: Literal["linear", "cosine"] = "cosine") -> Schedule:
    """DDPM ancestral sampler as an affine schedule over an x0-predicting
    model.  Step i runs in denoising order: diffusion timestep s = K - i,
    ``t_model[i] = s - 1``."""
    betas = _betas(K, beta_schedule).astype(np.float64)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    abar_prev = np.concatenate([[1.0], abar[:-1]])
    A_s = np.sqrt(alphas) * (1.0 - abar_prev) / (1.0 - abar)
    B_s = np.sqrt(abar_prev) * betas / (1.0 - abar)
    var_s = betas * (1.0 - abar_prev) / (1.0 - abar)
    rev = slice(None, None, -1)
    return Schedule(
        t_model=_f32(np.arange(K)[rev]),
        A=_f32(A_s[rev]),
        B=_f32(B_s[rev]),
        sigma=_f32(np.sqrt(var_s[rev])),
        kind="ddpm",
        y0_mode="std_normal",
    )


def ddpm_coeffs(K: int, beta_schedule: str = "cosine"):
    """(betas, alphas, abar) as float32 tensors."""
    betas = _betas(K, beta_schedule)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    return _f32(betas), _f32(alphas), _f32(abar)


# ---------------------------------------------------------------------------
# SL <-> OU-DDPM reparametrization (paper Thm 9)
# ---------------------------------------------------------------------------


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; a Python or numpy number as float32."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(a, dtype=torch.float32)


def ou_time_of_sl(t):
    """s(t) = .5 ln(1 + 1/t)."""
    return 0.5 * torch.log1p(1.0 / _tensor(t))


def sl_time_of_ou(s):
    """Inverse of ``ou_time_of_sl``: t(s) = 1 / (e^{2s} - 1)."""
    return 1.0 / torch.expm1(2.0 * _tensor(s))


def sl_of_ddpm_state(x_rev, s):
    """ybar_t = t e^{s(t)} xbar^{<-}_{s(t)} with t = t(s); returns (ybar, t)."""
    s = _tensor(s)
    t = sl_time_of_ou(s)
    return t * torch.exp(s) * x_rev, t


def ddpm_of_sl_state(y, t):
    """The inverse of ``sl_of_ddpm_state``: (y / (t e^{s}), s) with s = s(t)."""
    t = _tensor(t)
    s = ou_time_of_sl(t)
    return y / (t * torch.exp(s)), s
