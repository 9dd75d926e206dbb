"""Deterministic synthetic data pipelines.

Every pipeline is a pure function of (seed, step): after a restart the
loop resumes at the saved step and draws exactly the batches it would have
seen.  Each draws with numpy from ``default_rng((seed, step, salt))`` as the
JAX package's ``repro.data.pipeline`` does, so both packages' batches are
equal bit for bit.  ``batch_at`` returns numpy arrays.

  * MarkovLM     -- a learnable token stream from a random Markov chain
                    (latent states, each emitting from its own sparse
                    distribution over the vocabulary) for the LM trainer
  * GMMSequences -- (B, L, d) rows drawn from a GMM (a diffusion toy target)
  * BlobImages   -- "images" as patch-token sequences: 1-3 Gaussian bumps
                    at random centres (pixel / latent diffusion stand-in)
  * RobotReach   -- expert action sequences for a 2-D reach task with
                    observation conditioning (diffusion-policy stand-in)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MarkovLM:
    """Token sequences (B, L + 1) from a random 64-state Markov chain whose
    states emit tokens; ``batch_at`` returns the first L as ``tokens`` and
    the last L as ``labels``, int32 numpy arrays.  The draws are the JAX
    package's host loop of one ``rng.choice(n, p=row)`` a token and a
    state, bit for bit: each such call takes one ``rng.random()`` and
    searches it in the row's float64 cumulative sum, normalised by its
    last entry, so the sums are made once here and each draw is a search
    (``choice`` makes the sum anew every call, O(vocab) a token)."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    order_states: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish random transition matrix over latent states -> tokens
        self.trans = rng.dirichlet(
            np.full(self.order_states, 0.1), size=self.order_states
        ).astype(np.float32)
        self.emit = rng.dirichlet(
            np.full(self.vocab, 0.05), size=self.order_states
        ).astype(np.float32)
        self._trans_cdf, self._emit_cdf = (_choice_cdf(p) for p in (self.trans, self.emit))

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        B, L = self.batch, self.seq_len
        states = rng.integers(0, self.order_states, size=B)
        toks = np.empty((B, L + 1), np.int32)
        for i in range(L + 1):
            toks[:, i] = _choices(self._emit_cdf, states, rng)
            states = _choices(self._trans_cdf, states, rng)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _choice_cdf(p):
    """Each row's cumulative sum as ``Generator.choice`` makes it from ``p``:
    in float64, divided by its last entry."""
    cdf = np.cumsum(p.astype(np.float64), axis=1)
    return cdf / cdf[:, -1:]


def _choices(cdf, rows, rng):
    """``[rng.choice(n, p=P[r]) for r in rows]`` for the P of ``cdf``: one
    uniform a row, in order, searched on the right."""
    return np.array([np.searchsorted(cdf[r], u, side="right")
                     for r, u in zip(rows, rng.random(len(rows)))])


@dataclasses.dataclass
class GMMSequences:
    """x0 rows: each of L positions drawn iid from a d-dim GMM."""

    seq_len: int
    d_data: int
    batch: int
    seed: int = 0
    ncomp: int = 4
    spread: float = 1.5

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.means = (rng.standard_normal((self.ncomp, self.d_data))
                      * self.spread).astype(np.float32)
        self.scales = np.full(self.ncomp, 0.3, np.float32)

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step, 7))
        comp = rng.integers(0, self.ncomp, size=(self.batch, self.seq_len))
        eps = rng.standard_normal((self.batch, self.seq_len, self.d_data)).astype(np.float32)
        return self.means[comp] + self.scales[comp][..., None] * eps


@dataclasses.dataclass
class BlobImages:
    """Images as (grid * grid, patch_dim) token grids with 1-3 Gaussian
    bumps, each scalar patch value lifted into ``patch_dim`` channels by a
    fixed projection."""

    grid: int = 8
    patch_dim: int = 16
    batch: int = 16
    seed: int = 0

    @property
    def seq_len(self):
        return self.grid * self.grid

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step, 11))
        B, G, P = self.batch, self.grid, self.patch_dim
        yy, xx = np.mgrid[0:G, 0:G].astype(np.float32) / G
        imgs = np.zeros((B, G, G), np.float32)
        for b in range(B):
            for _ in range(rng.integers(1, 4)):
                cx, cy = rng.random(2)
                s = 0.08 + 0.12 * rng.random()
                imgs[b] += np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
        imgs = imgs / np.maximum(imgs.max(axis=(1, 2), keepdims=True), 1e-6) * 2 - 1
        proj = np.random.default_rng(self.seed).standard_normal((1, P)).astype(np.float32)
        return imgs.reshape(B, G * G, 1) * proj


@dataclasses.dataclass
class RobotReach:
    """Expert demos for a 2-D reach task.

    obs = (start_xy, goal_xy); the expert action sequence is ``horizon``
    equal steps along the straight line, with small noise.  A policy whose
    actions sum to land near the goal succeeds (``success``, the paper's
    Table 3 proxy)."""

    horizon: int = 16
    action_dim: int = 2
    batch: int = 64
    seed: int = 0
    noise: float = 0.05

    def batch_at(self, step: int):
        """(actions (B, horizon, 2), obs (B, 4))."""
        rng = np.random.default_rng((self.seed, step, 13))
        B, K = self.batch, self.horizon
        start = rng.uniform(-1, 1, size=(B, 2)).astype(np.float32)
        goal = rng.uniform(-1, 1, size=(B, 2)).astype(np.float32)
        base = (goal - start)[:, None, :] / K
        acts = np.repeat(base, K, axis=1)
        acts += rng.standard_normal(acts.shape).astype(np.float32) * self.noise / K
        obs = np.concatenate([start, goal], axis=-1)
        return acts, obs

    @staticmethod
    def success(actions, obs, tol: float = 0.15):
        """actions (B, K, 2), obs (B, 4), numpy or tensors -> bool (B,):
        the summed actions end within ``tol`` of the goal."""
        start, goal = obs[:, :2], obs[:, 2:]
        final = start + actions.sum(axis=1)
        if isinstance(final, torch.Tensor):
            return torch.linalg.norm(final - goal, dim=-1) < tol
        return np.linalg.norm(final - goal, axis=-1) < tol
