"""The port's synthetic data pipelines against the JAX package's: equal
batches, bit for bit, at every step asked."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as j_data
from repro_torch.data import pipeline as t_data

CASES = {
    "blob-8x16": lambda m: m.BlobImages(grid=8, patch_dim=16, batch=5, seed=3),
    "blob-pixel": lambda m: m.BlobImages(grid=8, patch_dim=24, batch=32),
    "blob-full-width": lambda m: m.BlobImages(grid=32, patch_dim=192, batch=2),
    "gmm": lambda m: m.GMMSequences(seq_len=6, d_data=3, batch=4, seed=2),
    "reach": lambda m: m.RobotReach(horizon=16, batch=9, seed=1),
    "reach-policy": lambda m: m.RobotReach(horizon=16, batch=128),
}


def _arrays(out):
    return [np.asarray(x) for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("step", [0, 1, 999])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_reference_bit_for_bit(case, step):
    want = _arrays(CASES[case](j_data).batch_at(step))
    got = _arrays(CASES[case](t_data).batch_at(step))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        assert np.array_equal(g, w)


def test_reach_success_matches_the_reference():
    acts, obs = t_data.RobotReach(horizon=16, batch=64).batch_at(7)
    rng = np.random.default_rng(0)
    noisy = acts + rng.standard_normal(acts.shape).astype(np.float32) * 0.02
    want = np.asarray(j_data.RobotReach.success(noisy, obs))
    got = t_data.RobotReach.success(noisy, obs)
    assert np.array_equal(got, want)
    assert np.array_equal(t_data.RobotReach.success(torch.from_numpy(noisy),
                                                    torch.from_numpy(obs)).numpy(), want)
    assert 0 < want.sum() < len(want)
