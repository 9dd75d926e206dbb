"""The port's threefry generator (``repro_torch.core.prng``) against
``jax.random`` on the CPU: keys, splits, folds, raw bits and uniforms equal
bit for bit, normals within ``NORMAL_ULPS`` float32 ulps (XLA's ``log1p``
inside its ``erf_inv`` is its own), over seeds, shapes and batches of keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 42, 1000, 2**31 - 1, 2**31, 2**32 - 1, 2**40 + 3]
SHAPES = [(), (1,), (5,), (4097,), (3, 7), (2, 3, 5), (16, 14)]


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _ulps(a, b):
    """Float32 ulp distance, elementwise (same-sign values)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_folds_equal_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert tk.dtype == torch.int64 and _u32(jk).tolist() == tk.tolist()
    assert prng.as_key(np.asarray(jk)).tolist() == tk.tolist()
    for n in (1, 2, 5, 33):
        assert _u32(jax.random.split(jk, n)).tolist() == prng.split(tk, n).tolist()
    for d in (0, 1, 7, 1000, 2**31, 2**32 - 1):
        assert _u32(jax.random.fold_in(jk, d)).tolist() == prng.fold_in(tk, d).tolist()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_and_uniforms_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = prng.random_bits(tk, shape)
    assert bits.shape == shape and bits.dtype == torch.int64
    assert np.array_equal(_u32(jax.random.bits(jk, shape)), bits.numpy())
    u = prng.uniform(tk, shape)
    assert u.dtype == torch.float32
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)).view(np.int32),
                          u.numpy().view(np.int32))
    lo, hi = -2.5, 3.25
    assert np.array_equal(
        np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi)).view(np.int32),
        prng.uniform(tk, shape, lo, hi).numpy().view(np.int32))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_within_the_ulp_bound(seed, shape):
    jn = jax.random.normal(jax.random.PRNGKey(seed), shape)
    tn = prng.normal(prng.PRNGKey(seed), shape)
    assert tn.shape == shape and tn.dtype == torch.float32
    assert _ulps(jn, tn).max(initial=0) <= prng.NORMAL_ULPS


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_over_a_million_draws(seed):
    """Both branches of erf_inv (w < 5 and the tails) over 2^20 draws."""
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1 << 20,)))
    tn = prng.normal(prng.PRNGKey(seed), (1 << 20,)).numpy()
    assert np.abs(jn).max() > 4.0  # the tail branch ran
    assert _ulps(jn, tn).max() <= prng.NORMAL_ULPS


def test_torch_erfinv_would_break_the_bound():
    """Why the port carries XLA's polynomial: torch.erfinv on the same
    uniforms lands up to tens of ulps from jax.random.normal."""
    shape = (1 << 20,)
    u = prng.uniform(prng.PRNGKey(0), shape, prng._NORMAL_LO, 1.0)
    via_torch = torch.erfinv(u) * np.float32(np.sqrt(2.0))
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))
    assert _ulps(jn, via_torch).max() > 4 * prng.NORMAL_ULPS
    assert _ulps(jn, prng.normal(prng.PRNGKey(0), shape)).max() <= prng.NORMAL_ULPS


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    j = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    t = prng.erf_inv(x).numpy()
    assert np.isneginf(t[0]) and np.isposinf(t[1]) and t[2] == 0.0
    assert _ulps(j[2:], t[2:]).max() <= prng.NORMAL_ULPS


@pytest.mark.parametrize("lead", [(4,), (2, 3)], ids=str)
def test_a_batch_of_keys_draws_what_each_key_draws(lead):
    """A leading batch of keys: one call equals jax.random per key, the way
    a round's counter window draws every slot at once."""
    n = int(np.prod(lead))
    jkeys = jax.random.split(jax.random.PRNGKey(11), n).reshape(lead + (2,))
    tkeys = prng.as_key(np.asarray(jkeys))
    shape = (3, 5)
    steps = np.arange(n, dtype=np.int32).reshape(lead) * 3 + 1

    def per_key(fn):
        f = fn
        for _ in lead:
            f = jax.vmap(f)
        return f

    assert np.array_equal(_u32(per_key(lambda k: jax.random.bits(k, shape))(jkeys)),
                          prng.random_bits(tkeys, shape).numpy())
    folded = per_key(jax.random.fold_in)(jkeys, jnp.asarray(steps))
    assert np.array_equal(_u32(folded), prng.fold_in(tkeys, torch.from_numpy(steps)).numpy())
    assert np.array_equal(_u32(per_key(lambda k: jax.random.split(k, 3))(jkeys)),
                          prng.split(tkeys, 3).numpy())
    ju = per_key(lambda k: jax.random.uniform(k, ()))(folded)
    assert np.array_equal(np.asarray(ju).view(np.int32),
                          prng.uniform(prng.as_key(np.asarray(folded))).numpy().view(np.int32))
    jn = per_key(lambda k: jax.random.normal(k, shape))(folded)
    tn = prng.normal(prng.as_key(np.asarray(folded)), shape)
    assert tn.shape == lead + shape
    assert _ulps(jn, tn).max() <= prng.NORMAL_ULPS


def test_as_key_refuses_a_wrong_shape():
    with pytest.raises(ValueError, match="2 words"):
        prng.as_key(np.zeros(3, np.uint32))
