"""The port's fused round pair (B5 fused gather, B6 fused verify-commit)
against the JAX package's, on the CPU: the port's plain versions against
the JAX jnp references and the Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.superstep import fused_gather as j_fgather
from repro.kernels.superstep import fused_verify_commit as j_fvc
from repro_torch.kernels.superstep import ops as t_fused

JAX_IMPLS = {"ref": dict(impl="ref"), "interpret": dict(impl="kernel", interpret=True)}


@pytest.mark.parametrize("jimpl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("event", [(6,), (3, 5), (2, 2, 33)])
def test_fused_gather_equals_jax(event, jimpl):
    rng = np.random.default_rng(0)
    N, C = 10, 5
    tbls = [rng.standard_normal((N,) + event).astype(np.float32) for _ in range(3)]
    sc = rng.standard_normal((N, C)).astype(np.float32)
    idx = np.array([4, 9, 0, 2, 2, 7, 0, 0, 0], np.int32)  # M = 9, padding re-reads 0
    want = j_fgather(*(jnp.asarray(t) for t in tbls), jnp.asarray(sc), jnp.asarray(idx),
                     **JAX_IMPLS[jimpl])
    got = t_fused.fused_gather(*(torch.from_numpy(t) for t in tbls), torch.from_numpy(sc),
                               torch.from_numpy(idx).long())
    assert [tuple(g.shape) for g in got] == [(9,) + event] * 3 + [(9, C)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _commit_inputs(M, event, seed):
    """Rows of a verify-commit call with a mix of accepts and rejections,
    plus sigma = 0 rows with v = 0 (row 1: accept, z = m_hat = m) and
    v != 0 (row 0: reject, z = m)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    y, g, xi = f(M, *event), f(M, *event), f(M, *event)
    A = (1.0 + 0.1 * rng.random(M)).astype(np.float32)
    B = (0.5 * rng.random(M)).astype(np.float32)
    m = A.reshape((M,) + (1,) * len(event)) * y + B.reshape((M,) + (1,) * len(event)) * g
    d = int(np.prod(event))
    # m_hat a little off the target: scaled so the accept probability is
    # neither 0 nor 1
    mh = (m + 0.3 * f(M, *event) / np.sqrt(d)).astype(np.float32)
    sigma = (0.2 + 0.3 * rng.random(M)).astype(np.float32)
    u = rng.random(M).astype(np.float32)
    sigma[0] = 0.0
    # v == 0 exactly, however the target mean rounds (FMA or not): A = 1, B = 0
    sigma[1], A[1], B[1], mh[1] = 0.0, 1.0, 0.0, y[1]
    return y, g, xi, mh, A, B, u, sigma


def _near_threshold(y, g, xi, mh, A, B, u, sigma):
    """Rows within float rounding of the GRS accept threshold."""
    ev_axes = tuple(range(1, y.ndim))
    shape = (-1,) + (1,) * (y.ndim - 1)
    m = A.astype(np.float64).reshape(shape) * y + B.astype(np.float64).reshape(shape) * g
    v = mh - m
    vv, vx = (v * v).sum(ev_axes), (v * xi).sum(ev_axes)
    s = np.where(sigma > 0, sigma, 1.0).astype(np.float64)
    margin = np.abs(np.log(np.maximum(u, 1e-20)) - np.minimum(-(vx / s + vv / (2 * s * s)), 0))
    return (margin < 1e-5) & (sigma > 0)


@pytest.mark.parametrize("jimpl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("event", [(7,), (3, 50), (2, 4, 17)])
def test_fused_verify_commit_matches_jax(event, jimpl):
    # M = 13 is not a multiple of 8: the JAX wrapper pads 3 rows (their sigma
    # padded to 1.0) that must drop; rows 3 and 8 are dropped (idx >= N);
    # N = 20 leaves rows no index names, which must come back zero
    M, N = 13, 20
    args = _commit_inputs(M, event, seed=sum(event))
    idx = np.array([19, 0, 5, 20, 2, 11, 7, 3, 33, 14, 1, 9, 16], np.int32)
    jz, jacc = j_fvc(*(jnp.asarray(a) for a in args), jnp.asarray(idx), N,
                     **JAX_IMPLS[jimpl])
    tz, tacc = t_fused.fused_verify_commit(*(torch.from_numpy(a) for a in args),
                                           torch.from_numpy(idx).long(), N)
    assert tz.shape == (N,) + event and tacc.dtype == torch.bool
    # z within 1e-5 relative: the same float32 GRS, sums in other orders
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    near = np.zeros(N, bool)
    live = idx < N
    near[idx[live]] = _near_threshold(*args)[live]
    np.testing.assert_array_equal(tacc.numpy()[~near], np.asarray(jacc)[~near])
    # sigma 0: v != 0 rejects, v == 0 accepts, both land z = m
    assert not tacc[19] and tacc[0]
    unwritten = np.setdiff1d(np.arange(N), idx[live])
    assert not tz[unwritten].any() and not tacc[unwritten].any()
    assert 0 < int(tacc.sum()) < int(live.sum())


def test_fused_verify_commit_is_the_unfused_composition():
    """The plain fused pair is the packed round's unfused steps: target
    mean, GRS, scatter of z and of accept, with the same results."""
    from repro_torch.core.grs import grs
    from repro_torch.kernels.pack.ops import scatter_rows

    y, g, xi, mh, A, B, u, sigma = (torch.from_numpy(a) for a in _commit_inputs(9, (11,), 5))
    idx = torch.tensor([3, 12, 0, 7, 1, 15, 4, 2, 9])
    z_t, acc_t = t_fused.fused_verify_commit(y, g, xi, mh, A, B, u, sigma, idx, 12)
    z, acc = grs(u, xi, mh, A[:, None] * y + B[:, None] * g, sigma)
    assert torch.equal(z_t, scatter_rows(z, idx, 12))
    want = torch.zeros(13, dtype=torch.bool)
    want[torch.clamp(idx, max=12)] = acc
    assert torch.equal(acc_t, want[:12])


def test_cpu_calls_count_no_launches():
    before = (t_fused.fused_gather.launches, t_fused.fused_verify_commit.launches)
    args = [torch.from_numpy(a) for a in _commit_inputs(4, (3,), 1)]
    t_fused.fused_gather(args[0], args[1], args[2], torch.zeros(4, 5), torch.tensor([1, 0]))
    t_fused.fused_verify_commit(*args, torch.tensor([0, 1, 2, 9]), 4)
    assert (t_fused.fused_gather.launches, t_fused.fused_verify_commit.launches) == before
