"""The port's ragged row gather and scatter (B3, B4) against the JAX
package's, on the CPU: the port's plain versions against the JAX jnp
references and the Pallas kernels in interpret mode.  Data movement, so
the results must be equal, not close."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pack import gather_rows as j_gather
from repro.kernels.pack import scatter_rows as j_scatter
from repro_torch.kernels.pack import ops as t_pack

EVENTS = {"rank0": (), "rank1": (5,), "rank2": (3, 7), "rank3": (2, 3, 5)}
JAX_IMPLS = {"ref": dict(impl="ref"), "interpret": dict(impl="kernel", interpret=True)}


def _table(n, event, seed):
    return np.random.default_rng(seed).standard_normal((n,) + event).astype(np.float32)


@pytest.mark.parametrize("jimpl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("event", sorted(EVENTS))
def test_gather_rows_equals_jax(event, jimpl):
    # M = 11 is not a multiple of the TPU's 8-row blocks; D = 5, 21, 30 are
    # not multiples of 128 lanes; the trailing zeros are padding lanes that
    # re-read row 0
    N, ev = 9, EVENTS[event]
    src = _table(N, ev, 1)
    idx = np.array([3, 8, 0, 3, 5, 1, 7, 0, 0, 0, 0], np.int32)
    want = np.asarray(j_gather(jnp.asarray(src), jnp.asarray(idx), **JAX_IMPLS[jimpl]))
    got = t_pack.gather_rows(torch.from_numpy(src), torch.from_numpy(idx).long())
    assert got.shape == (len(idx),) + ev
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("jimpl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("event", sorted(EVENTS))
def test_scatter_rows_equals_jax(event, jimpl):
    N, ev = 12, EVENTS[event]
    vals = _table(7, ev, 2)
    # rows 2, 4, 6, 8, 10 and 11 are never written; 12 and 40 are dropped
    idx = np.array([5, 0, 12, 9, 3, 40, 7], np.int32)
    want = np.asarray(j_scatter(jnp.asarray(vals), jnp.asarray(idx), N,
                                **JAX_IMPLS[jimpl]))
    got = t_pack.scatter_rows(torch.from_numpy(vals), torch.from_numpy(idx).long(), N)
    assert got.shape == (N,) + ev
    np.testing.assert_array_equal(got.numpy(), want)
    unwritten = [2, 4, 6, 8, 10, 11]
    assert not got[unwritten].any()


@pytest.mark.parametrize("jimpl", sorted(JAX_IMPLS))
def test_scatter_rows_with_every_row_dropped_is_all_zero(jimpl):
    vals = _table(6, (130,), 3)
    idx = np.full((6,), 10, np.int32)  # all at or past num_rows = 10
    want = np.asarray(j_scatter(jnp.asarray(vals), jnp.asarray(idx), 10,
                                **JAX_IMPLS[jimpl]))
    got = t_pack.scatter_rows(torch.from_numpy(vals), torch.from_numpy(idx).long(), 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()


def test_scatter_inverts_gather_on_the_pack_layout():
    """The round's use: gather a packed batch, scatter it back through the
    drop-row map; granted rows round-trip, the others are zero."""
    S, theta, ev = 3, 4, (6,)
    tbl = torch.from_numpy(_table(S * theta, ev, 4))
    rows = torch.tensor([0, 1, 4, 8, 9, 10, 0, 0])
    valid = torch.tensor([True] * 6 + [False] * 2)
    packed = t_pack.gather_rows(tbl, torch.where(valid, rows, 0))
    back = t_pack.scatter_rows(packed, torch.where(valid, rows, S * theta), S * theta)
    live = rows[valid]
    torch.testing.assert_close(back[live], tbl[live], rtol=0, atol=0)
    dead = torch.ones(S * theta, dtype=torch.bool)
    dead[live] = False
    assert not back[dead].any()


def test_wrappers_refuse_devices_without_a_kernel():
    src = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_pack.gather_rows(src, torch.zeros(2, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        t_pack.scatter_rows(src, torch.zeros(4, dtype=torch.long, device="meta"), 4)


def test_cpu_calls_count_no_launches():
    before = (t_pack.gather_rows.launches, t_pack.scatter_rows.launches)
    t_pack.gather_rows(torch.ones(3, 2), torch.tensor([2, 0]))
    t_pack.scatter_rows(torch.ones(2, 2), torch.tensor([1, 5]), 3)
    assert (t_pack.gather_rows.launches, t_pack.scatter_rows.launches) == before
