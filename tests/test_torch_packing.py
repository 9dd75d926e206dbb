"""The port's budget allocators and pack maps against the JAX package's:
the same demands, budgets and weights give the same integer grants and
maps, exactly, ties included (both break them with float32 rank keys and a
stable sort)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving import packing as j_pack
from repro_torch.serving import packing as t_pack

THETA_MAX = 8
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True)

# demands 0..theta_max (many equal, so ties are common); budgets from the
# number of active slots (the engines' floor) to past the total demand;
# weights from a few values (equal weights tie; their sums are exact)
cases = st.lists(st.integers(0, THETA_MAX), min_size=1, max_size=8).flatmap(
    lambda d: st.tuples(
        st.just(d),
        st.integers(max(1, sum(x > 0 for x in d)), max(2, sum(d) + 4)),
        st.lists(st.sampled_from([0.5, 1.0, 1.0, 2.0, 3.0]), min_size=len(d),
                 max_size=len(d))))

PAIRS = {
    "proportional": (j_pack.ProportionalAllocator(), t_pack.ProportionalAllocator()),
    "waterfill": (j_pack.WaterfillingAllocator(theta_max=THETA_MAX),
                  t_pack.WaterfillingAllocator(theta_max=THETA_MAX)),
    "priority": (j_pack.PriorityWeightedAllocator(), t_pack.PriorityWeightedAllocator()),
}
_JITTED = {name: jax.jit(j.allocate) for name, (j, _) in PAIRS.items()}


def _both(name, demand, budget, weights):
    jg = np.asarray(_JITTED[name](jnp.asarray(demand, jnp.int32), jnp.int32(budget),
                                  jnp.asarray(weights, jnp.float32)))
    tg = PAIRS[name][1].allocate(torch.tensor(demand), budget,
                                 torch.tensor(weights, dtype=torch.float32))
    return jg, tg


@pytest.mark.parametrize("name", sorted(PAIRS))
@SETTINGS
@given(case=cases)
def test_allocator_grants_equal_jax(name, case):
    demand, budget, weights = case
    jg, tg = _both(name, demand, budget, weights)
    assert tg.dtype == torch.int64
    assert tg.tolist() == jg.tolist(), (demand, budget, weights)
    d = np.array(demand)
    assert (tg.numpy() <= d).all() and int(tg.sum()) <= budget
    if d.sum() <= budget:
        assert tg.tolist() == demand
    else:
        assert (tg.numpy()[d >= 1] >= 1).all()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_allocator_ties_are_broken_as_jax_breaks_them(name):
    """Equal demands and weights over a budget that splits them unevenly:
    which slot gets the odd point is decided by the rank keys and the
    stable sort alone."""
    for demand, budget in (([4, 4, 4, 4], 9), ([8, 8, 8], 10), ([3, 5, 3, 5, 3], 11),
                           ([2, 2, 2, 2, 2, 2, 2, 2], 13)):
        weights = [1.0] * len(demand)
        jg, tg = _both(name, demand, budget, weights)
        assert tg.tolist() == jg.tolist(), (demand, budget)
        assert int(tg.sum()) == budget


@SETTINGS
@given(grants=st.lists(st.integers(0, THETA_MAX), min_size=1, max_size=8),
       extra=st.integers(0, 6))
def test_pack_maps_equal_jax(grants, extra):
    budget = max(1, sum(grants) + extra)
    jm = j_pack.build_pack_maps(jnp.asarray(grants, jnp.int32), budget)
    tm = t_pack.build_pack_maps(torch.tensor(grants), budget)
    for name in ("grants", "offsets", "total", "slot_id", "step_id", "valid"):
        assert getattr(tm, name).tolist() == np.asarray(getattr(jm, name)).tolist(), name
    assert tm.row_id(THETA_MAX).tolist() == np.asarray(jm.row_id(THETA_MAX)).tolist()


def test_pack_maps_lay_slots_out_contiguously():
    m = t_pack.build_pack_maps(torch.tensor([2, 0, 3]), 7)
    assert m.slot_id.tolist() == [0, 0, 2, 2, 2, 0, 0]
    assert m.step_id.tolist() == [0, 1, 0, 1, 2, 0, 0]
    assert m.valid.tolist() == [True] * 5 + [False] * 2
    assert m.row_id(4).tolist() == [0, 1, 8, 9, 10, 12, 12]


def test_make_allocator():
    assert isinstance(t_pack.make_allocator("waterfill", theta_max=5),
                      t_pack.WaterfillingAllocator)
    assert t_pack.make_allocator("waterfill", theta_max=5).theta_max == 5
    # theta_max goes only where it is a field
    assert isinstance(t_pack.make_allocator("priority", theta_max=5),
                      t_pack.PriorityWeightedAllocator)
    assert sorted(t_pack.ALLOCATORS) == sorted(j_pack.ALLOCATORS)
    with pytest.raises(ValueError, match="unknown budget allocator"):
        t_pack.make_allocator("lottery")
    with pytest.raises(TypeError):
        t_pack.make_allocator("proportional", theta_max=5, depth=3)
