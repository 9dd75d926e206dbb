"""``sharded_packed_superstep`` against the JAX package's
``packed_superstep`` looped over the shards in-process, on the CPU: each
shard's block of the stacked result within the packed round tests'
tolerance, integer state (positions, counters, windows, branch state)
equal, and equal in bits to the port's own ``packed_superstep`` on that
shard; at B 1 and 2, with a static budget and with per-shard tiers as
data."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import packing as j_pack
from repro_torch.serving import packing as t_pack
from tests.test_torch_branched import CASES, assert_states_close, controllers, slot_states
from tests.test_torch_packed_round import SLOTS, THETA

SUPERSTEP_CASES = {
    # (model, B, round_impl, static budget, per-shard tiers as data)
    "gmm-B1-packed-binding": ("gmm", 1, "packed", 6, None),
    "gmm-B1-fused-tiers": ("gmm", 1, "fused", SLOTS * THETA, (5, 11)),
    "gmm-B2-packed-shedding": ("gmm", 2, "packed", 9, None),
    "smoke-B2-fused-tiers": ("smoke", 2, "fused", SLOTS * THETA * 2, (7, 32)),
}


@pytest.mark.parametrize("name", sorted(SUPERSTEP_CASES))
def test_sharded_packed_superstep_matches_jax_per_shard(name):
    """Two shards of 4 slots each, stacked: shard i's block equals JAX's
    ``packed_superstep`` on that shard alone, and the port's own
    ``packed_superstep`` on it in bits."""
    model, nb, impl, budget, tiers = SUPERSTEP_CASES[name]
    case = CASES[model]()
    ctl = "gain" if nb > 1 else "static"
    jc, tc = controllers(ctl)
    pairs = [slot_states(case, nb, ctl, "counter", seed=10 + i) for i in range(2)]
    weights = np.array([[1.0, 2.0, 1.0, 1.5], [1.0, 1.0, 3.0, 1.0]], np.float32)
    alloc = dict(theta_max=THETA * nb)
    statics = dict(rounds=2, theta=THETA, budget=budget, eager_head=True,
                   keep_trajectory=False, round_impl=impl, noise_mode="counter",
                   num_branches=nb)
    stacked = dataclasses.replace(pairs[0][1], **{
        f.name: torch.stack([getattr(t, f.name) for _, t in pairs])
        for f in dataclasses.fields(pairs[0][1]) if getattr(pairs[0][1], f.name) is not None})
    out = t_pack.sharded_packed_superstep(
        case.t_fn, case.ts, stacked, None, torch.from_numpy(weights),
        allocator=t_pack.WaterfillingAllocator(**alloc), branch_controller=tc,
        budget_data=None if tiers is None else torch.tensor(tiers), **statics)
    assert out.a.shape == (2, SLOTS)
    # JAX's superstep on one shard, compiled once for both (the tier as data)
    jstep = jax.jit(lambda st, w, b: j_pack.packed_superstep(
        case.j_make, None, case.js, st, None, w,
        allocator=j_pack.WaterfillingAllocator(**alloc), branch_controller=jc,
        budget_data=b, **statics))
    for i, (jst, tst) in enumerate(pairs):
        b = None if tiers is None else tiers[i]
        jout = jstep(jst, jnp.asarray(weights[i]), None if b is None else jnp.int32(b))
        mine = dataclasses.replace(out, **{
            f.name: getattr(out, f.name)[i] for f in dataclasses.fields(out)
            if getattr(out, f.name) is not None})
        assert_states_close(jout, mine, case.tol, f"{name} shard {i}")
        alone = t_pack.packed_superstep(
            case.t_fn, case.ts, tst, None, torch.from_numpy(weights[i]),
            allocator=t_pack.WaterfillingAllocator(**alloc), branch_controller=tc,
            budget_data=b, **statics)
        for f in dataclasses.fields(alone):
            if getattr(alone, f.name) is not None:
                assert torch.equal(getattr(mine, f.name), getattr(alone, f.name)), f.name
    # the tiers bit: a shard granted less drafted fewer points
    if tiers is not None:
        spent = (out.draft_points - stacked.draft_points).sum(1)
        assert int(spent[0]) <= 2 * tiers[0] and int(spent[0]) < int(spent[1])
