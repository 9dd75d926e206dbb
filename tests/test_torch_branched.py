"""Branched speculation in the port's samplers against the JAX package's, on
the CPU, from the same slot states (``from_jax_chain_state``) or the same
keys, with the same weights.

Branch 0 is the canonical stream, so one branch is the single-draft round
bit for bit.  At B 2 and 3: the branch windows' uniforms equal JAX's and
their normals within ``prng.NORMAL_ULPS``; integer state (positions,
counters, windows, branch counts, drafted points) equal; the branch
controller's state equal to the bit; samples within 1e-4 (the GMM oracle
1e-5).  The schedules here have no sigma-0 step, so no accept bit sits at
the GRS threshold by construction (one within float rounding of it would
show as a counter that differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asd as j_asd
from repro.core import controller as j_ctl
from repro_torch.core import asd as t_asd
from repro_torch.core import controller as t_ctl
from repro_torch.core import prng
from repro_torch.weights import from_jax_chain_state
from tests.test_torch_packed_round import K, SLOTS, THETA, gmm_case, smoke_case

EXACT = ("a", "v_valid", "rounds", "head_calls", "model_evals", "accepts", "proposals",
         "theta_live", "b_live", "draft_points")
CASES = {"gmm": gmm_case, "smoke": smoke_case}


def controllers(name):
    kw = {"gain-tuned": dict(decay=0.8, grow=0.5, shrink=0.2)}.get(name, {})
    kind = name.split("-")[0]
    return j_ctl.make_branch_controller(kind, **kw), t_ctl.make_branch_controller(kind, **kw)


def slot_states(case, nb, ctl="static", noise_mode="buffer", keep=False, seed=0):
    """A JAX slot batch with ragged windows and positions (one slot already
    finished) and B ``nb`` branches, and the same batch in the port."""
    jc, _ = controllers(ctl)
    keys = jax.random.split(jax.random.PRNGKey(seed), SLOTS)
    y0 = np.random.default_rng(seed).standard_normal((SLOTS,) + case.event).astype(np.float32)
    states = jax.vmap(lambda y, k: j_asd.init_chain_state(
        case.js, y, k, THETA, noise_mode, keep, num_branches=nb,
        branch_controller=jc))(jnp.asarray(y0), keys)
    states = dataclasses.replace(
        states, theta_live=jnp.asarray([4, 2, 1, 3], jnp.int32),
        a=jnp.asarray([0, 3, K - 2, K], jnp.int32) if not keep else states.a)
    tstates = from_jax_chain_state(jax.tree_util.tree_map(np.asarray, states), K, THETA,
                                   device="cpu")
    return states, tstates


def assert_states_close(jst, tst, tol, what=""):
    for name in EXACT:
        assert getattr(tst, name).tolist() == np.asarray(getattr(jst, name)).tolist(), \
            f"{what}: {name}"
    assert np.array_equal(tst.bctrl.numpy().view(np.int32),
                          np.asarray(jst.bctrl).view(np.int32)), f"{what}: bctrl"
    for name in ("y", "v_cache"):
        np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=tol, atol=tol, err_msg=f"{what}: {name}")


# ---------------------------------------------------------------- one branch


@pytest.mark.parametrize("noise_mode", ["buffer", "counter"])
def test_one_branch_is_the_single_draft_round_bit_for_bit(noise_mode):
    """num_branches=1 with a branch controller of its own is today's round:
    every field equal to the bit (the controller's state is its own)."""
    case = smoke_case()
    _, tst = slot_states(case, 1, noise_mode=noise_mode, seed=1)
    plain = t_asd.asd_superstep(case.t_fn, case.ts, tst, THETA, 3, eager_head=True,
                                keep_trajectory=False, noise_mode=noise_mode)
    one = t_asd.asd_superstep(case.t_fn, case.ts, tst, THETA, 3, eager_head=True,
                              keep_trajectory=False, noise_mode=noise_mode, num_branches=1,
                              branch_controller=t_ctl.GainBranches())
    for f in dataclasses.fields(t_asd.ASDChainState):
        a, b = getattr(plain, f.name), getattr(one, f.name)
        if a is not None:
            assert torch.equal(a, b), f.name
    assert torch.equal(one.draft_points, one.proposals)
    assert one.b_live.tolist() == [1] * SLOTS


# ---------------------------------------------------------------- noise


@pytest.mark.parametrize("noise_mode", ["buffer", "counter"])
def test_branch_windows_match_jax(noise_mode):
    """plan_round's branch stacks: u equal to the bit, xi within
    NORMAL_ULPS, branch 0 the canonical window; rollouts within 1e-5."""
    case, nb = gmm_case(), 3
    jst, tst = slot_states(case, nb, noise_mode=noise_mode, seed=2)
    model = case.j_make(None, None)
    jplan = jax.jit(jax.vmap(lambda st: j_asd.plan_round(
        model, case.js, st, THETA, True, noise_mode, False, nb)))(jst)
    tplan = t_asd.plan_round(case.t_fn, case.ts, tst, THETA, True, False,
                             noise_mode=noise_mode, num_branches=nb)
    assert np.array_equal(tplan.u_w_b.numpy().view(np.int32),
                          np.asarray(jplan.u_w_b).view(np.int32))
    ulps = np.abs(tplan.xi_w_b.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jplan.xi_w_b).view(np.int32).astype(np.int64))
    assert ulps.max() <= prng.NORMAL_ULPS
    assert torch.equal(tplan.u_w_b[:, 0], tplan.u_w) and torch.equal(tplan.xi_w_b[:, 0],
                                                                     tplan.xi_w)
    assert not torch.equal(tplan.u_w_b[:, 1], tplan.u_w_b[:, 2])
    for name in ("m_hats_b", "y_props_b", "y_prev_b"):
        np.testing.assert_allclose(getattr(tplan, name).numpy(),
                                   np.asarray(getattr(jplan, name)), rtol=1e-5, atol=1e-5)


def test_branched_chains_need_keys():
    """A chain made from a generator and no key has zero stream keys, and
    every chain would draw the same branch noise: refused."""
    case = gmm_case()
    y0 = torch.zeros((SLOTS,) + case.event)
    with pytest.raises(ValueError, match="pass key"):
        t_asd.init_chain_state(case.ts, y0, THETA, generator=torch.Generator().manual_seed(0),
                               num_branches=2)
    with pytest.raises(ValueError, match="pass key"):
        t_asd.asd_sample_batched(case.t_fn, case.ts, y0, THETA, device="cpu",
                                 generator=torch.Generator().manual_seed(0), num_branches=2)
    st = t_asd.init_chain_state(case.ts, y0, THETA, generator=torch.Generator().manual_seed(0))
    assert st.b_live.tolist() == [1] * SLOTS and st.bctrl.shape == (SLOTS, 0)


# ---------------------------------------------------------------- selection


def test_argmax_takes_the_lowest_branch_on_ties():
    """Equal accepted prefixes go to the lowest branch index, as JAX's
    argmax; dead branches (>= b_r) never win; gain is over branch 0."""
    acc = torch.tensor([
        [[1, 1, 0, 0], [1, 1, 0, 1], [1, 1, 1, 0]],  # 2, 2, 3: branch 2
        [[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 0, 0]],  # 1, 2, 2: tie -> 1
        [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1]],  # all 4: branch 0
        [[0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]],  # b_r 1: branch 0 only
        [[1, 0, 0, 0], [1, 1, 1, 1], [1, 1, 1, 1]],  # n_valid 2: tie 1, 2 -> 1
    ], dtype=torch.bool)
    n_valid = torch.tensor([4, 4, 4, 4, 2])
    b_r = torch.tensor([3, 3, 3, 1, 3])
    best, acc_m, gain = t_asd.select_longest(acc, n_valid, b_r)
    assert best.tolist() == [2, 1, 0, 0, 1]
    assert gain.tolist() == [1, 1, 0, 0, 1]
    assert not acc_m[4, :, 2:].any()
    lead = jnp.asarray([[2, 2, 3], [1, 2, 2], [4, 4, 4], [0, -1, -1], [1, 2, 2]])
    assert np.asarray(jnp.argmax(lead, axis=1)).tolist() == best.tolist()


# ---------------------------------------------------------------- controllers


@pytest.mark.parametrize("name", ["static", "gain", "gain-tuned"])
def test_branch_controllers_match_jitted_jax(name):
    """500 rounds of random histories over 32 chains: branch counts equal
    and the float32 state equal to the bit to JAX's update under
    ``jax.jit`` (where XLA contracts the EWMA into an FMA)."""
    jc, tc = controllers(name)
    B, bmax = 32, 4
    rng = np.random.default_rng(len(name))
    jst, jb = jc.init(bmax)
    jst, jb = jnp.broadcast_to(jst, (B,) + jst.shape), jnp.broadcast_to(jb, (B,))
    tst, tb = tc.init(bmax, B, "cpu")
    assert tb.tolist() == np.asarray(jb).tolist()
    update = jax.jit(jax.vmap(lambda s, b, g, l, r: jc.update(s, b, g, l, r, bmax)))
    seen = set()
    for _ in range(500):
        gain = rng.integers(0, 5, B) * (rng.random(B) < 0.3)
        lead = rng.integers(0, 8, B)
        rej = rng.random(B) < 0.5
        jst, jb = update(jst, jb, jnp.asarray(gain, jnp.int32), jnp.asarray(lead, jnp.int32),
                         jnp.asarray(rej))
        tst, tb = tc.update(tst, tb.to(torch.int64), torch.from_numpy(gain),
                            torch.from_numpy(lead), torch.from_numpy(rej), bmax)
        assert tb.tolist() == np.asarray(jb).tolist()
        assert np.array_equal(tst.numpy().view(np.int32), np.asarray(jst).view(np.int32))
        seen |= set(tb.tolist())
    if name != "static":
        assert seen == {1, 2, 3, 4}  # the counts moved over the whole range


def test_branch_controller_registry():
    assert sorted(t_ctl.BRANCH_CONTROLLERS) == sorted(j_ctl.BRANCH_CONTROLLERS)
    assert t_ctl.make_branch_controller("gain", grow=0.5).grow == 0.5
    with pytest.raises(ValueError, match="unknown branch controller"):
        t_ctl.make_branch_controller("nope")
    _, b = t_ctl.StaticBranches(value=7).init(4, 2, "cpu")
    assert b.tolist() == [4, 4]
    _, b = t_ctl.StaticBranches(value=0).init(4, 2, "cpu")
    assert b.tolist() == [1, 1]


# ---------------------------------------------------------------- rounds


ROUND_CASES = {
    "gmm-B2-static-buffer-eager": ("gmm", 2, "static", "buffer", True),
    "gmm-B3-gain-counter-eager": ("gmm", 3, "gain", "counter", True),
    "smoke-B2-gain-buffer-no-eager": ("smoke", 2, "gain", "buffer", False),
    "smoke-B3-static-counter-eager": ("smoke", 3, "static", "counter", True),
    "smoke-B3-gain-tuned-buffer-eager": ("smoke", 3, "gain-tuned", "buffer", True),
}


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_branched_rounds_match_jax(name):
    """R unpacked rounds (``asd_superstep``) from the same slot states."""
    model_name, nb, ctl, noise_mode, eager = ROUND_CASES[name]
    case = CASES[model_name]()
    jst, tst = slot_states(case, nb, ctl, noise_mode, seed=3)
    jc, tc = controllers(ctl)
    model = case.j_make(None, None)
    R = 3
    jout = jax.jit(jax.vmap(lambda st: j_asd.asd_superstep(
        model, case.js, st, THETA, R, eager, noise_mode, False, num_branches=nb,
        branch_controller=jc)))(jst)
    tout = t_asd.asd_superstep(case.t_fn, case.ts, tst, THETA, R, eager_head=eager,
                               keep_trajectory=False, noise_mode=noise_mode,
                               num_branches=nb, branch_controller=tc)
    assert_states_close(jout, tout, case.tol, name)
    live = tst.a < K
    # the branches drafted more points than they verified a branch
    assert bool((tout.draft_points[live] > tout.proposals[live]).all())


def test_branched_round_keep_trajectory_matches_jax():
    case, nb = gmm_case(), 2
    jst, tst = slot_states(case, nb, keep=True, seed=4)
    model = case.j_make(None, None)
    jout = jax.jit(jax.vmap(lambda st: j_asd.asd_superstep(
        model, case.js, st, THETA, 4, True, "buffer", True, num_branches=nb)))(jst)
    tout = t_asd.asd_superstep(case.t_fn, case.ts, tst, THETA, 4, eager_head=True,
                               keep_trajectory=True, num_branches=nb)
    assert_states_close(jout, tout, case.tol, "keep_trajectory")


SAMPLE_CASES = {
    "B2-static-counter": (2, "static", "counter"),
    "B3-gain-buffer": (3, "gain", "buffer"),
    "B2-gain-buffer": (2, "gain", "buffer"),
    "B3-static-counter": (3, "static", "counter"),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_CASES))
def test_asd_sample_batched_matches_jax(name):
    """Whole samples of the smoke denoiser (K 24, theta 5, 4 chains) from
    one key: counters equal, samples within 1e-4; never shallower than one
    branch on the same keys."""
    nb, ctl, noise_mode = SAMPLE_CASES[name]
    case = smoke_case()
    from repro.core import schedules as j_sch
    from repro_torch.core import schedules as t_sch

    js, ts = j_sch.sl_geometric(24, 0.05, 10.0), t_sch.sl_geometric(24, 0.05, 10.0)
    jc, tc = controllers(ctl)
    key = jax.random.PRNGKey(11)
    y0 = np.zeros((4,) + case.event, np.float32)
    model = case.j_make(None, None)
    jres = jax.jit(lambda y: j_asd.asd_sample_batched(
        model, js, y, key, 5, eager_head=True, noise_mode=noise_mode,
        keep_trajectory=False, num_branches=nb, branch_controller=jc))(jnp.asarray(y0))
    with torch.no_grad():
        tres = t_asd.asd_sample_batched(case.t_fn, ts, torch.from_numpy(y0), 5,
                                        eager_head=True, keep_trajectory=False, device="cpu",
                                        key=np.asarray(key), noise_mode=noise_mode,
                                        num_branches=nb, branch_controller=tc)
        single = t_asd.asd_sample_batched(case.t_fn, ts, torch.from_numpy(y0), 5,
                                          eager_head=True, keep_trajectory=False,
                                          device="cpu", key=np.asarray(key),
                                          noise_mode=noise_mode)
    for f in ("rounds", "head_calls", "model_evals", "accepts", "proposals", "draft_points"):
        assert getattr(tres, f).tolist() == np.asarray(getattr(jres, f)).tolist(), f
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample), rtol=1e-4,
                               atol=1e-4)
    assert bool((tres.accepts < tres.proposals).any())  # rejections happened
    depth, depth1 = tres.rounds + tres.head_calls, single.rounds + single.head_calls
    assert int(depth.sum()) <= int(depth1.sum())


# ---------------------------------------------------------------- state


@pytest.mark.parametrize("noise_mode", ["buffer", "counter"])
def test_from_jax_chain_state_carries_the_branch_fields(noise_mode):
    """A branched JAX slot state after a round, as the port's: b_live, bctrl
    and draft_points carried, and back to numpy equal to the JAX leaves."""
    case, nb = gmm_case(), 3
    jst, _ = slot_states(case, nb, "gain", noise_mode, seed=5)
    model = case.j_make(None, None)
    jst = jax.jit(jax.vmap(lambda st: j_asd.asd_round(
        model, case.js, st, THETA, True, noise_mode, False, num_branches=nb,
        branch_controller=j_ctl.GainBranches())))(jst)
    tree = jax.tree_util.tree_map(np.asarray, jst)
    tst = from_jax_chain_state(tree, K, THETA, device="cpu")
    for f in dataclasses.fields(t_asd.ASDChainState):
        j, t = getattr(tree, f.name), getattr(tst, f.name)
        if j is None:
            assert t is None and noise_mode == "counter", f.name
            continue
        assert np.array_equal(t.numpy(), j.astype(t.numpy().dtype)), f.name
    assert tst.bctrl.shape == (SLOTS, 1) and int(tst.draft_points.sum()) > 0
    with pytest.raises(ValueError, match="bctrl"):
        from_jax_chain_state(dataclasses.replace(tree, bctrl=tree.bctrl[:, 0]), K, THETA,
                             device="cpu")
