"""The port's packed and fused round (``packed_round``, ``packed_superstep``)
and ``asd_superstep`` against the JAX package's, on the CPU, from the same
slot states (``from_jax_chain_state``) with the same weights.

Integer state (positions, counters, windows, flags) must be equal; float
state within the stated tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import analytic as j_an
from repro.core import asd as j_asd
from repro.core import schedules as j_sch
from repro.models.diffusion import denoiser_init, make_sl_model_fn as j_make_sl
from repro.nn.param import unbox
from repro.serving import packing as j_pack
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import analytic as t_an
from repro_torch.core import asd as t_asd
from repro_torch.core import schedules as t_sch
from repro_torch.models.diffusion import make_sl_model_fn as t_make_sl
from repro_torch.serving import packing as t_pack
from repro_torch.weights import from_jax_chain_state, from_jax_params

K, THETA, SLOTS = 12, 4, 4
EXACT = ("a", "v_valid", "rounds", "head_calls", "model_evals", "accepts",
         "proposals", "theta_live")


def smoke_tree(dc, seed=0):
    """JAX init with out_proj and the norm scales made nonzero (the init's
    zero out_proj would accept every speculation)."""
    tree = jax.tree_util.tree_map(np.array, unbox(denoiser_init(jax.random.PRNGKey(seed), dc)))
    rng = np.random.default_rng(seed)
    tree["out_proj"] = (0.2 * rng.standard_normal(tree["out_proj"].shape)).astype(np.float32)
    tree["final_norm"]["scale"] = (0.3 * rng.standard_normal(64)).astype(np.float32)
    for name in ("attn_norm", "ffn_norm"):
        leaf = tree["decoder"]["g0"][name]
        leaf["scale"] = (0.3 * rng.standard_normal(leaf["scale"].shape)).astype(np.float32)
    if "cond_proj" in tree:
        tree["cond_proj"] = rng.standard_normal(tree["cond_proj"].shape).astype(np.float32)
    return tree


@dataclasses.dataclass
class Case:
    """One model in both packages: the JAX ``make_fn(params, cond)``, the
    port's ``model_fn``, schedules, event shape, conds and tolerance."""
    j_make: object
    t_fn: object
    js: object
    ts: object
    event: tuple
    conds: np.ndarray = None
    tol: float = 1e-5


def gmm_case():
    d = 3
    model = j_an.sl_mean_fn(j_an.default_gmm(d))
    return Case(lambda p, c: model, t_an.sl_mean_fn(t_an.default_gmm(d)),
                j_sch.sl_uniform(K, t_max=8.0), t_sch.sl_uniform(K, t_max=8.0), (d,))


def smoke_case(d_cond=0):
    jdc = dataclasses.replace(j_smoke(), d_cond=d_cond)
    tdc = dataclasses.replace(t_smoke(), d_cond=d_cond)
    tree = smoke_tree(jdc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    conds = (np.random.default_rng(3).standard_normal((SLOTS, d_cond)).astype(np.float32)
             if d_cond else None)
    # t_max 10 keeps SL states below ~50; the chained float32 differences
    # then stay within 1e-4 (as in tests/test_torch_slice.py)
    return Case(lambda p, c: j_make_sl(jparams, jdc, c),
                t_make_sl(from_jax_params(tree, tdc, device="cpu"), tdc),
                j_sch.sl_geometric(K, 0.05, 10.0), t_sch.sl_geometric(K, 0.05, 10.0),
                (jdc.seq_len, jdc.d_data), conds, tol=1e-4)


CASES = {"gmm": gmm_case, "smoke": smoke_case}


def slot_states(case, keep=False, seed=0):
    """A JAX slot batch with ragged windows and positions (one slot already
    finished), and the same batch in the port."""
    keys = jax.random.split(jax.random.PRNGKey(seed), SLOTS)
    y0 = np.random.default_rng(seed).standard_normal((SLOTS,) + case.event).astype(np.float32)
    states = jax.vmap(lambda y, k: j_asd.init_chain_state(
        case.js, y, k, THETA, "buffer", keep))(jnp.asarray(y0), keys)
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
    for name in ("y", "v_cache"):
        np.testing.assert_allclose(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                                   rtol=tol, atol=tol, err_msg=f"{what}: {name}")


def run_both(case, jst, tst, *, rounds, budget, allocator="waterfill", round_impl="packed",
             eager=True, keep=False, budget_data=None):
    jalloc = {"waterfill": j_pack.WaterfillingAllocator(theta_max=THETA)}.get(allocator, allocator)
    talloc = {"waterfill": t_pack.WaterfillingAllocator(theta_max=THETA)}.get(allocator, allocator)
    if isinstance(allocator, tuple):
        jalloc, talloc = allocator
    weights = np.array([1.0, 2.0, 1.0, 1.5], np.float32)
    jconds = None if case.conds is None else jnp.asarray(case.conds)
    tconds = None if case.conds is None else torch.from_numpy(case.conds)
    jout = j_pack.packed_superstep(
        case.j_make, None, case.js, jst, jconds, jnp.asarray(weights), rounds=rounds,
        theta=THETA, budget=budget, allocator=jalloc, eager_head=eager,
        keep_trajectory=keep, round_impl=round_impl,
        budget_data=None if budget_data is None else jnp.int32(budget_data))
    tout = t_pack.packed_superstep(
        case.t_fn, case.ts, tst, tconds, torch.from_numpy(weights), rounds=rounds,
        theta=THETA, budget=budget, allocator=talloc, eager_head=eager,
        keep_trajectory=keep, round_impl=round_impl, budget_data=budget_data)
    return jout, tout


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "no-eager"])
@pytest.mark.parametrize("budget", [SLOTS * THETA, 5], ids=["covering", "binding"])
@pytest.mark.parametrize("round_impl", ["packed", "fused"])
@pytest.mark.parametrize("model", sorted(CASES))
def test_packed_superstep_matches_jax(model, round_impl, budget, eager):
    case = CASES[model]()
    jst, tst = slot_states(case)
    jout, tout = run_both(case, jst, tst, rounds=3, budget=budget, round_impl=round_impl,
                          eager=eager)
    assert_states_close(jout, tout, case.tol, f"{model} {round_impl} B={budget}")
    assert int(tout.rounds.sum()) > 0


def test_packed_round_keep_trajectory_matches_jax():
    case = gmm_case()
    jst, tst = slot_states(case, keep=True)
    jout, tout = run_both(case, jst, tst, rounds=4, budget=7, keep=True)
    assert_states_close(jout, tout, case.tol, "keep_trajectory")


@pytest.mark.parametrize("model", sorted(CASES))
def test_fused_budget_data_below_the_cap_matches_jax(model):
    """budget-as-data: the maps keep the cap's width, the allocator splits
    the smaller tier, the lanes past it drop."""
    case = CASES[model]()
    jst, tst = slot_states(case, seed=1)
    jout, tout = run_both(case, jst, tst, rounds=3, budget=SLOTS * THETA, budget_data=5,
                          round_impl="fused")
    assert_states_close(jout, tout, case.tol, f"{model} budget_data")
    # the tier bound the round: at most 5 points verified a round
    spent = tout.proposals - tst.proposals
    assert int(spent.sum()) <= 3 * 5


class _JStarve(j_pack.BudgetAllocator):
    """Grants every slot its demand except slot 1, which gets none."""
    name = "starve"

    def allocate(self, demand, budget, weights):
        return jnp.where(jnp.arange(demand.shape[0]) == 1, 0, demand)


class _TStarve(t_pack.BudgetAllocator):
    name = "starve"

    def allocate(self, demand, budget, weights):
        return torch.where(torch.arange(demand.shape[0]) == 1, 0, demand)


@pytest.mark.parametrize("round_impl", ["packed", "fused"])
def test_zero_grant_stalls_the_slot_as_jax_does(round_impl):
    """A zero grant verifies nothing and advances nowhere.  Its eager head
    index theta_r - 1 is -1, which the JAX package's dynamic_index_in_dim
    wraps to the last row (it normalises negative indices before clamping):
    the port must wrap it too, or v_cache differs."""
    case = gmm_case()
    jst, tst = slot_states(case, seed=2)
    jout, tout = run_both(case, jst, tst, rounds=2, budget=SLOTS * THETA,
                          allocator=(_JStarve(), _TStarve()), round_impl=round_impl)
    assert_states_close(jout, tout, case.tol, "zero grant")
    assert tout.a[1] == tst.a[1] and tout.proposals[1] == tst.proposals[1]
    assert tout.rounds[1] == tst.rounds[1] + 2


@pytest.mark.parametrize("round_impl", ["packed", "fused"])
def test_conditioned_smoke_denoiser_matches_jax(round_impl):
    """d_cond > 0: the JAX package vmaps one model call per point; the
    port makes one batched call with one condition row per point."""
    case = smoke_case(d_cond=6)
    jst, tst = slot_states(case, seed=3)
    calls = []
    fn = case.t_fn
    case.t_fn = lambda t, y, c=None: calls.append((tuple(y.shape), c is not None)) or fn(t, y, c)
    jout, tout = run_both(case, jst, tst, rounds=2, budget=6, round_impl=round_impl)
    assert_states_close(jout, tout, case.tol, "conditioned")
    # per round: the proposal call (4 slots) and ONE verification call of
    # budget + head lanes, both conditioned
    assert calls == [((SLOTS,) + case.event, True), ((6 + SLOTS,) + case.event, True)] * 2


@pytest.mark.parametrize("eager", [True, False], ids=["eager", "no-eager"])
def test_asd_superstep_is_r_rounds_and_matches_jax(eager):
    case = gmm_case()
    jst, tst = slot_states(case, keep=True, seed=4)
    R = 3
    tout = t_asd.asd_superstep(case.t_fn, case.ts, tst, THETA, R, eager_head=eager,
                               keep_trajectory=True)
    seq = tst
    for _ in range(R):
        seq = t_asd.asd_round(case.t_fn, case.ts, seq, THETA, eager_head=eager,
                              keep_trajectory=True)
    for f in dataclasses.fields(t_asd.ASDChainState):
        assert torch.equal(getattr(tout, f.name), getattr(seq, f.name)), f.name
    model = case.j_make(None, None)
    jout = jax.vmap(lambda st: j_asd.asd_superstep(
        model, case.js, st, THETA, R, eager_head=eager, keep_trajectory=True))(jst)
    assert_states_close(jout, tout, case.tol, "asd_superstep")


def test_asd_superstep_with_conds_matches_per_chain_calls():
    """Conditioned unpacked rounds: the port's one batched call with
    repeated condition rows equals calling each chain alone with its
    condition."""
    case = smoke_case(d_cond=6)
    _, tst = slot_states(case, keep=True, seed=5)
    conds = torch.from_numpy(case.conds)
    out = t_asd.asd_superstep(case.t_fn, case.ts, tst, THETA, 2, eager_head=True,
                              keep_trajectory=True, conds=conds)
    for s in range(SLOTS):
        one = t_asd.ASDChainState(**{f.name: getattr(tst, f.name)[s:s + 1]
                                     for f in dataclasses.fields(t_asd.ASDChainState)})
        one = t_asd.asd_superstep(lambda t, y, c=conds[s]: case.t_fn(t, y, c), case.ts, one,
                                  THETA, 2, eager_head=True, keep_trajectory=True)
        assert out.a[s] == one.a[0] and out.accepts[s] == one.accepts[0]
        torch.testing.assert_close(out.y[s], one.y[0], rtol=1e-5, atol=1e-5)


def test_from_jax_chain_state_checks_shapes():
    case = gmm_case()
    jst, _ = slot_states(case)
    tree = jax.tree_util.tree_map(np.asarray, jst)
    with pytest.raises(ValueError, match="u_buf"):
        from_jax_chain_state(tree, K + 1, THETA, device="cpu")
    with pytest.raises(ValueError, match="y"):
        from_jax_chain_state(dataclasses.replace(tree, y=tree.y[:, :2]), K, THETA,
                             device="cpu")
    st = from_jax_chain_state(tree, K, THETA, device="cpu")
    assert st.a.dtype == torch.int64 and st.v_valid.dtype == torch.bool
    assert st.xi_buf.shape == (SLOTS, K + THETA + 1) + case.event
