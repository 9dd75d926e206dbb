"""Model parallelism in serving, the port against the JAX package, on the CPU:
one two-rank gloo model group for the whole module
(``repro_torch.distributed.group.run_group``; the ranks' side is
``tests/torch_mp_ranks.py``), and beside it one JAX subprocess with two
forced host devices that runs the JAX package's own ``denoiser_fwd`` inside
a ``jax.shard_map`` (written here, ``check_vma=False``) on the same inputs,
and the JAX package's replicated engine on the same requests.

  * TP2, SP2, EP2, EP2+SP2 and the exchange-free EP2 (L odd) forwards
    are within 1e-5 of JAX's sharded forwards, from the same
    ``from_jax_params`` weights; both ranks give the same bits, and so does
    a second call;
  * a rank keeps 1/mp of each sharded leaf, in a tensor of its own, and
    the replicated leaves as they are;
  * the engine at mp 2 (TP+EP, and EP+SP with fused dispatch over two
    shards) is within 1e-5 of the JAX package's replicated engine with
    equal counters, the same bits on both ranks (and in a second run), with
    its programs eager and the collective lanes filled (and kept by
    ``EngineStats.merged``);
  * under the deadline policy the ranks follow rank 0's admissions, even
    where their own deadlines would drop another request;
  * a group of one rank gives today's engine per leaf, with the lanes 0;
  * ranks on distinct cards are refused, and a rank's exception fails the
    group."""

import dataclasses
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mp_ranks as ranks
from repro_torch import pytree
from repro_torch.core import schedules as t_sch
from repro_torch.distributed import group as t_group
from repro_torch.distributed.group import MeshGroups
from repro_torch.distributed.sharding import chain_state_shardings
from repro_torch.models.diffusion import make_ddpm_model_fn
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving.engine import ContinuousASDEngine
from repro_torch.serving.sharded import ShardedASDEngine
from repro_torch.serving.worker import Request
from repro_torch.weights import from_jax_params, init_denoiser_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
B = 3  # points a forward

# the JAX side, in one process: every sharded forward of ranks.FORWARDS,
# then the replicated engine of each engine config on the requests' y0
_JAX_SCRIPT = r"""
import dataclasses, sys
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.registry import get_denoiser_config
from repro.core.schedules import ddpm
from repro.distributed.sharding import mp_param_pspecs
from repro.models.diffusion import denoiser_fwd, denoiser_init, make_ddpm_model_fn
from repro.serving.engine import Request
from repro.serving.router import make_router
from repro.serving.sharded import ShardedASDEngine

class FakeMesh:
    def __init__(self, model):
        self.shape, self.axis_names = {"model": model}, ("model",)

cases, engines, (K, theta, slots, counters) = (eval(a) for a in sys.argv[3:6])
data = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))

def config(cfg, L=None):
    dc = get_denoiser_config(cfg)
    return dc if L is None else dataclasses.replace(dc, seq_len=L)

def params_of(cfg, dc):
    boxed = jax.eval_shape(lambda k: denoiser_init(k, dc), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, _: data[cfg + "/" + "/".join(p.key for p in path)],
        jax.tree_util.tree_map(lambda b: b.value, boxed,
                               is_leaf=lambda b: hasattr(b, "logical_axes")))
    return boxed, params

out = {}
for name, (cfg, L, tensor, expert, sp) in cases.items():
    dc = config(cfg, L)
    boxed, params = params_of(cfg, dc)
    specs = mp_param_pspecs(boxed, FakeMesh(2), tensor=tensor, expert=expert)
    fwd = lambda p, t, y: denoiser_fwd(
        p, t, y, dc, tp_axis="model" if tensor and sp == 1 else None,
        sp_axis="model" if sp > 1 else None, sp_size=sp,
        ep_axis="model" if expert else None)
    f = jax.jit(jax.shard_map(fwd, mesh=mesh, in_specs=(specs, P(), P()),
                              out_specs=P(), check_vma=False))
    out[name] = np.asarray(f(params, data[name + "/t"], data[name + "/y"]))
for cfg in sorted({e[0] for e in engines.values()}):
    dc = config(cfg)
    eng = ShardedASDEngine(lambda p, cond: make_ddpm_model_fn(p, dc),
                           params=params_of(cfg, dc)[1], schedule=ddpm(K),
                           event_shape=(dc.seq_len, dc.d_data), num_slots=slots,
                           theta=theta, eager_head=True, noise_mode="counter",
                           keep_trajectory=False, router=make_router("round-robin"))
    y0 = data["engine/" + cfg + "/y0"]
    res = eng.serve([Request(i, key=jax.random.PRNGKey(100 + i), y0=y)
                     for i, y in enumerate(y0)])
    out["engine/" + cfg + "/samples"] = np.stack([np.asarray(res[i]) for i in range(len(y0))])
    by_rid = {m.rid: [getattr(m, c) for c in counters] for m in eng.stats.per_request}
    out["engine/" + cfg + "/counters"] = np.asarray([by_rid[i] for i in range(len(y0))])
np.savez(sys.argv[2], **out)
"""


def _inputs(path):
    """The numpy params of both configs (nonzero out_proj and norm scales)
    and each forward's (t, y), written to ``path``."""
    flat = {}
    for cfg in (ranks.POLICY, ranks.MOE):
        dc = ranks.config(cfg)
        tree = init_denoiser_params(dc, seed=3, out_scale=1.0, device="cpu")
        flat.update({f"{cfg}/{'/'.join(p)}": leaf.numpy()
                     for p, leaf in pytree.paths(tree)})
    rng = np.random.default_rng(7)
    for name, (cfg, L, *_) in ranks.FORWARDS.items():
        dc = ranks.config(cfg, L)
        flat[f"{name}/t"] = rng.uniform(1.0, ranks.K - 1, (B,)).astype(np.float32)
        flat[f"{name}/y"] = rng.standard_normal((B, dc.seq_len, dc.d_data)).astype(np.float32)
    for cfg in {e[0] for e in ranks.ENGINES.values()}:
        flat[f"engine/{cfg}/y0"] = np.stack([r.y0 for r in ranks.requests(ranks.config(cfg))])
    np.savez(path, **flat)
    return flat


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread in this process, as in the ranks: the module's
    tensors are small, and on a busy CPU idle threads only slow it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """The JAX subprocess and the two torch ranks, side by side, and beside
    them a second two-rank group whose rank 1 raises."""
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        failing = pool.submit(t_group.run_group, ranks.raise_on_rank_1, 2, "cpu",
                              timeout_s=60)
        inputs = os.path.join(tmp, "inputs.npz")
        flat = _inputs(inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        statics = repr((ranks.K, ranks.THETA, ranks.SLOTS, ranks.COUNTERS))
        # the forwards and the replicated engine in two JAX processes at once
        parts = [(os.path.join(tmp, "jax_forwards.npz"), ranks.FORWARDS, {}),
                 (os.path.join(tmp, "jax_engine.npz"), {}, ranks.ENGINES)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, inputs, out, repr(cases), repr(engines),
             statics], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for out, cases, engines in parts]
        try:
            torch_out = t_group.run_group(ranks.rank_cases, 2, "cpu", (inputs,))
        finally:
            errs = [proc.communicate(timeout=300)[1] for proc in procs]
        jax_out = {}
        for proc, err, (out, _, _) in zip(procs, errs, parts):
            assert proc.returncode == 0, err[-3000:]
            jax_out.update(np.load(out))
        failed = failing.exception()
    return dict(flat=flat, jax=jax_out, ranks=torch_out, failed=failed)


@pytest.mark.parametrize("case", sorted(ranks.FORWARDS))
def test_sharded_forward_matches_jax_and_is_the_same_bits_on_both_ranks(runs, case):
    r0, r1 = (r["forwards"][case] for r in runs["ranks"])
    np.testing.assert_allclose(r0[0], runs["jax"][case], rtol=TOL, atol=TOL)
    assert np.abs(runs["jax"][case]).max() > 1e-2  # a forward that says something
    for out in (r0[1], r1[0], r1[1]):
        assert np.array_equal(out, r0[0])


@pytest.mark.parametrize("case", sorted(ranks.FORWARDS))
def test_a_rank_holds_one_mp_th_of_each_sharded_leaf(runs, case):
    cfg, L, tensor, expert, sp = ranks.FORWARDS[case]
    sharded = 0
    for r in runs["ranks"]:
        for path, (local, full, same) in r["shards"][case].items():
            if local == full:
                assert same, path  # replicated: the caller's tensor, no copy
                continue
            sharded += 1
            assert not same and np.prod(local) * 2 == np.prod(full), path
    if tensor or expert:
        assert sharded  # TP shards wq / wo / the FFN, EP the expert stacks
    else:
        assert sharded == 0  # SP shards activations only


def _engine_cfg(name):
    return ranks.ENGINES[name][0]


@pytest.mark.parametrize("name", sorted(ranks.ENGINES))
def test_engine_at_mp2_matches_the_jax_replicated_engine(runs, name):
    cfg = _engine_cfg(name)
    j_samples, j_counters = (runs["jax"][f"engine/{cfg}/{k}"] for k in ("samples", "counters"))
    run = runs["ranks"][0]["engines"][name][0]
    assert sorted(run["samples"]) == list(range(ranks.N_REQ))
    for rid, s in run["samples"].items():
        assert run["counters"][rid] == tuple(j_counters[rid])
        np.testing.assert_allclose(s, j_samples[rid], rtol=TOL, atol=TOL)
    accepts, proposals = j_counters[:, 3].sum(), j_counters[:, 4].sum()
    assert 0 < accepts < proposals  # the verify rejected some drafts


@pytest.mark.parametrize("name", sorted(ranks.ENGINES))
def test_engine_gives_the_same_bits_on_both_ranks_and_twice(runs, name):
    first = runs["ranks"][0]["engines"][name][0]
    for r in runs["ranks"]:
        for run in r["engines"][name]:
            assert run["counters"] == first["counters"]
            assert all(run["eager"])  # host-staged collectives: no graphs
            for rid, s in first["samples"].items():
                assert np.array_equal(run["samples"][rid], s), rid


@pytest.mark.parametrize("name", sorted(ranks.ENGINES))
def test_collective_lanes_are_filled_and_merged(runs, name):
    _, tensor, expert, sp, _ = ranks.ENGINES[name]
    for r in runs["ranks"]:
        run = r["engines"][name][0]
        per = np.asarray(run["collective"])
        assert (per[:, 0] > 0).all()
        np.testing.assert_allclose(per[:, 0], per[:, 1] + per[:, 2], rtol=1e-12)
        np.testing.assert_allclose(run["merged"], per.sum(axis=0), rtol=1e-12)
        assert (per[:, 2] > 0).all() == (sp > 1 or expert)  # all_to_all lane
        tb = run["breakdown"]
        assert tb["collective_s"] == run["merged"][0] and tb["collective_frac"] > 0


def test_ranks_follow_rank_0s_admissions_under_the_deadline_policy(runs):
    """Each rank's own deadlines would drop a different request (see
    ``torch_mp_ranks.deadline_case``): both drop rank 0's choice, rid 4,
    and serve the others with the same bits."""
    d0, d1 = (r["deadline"] for r in runs["ranks"])
    assert d0["dropped"] == d1["dropped"] == [4]
    assert sorted(d0["samples"]) == sorted(d1["samples"]) == [0, 1, 2, 3, 5]
    assert d0["counters"] == d1["counters"]
    for rid, s in d0["samples"].items():
        assert np.array_equal(d1["samples"][rid], s), rid


def _replica(policy: str, flip: bool):
    """Three slots and six queued requests whose deadlines and priorities
    depend on ``flip``: two replicas of one queue that disagree on them."""
    sched = t_sched.SlotScheduler(3, policy=t_sched.make_policy(policy))
    for rid in range(6):
        late = (rid % 2 == 0) != flip
        sched.submit(Request(rid, deadline=0.0 if late else 1e9,
                             priority=float(rid if flip else -rid)), now=float(rid))
    return sched


def _rids(sched):
    return ([None if s is None else (s.request.rid, s.admit_round) for s in sched._slots],
            [e.request.rid for e in sched._queue], [e.request.rid for e in sched.dropped],
            sched.admitted)


@pytest.mark.parametrize("policy", sorted(t_sched.POLICIES))
def test_a_follower_scheduler_applies_the_admission_its_replica_decided(policy):
    """``SlotScheduler.follow`` on a replica whose own deadlines and
    priorities would decide otherwise ends where ``admit`` left the
    deciding one: the same slots, queue and drops, by rid."""
    ctx = t_sched.AdmissionContext(K=10, theta_max=4, seconds_per_round=0.1,
                                   round_budget=12, live_demand=4, theta_open=4)
    lead, follower = _replica(policy, False), _replica(policy, True)
    placed = lead.admit(5.0, 3, ctx)
    got = follower.follow(5.0, 3, [(slot, req.rid) for slot, req in placed],
                          [e.request.rid for e in lead.dropped])
    assert placed and [(slot, req.rid) for slot, req in got] == [
        (slot, req.rid) for slot, req in placed]
    assert _rids(follower) == _rids(lead)
    gone = placed[0][1].rid  # admitted: no longer queued on either replica
    with pytest.raises(ValueError, match=f"request {gone} is not queued here"):
        follower.follow(6.0, 4, [], [gone])


def test_the_collectives_are_the_tiled_jax_ones(runs):
    """psum adds in rank order (the same bits on both ranks), all_gather and
    all_to_all concatenate sender-major, as ``jax.lax``'s tiled forms."""
    xs = [r["collectives"]["x"] for r in runs["ranks"]]
    for r, out in enumerate(r["collectives"] for r in runs["ranks"]):
        assert out["index"] == r and out["floats"] == [0.5, -1.0]
        assert torch.equal(out["psum"], xs[0] + xs[1])
        assert torch.equal(out["pmean"], (xs[0] + xs[1]) / 2)
        assert out["psum_bf16"].dtype == torch.bfloat16
        assert torch.equal(out["psum_bf16"], xs[0].bfloat16() + xs[1].bfloat16())
        assert torch.equal(out["gather0"], torch.cat(xs, 0))
        assert torch.equal(out["gather2"], torch.cat(xs, 2))
        block = [x[..., 2 * r:2 * r + 2] for x in xs]
        assert torch.equal(out["a2a_2_0"], torch.cat(block, 0))
        assert torch.equal(out["a2a_ints"], torch.cat(block, 2).long())
        assert torch.equal(out["a2a_0_1"], torch.cat([x[r:r + 1] for x in xs], 1))


def _one_rank_group():
    return t_group.ModelGroup(0, 1, "cpu")


def test_a_group_of_one_rank_is_todays_engine_per_leaf(runs):
    dc = ranks.config(ranks.POLICY)
    params = from_jax_params(ranks.params_tree(runs["flat"], ranks.POLICY, dc), dc, "cpu")
    kw = dict(theta=ranks.THETA, eager_head=True, noise_mode="counter",
              keep_trajectory=False, device="cpu")
    ref = ContinuousASDEngine(make_ddpm_model_fn(params, dc), t_sch.ddpm(ranks.K),
                              (dc.seq_len, dc.d_data), num_slots=ranks.SLOTS, **kw)
    group = _one_rank_group()
    eng = ranks.engine(group, dc, params, True, False, 1)
    assert eng.model_shards == 1 and eng.workers[0]._eager
    for r in ranks.requests(dc):
        ref.submit(r)
        eng.submit(r)
    more = True
    while more:
        more, more_mp = ref.step(), eng.step()
        assert more == more_mp
        for f in dataclasses.fields(ref._states):
            a, b = getattr(ref._states, f.name), getattr(eng.workers[0]._states, f.name)
            assert (a is None and b is None) or torch.equal(a, b), f.name
    assert eng.stats.collective_s == eng.stats.collective_psum_s == 0.0
    assert eng.stats.timing_breakdown()["collective_frac"] == 0.0


def test_engines_of_one_group_size_adopt_each_other(runs):
    """Eager programs have no graph pool to share: an engine over a group
    adopts a warm one of the same model_shards as any other engine does,
    and serves."""
    dc = ranks.config(ranks.POLICY)
    params = from_jax_params(ranks.params_tree(runs["flat"], ranks.POLICY, dc), dc, "cpu")
    a, b = (ranks.engine(_one_rank_group(), dc, params, True, False, 1) for _ in range(2))
    assert b.adopt_programs(a) is b and b.workers[0]._graph_pool is None
    out = b.serve(ranks.requests(dc))
    assert sorted(out) == list(range(ranks.N_REQ))


def test_the_engine_validates_the_group(runs):
    dc = ranks.config(ranks.POLICY)
    params = from_jax_params(ranks.params_tree(runs["flat"], ranks.POLICY, dc), dc, "cpu")
    kw = dict(device="cpu", theta=ranks.THETA)
    model_fn = make_ddpm_model_fn(params, dc)
    with pytest.raises(ValueError, match="must equal the model group's world"):
        ShardedASDEngine(model_fn, t_sch.ddpm(ranks.K), (dc.seq_len, dc.d_data),
                         num_slots=4, model_shards=2, **kw)
    with pytest.raises(ValueError, match="needs explicit params AND param_specs"):
        ShardedASDEngine(model_fn, t_sch.ddpm(ranks.K), (dc.seq_len, dc.d_data),
                         num_slots=4, model_group=_one_rank_group(), params=params, **kw)
    with pytest.raises(ValueError, match="chain_state_shardings"):
        ContinuousASDEngine(model_fn, t_sch.ddpm(ranks.K), (dc.seq_len, dc.d_data),
                            num_slots=4, state_sharding="data", **kw)
    layout = chain_state_shardings(MeshGroups((1, 1), ("data", "model"), 0, "cpu"))
    with pytest.raises(ValueError, match="A13 item 12"):
        ContinuousASDEngine(lambda p: model_fn, t_sch.ddpm(ranks.K), (dc.seq_len, dc.d_data),
                            num_slots=4, model_group=_one_rank_group(), params=params,
                            param_specs=ranks.layout(dc, 1, True, False),
                            state_sharding=layout, **kw)


def test_ranks_on_distinct_cards_are_refused(monkeypatch):
    def gather(out, mine, group=None):  # rank 1 reports card 1
        out[0].copy_(torch.tensor([1, 0]))
        out[1].copy_(torch.tensor([1, 1]))

    monkeypatch.setattr(t_group.dist, "all_gather", gather)
    with pytest.raises(ValueError, match="ROADMAP.md A13"):
        t_group.ModelGroup(0, 2, "cpu")


def test_a_rank_that_raises_fails_the_group(runs):
    assert isinstance(runs["failed"], RuntimeError)
    assert "model group failed" in str(runs["failed"]) and "rank 1 fails" in str(runs["failed"])
