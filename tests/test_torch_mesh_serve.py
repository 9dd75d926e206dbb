"""The serve CLI's ``--mesh`` over the batch axes on the CPU: the continuous
engine's ``state_sharding`` (data-parallel slots) and the fused sampler's
data-parallel chains, against the port's own 1 x 1 runs and the JAX
package's engine and sampler on the same mesh.

One two-rank gloo group (meshes ``2x1`` and ``2x1x1``) and one four-rank
group (``2x2x1``) run the ranks' side, ``tests/torch_mesh_serve_ranks.py``;
beside them one JAX subprocess with two forced host devices runs the JAX
package's ``ContinuousASDEngine(state_sharding=chain_state_shardings(mesh))``
and its ``asd_sample_batched`` over a ``2x1`` mesh.  The two-rank group
ends with the serve CLI at ``--mesh 2x1``, both engines: the rank function
``serve_rank`` that ``python -m repro_torch.launch.serve`` starts on each
rank (``main``'s hand-off to it is checked apart).  The test process and
the ranks run one torch thread.

  * on every mesh, under ``rounds_per_sync`` 1 and "auto" and the deadline
    policy, each rank's block of every ``ASDChainState`` field equals the
    1 x 1 engine's rows at every boundary, each request gets the 1 x 1
    bits (on rank 0) and counters (on every rank), and a rank holds
    1 / (pod * data) of the slot-state bytes; the blocks go pod-major;
  * the smoke denoiser's engine on ``2x1`` is within 1e-5 of JAX's sharded
    engine with equal counters, and the fused sampler per chain equals the
    1 x 1 call in bits and is within 1e-5 of JAX's; a rank that draws its
    chains from ``split(key, n_local)`` fails that check;
  * the CLI prints the JAX CLI's lines with 1 x 1's counters, gives the
    JAX message for ``--slots`` that do not split, and refuses packed
    rounds over batch ranks (beside a model axis too) and a mesh beside
    the model flags (a ``1xM`` mesh too) with exit 2, naming their
    ROADMAP.md items; the mesh's model axis itself serves
    (``tests/test_torch_mesh_serve_model.py``)."""

import contextlib
import io
import os
import re
import subprocess
import sys
import tempfile
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_serve_ranks as ranks
import torch_mp_ranks as mp
from repro_torch import pytree
from repro_torch.core import schedules as t_sch
from repro_torch.distributed import group as t_group
from repro_torch.distributed.group import MeshGroups
from repro_torch.distributed.sharding import chain_state_shardings
from repro_torch.launch import serve
from repro_torch.models.diffusion import make_ddpm_model_fn
from repro_torch.serving.engine import ContinuousASDEngine
from repro_torch.weights import init_denoiser_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TWO, FOUR = ("2x1", "2x1x1"), ("2x2x1",)
BASE = ["--device", "cpu", "--model", "paper-diffusion-policy-smoke", "--K", "20"]
CLI_RUNS = {"continuous": [], "fused": ["--engine", "fused"]}
CLI_MESH = ["--mesh", "2x1"]

# the JAX side: the smoke denoiser's engine with chain_state_shardings and
# the fused sampler with its y0 sharded, both over a 2x1 mesh
_JAX_SCRIPT = r"""
import sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.configs.registry import get_denoiser_config
from repro.core.asd import asd_sample_batched
from repro.core.schedules import ddpm
from repro.distributed.sharding import batch_pspec, chain_state_shardings
from repro.models.diffusion import denoiser_init, make_ddpm_model_fn
from repro.serving.engine import ContinuousASDEngine, Request

cfg, (K, theta, slots, n_req, counters) = sys.argv[3], eval(sys.argv[4])
data = dict(np.load(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
dc = get_denoiser_config(cfg)
boxed = jax.eval_shape(lambda k: denoiser_init(k, dc), jax.random.PRNGKey(0))
params = jax.tree_util.tree_map_with_path(
    lambda path, _: data[cfg + "/" + "/".join(p.key for p in path)],
    jax.tree_util.tree_map(lambda b: b.value, boxed,
                           is_leaf=lambda b: hasattr(b, "logical_axes")))
eng = ContinuousASDEngine(lambda p, cond: make_ddpm_model_fn(p, dc), params=params,
                          schedule=ddpm(K), event_shape=(dc.seq_len, dc.d_data),
                          num_slots=slots, theta=theta, eager_head=True,
                          noise_mode="counter", keep_trajectory=False,
                          state_sharding=chain_state_shardings(mesh))
y0 = data["engine/y0"]
res = eng.serve([Request(i, key=jax.random.PRNGKey(100 + i), y0=y) for i, y in enumerate(y0)])
out = {"engine/samples": np.stack([np.asarray(res[i]) for i in range(len(y0))])}
by_rid = {m.rid: [getattr(m, c) for c in counters] for m in eng.stats.per_request}
out["engine/counters"] = np.asarray([by_rid[i] for i in range(len(y0))])
fused = jax.jit(lambda p, y, k: asd_sample_batched(
    make_ddpm_model_fn(p, dc), ddpm(K), y, k, theta, eager_head=True,
    noise_mode="counter", keep_trajectory=False))
r = fused(params, jax.device_put(data["fused/y0"], NamedSharding(mesh, batch_pspec(mesh))),
          jax.random.PRNGKey(1))
out.update({"fused/sample": np.asarray(r.sample), "fused/rounds": np.asarray(r.rounds),
            "fused/head_calls": np.asarray(r.head_calls)})
np.savez(sys.argv[2], **out)
"""


def _inputs(path):
    """The smoke denoiser's numpy params (nonzero out_proj and norm scales),
    the engine's request y0 and the fused sampler's y0, written to
    ``path``."""
    dc = mp.config(mp.POLICY)
    tree = init_denoiser_params(dc, seed=3, out_scale=1.0, device="cpu")
    flat = {f"{mp.POLICY}/{'/'.join(p)}": leaf.numpy() for p, leaf in pytree.paths(tree)}
    flat["engine/y0"] = np.stack([r.y0 for r in ranks.policy_requests(dc)])
    flat["fused/y0"] = ranks.fused_y0(dc)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def _one_thread():
    """One intra-op thread in this process, as in the ranks: the module's
    tensors are small, and on a busy CPU idle threads only slow it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(argv):
    """``serve.main(argv)``'s summary and printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = serve.main(argv)
    return summary, out.getvalue()


@pytest.fixture(scope="module")
def runs(_one_thread):
    """The JAX subprocess, the two- and four-rank groups and the CLI's
    1 x 1 runs in this process, side by side."""
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        inputs = os.path.join(tmp, "inputs.npz")
        _inputs(inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=2")
        statics = repr((ranks.POLICY_K, ranks.POLICY_THETA, ranks.SLOTS, ranks.POLICY_REQ,
                        ranks.COUNTERS[:5]))
        jax_out = os.path.join(tmp, "jax.npz")
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, inputs, jax_out, mp.POLICY, statics],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        four = pool.submit(t_group.run_group, ranks.rank_cases, 4, "cpu", (FOUR,))
        try:
            one = {name: _printed(BASE + args) for name, args in CLI_RUNS.items()}
            two = t_group.run_group(ranks.rank_cases, 2, "cpu", (
                TWO, inputs, [BASE + CLI_MESH + args for args in CLI_RUNS.values()]))
            four = four.result()
        finally:
            jax_err = jax_proc.communicate(timeout=300)[1]
        assert jax_proc.returncode == 0, jax_err[-3000:]
        jax = dict(np.load(jax_out))
    return dict(ranks={spec: two for spec in TWO} | {spec: four for spec in FOUR},
                jax=jax, one=one, cli=dict(zip(CLI_RUNS, two[0]["cli"])),
                quiet=two[1]["cli"])


def _bits(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r]) for r in a)


@pytest.mark.parametrize("case", sorted(ranks.GMM_CASES))
@pytest.mark.parametrize("spec", TWO + FOUR)
def test_each_ranks_block_equals_the_1x1_rows_at_every_boundary(runs, spec, case):
    group = runs["ranks"][spec]
    n = len(group)
    for r in group:
        got = r["gmm"][spec, case]
        assert got["boundaries"] > 2 and got["bad"] == [], got["bad"][:10]
        per = ranks.SLOTS // n
        assert got["rows"] == (r["index"][spec][0] * per, (r["index"][spec][0] + 1) * per)
        assert got["bytes"] * n == got["ref_bytes"]
        assert not got["eager"]  # no collective in a superstep: programs stay graphs


@pytest.mark.parametrize("case", sorted(ranks.GMM_CASES))
@pytest.mark.parametrize("spec", TWO + FOUR)
def test_a_request_gets_the_1x1_bits_and_counters(runs, spec, case):
    group = runs["ranks"][spec]
    lead = group[0]["gmm"][spec, case]
    assert _bits(lead["samples"], lead["ref_samples"])
    assert len(lead["samples"]) == (5 if case == "deadline" else ranks.N_REQ)
    for r in group:
        got = r["gmm"][spec, case]
        assert got["counters"] == lead["ref_counters"]
        assert got["dropped"] == lead["ref_dropped"] == ([4] if case == "deadline" else [])
        assert got["gather_s"] > 0
        # another rank holds the samples of its own block only
        assert all(np.array_equal(v, lead["ref_samples"][rid])
                   for rid, v in got["samples"].items())
        if "served" in got:
            assert got["served"][1] == lead["ref_served"][1]
    if "served" in lead:
        assert _bits(lead["served"][0], lead["ref_served"][0])


def test_the_blocks_go_pod_major(runs):
    for r in runs["ranks"]["2x2x1"]:
        index, coords = r["index"]["2x2x1"]
        assert index == coords["pod"] * 2 + coords["data"] == r["rank"]
    assert [r["index"]["2x1x1"][1]["pod"] for r in runs["ranks"]["2x1x1"]] == [0, 1]


def test_the_smoke_engine_on_2x1_matches_jax_and_the_1x1_bits(runs):
    two = runs["ranks"]["2x1"]
    lead = two[0]["policy"]
    samples, counts = lead["engine"]
    ref_samples, ref_counts = lead["ref_engine"]
    assert _bits(samples, ref_samples) and len(samples) == ranks.POLICY_REQ
    jax = runs["jax"]
    for rid in range(ranks.POLICY_REQ):
        np.testing.assert_allclose(samples[rid], jax["engine/samples"][rid], rtol=TOL, atol=TOL)
        assert list(ref_counts[rid][:5]) == jax["engine/counters"][rid].tolist()
    for r in two:
        assert r["policy"]["engine"][1] == ref_counts
    accepts, proposals = (sum(c[i] for c in ref_counts.values()) for i in (3, 4))
    assert accepts < proposals  # rejections: the accept test says something


def _fused_problems(blocks, ref) -> list:
    """Chains whose sample bits, rounds or head calls differ from the 1 x 1
    call's."""
    got = {k: np.concatenate([b[k] for b in blocks]) for k in ("sample", "rounds", "head_calls")}
    return [i for i in range(ranks.CHAINS)
            if not (np.array_equal(got["sample"][i], ref["sample"][i])
                    and got["rounds"][i] == ref["rounds"][i]
                    and got["head_calls"][i] == ref["head_calls"][i])]


def test_the_fused_sampler_on_2x1_gives_the_1x1_bits_per_chain_and_matches_jax(runs):
    two = runs["ranks"]["2x1"]
    ref = two[0]["policy"]["ref_fused"]
    assert _fused_problems([r["policy"]["fused"] for r in two], ref) == []
    jax = runs["jax"]
    np.testing.assert_allclose(ref["sample"], jax["fused/sample"], rtol=TOL, atol=TOL)
    assert ref["rounds"].tolist() == jax["fused/rounds"].tolist()
    assert ref["head_calls"].tolist() == jax["fused/head_calls"].tolist()


def test_a_rank_that_splits_the_key_over_its_own_chains_fails_the_fused_check(runs):
    two = runs["ranks"]["2x1"]
    problems = _fused_problems([r["policy"]["fused_fault"] for r in two],
                               two[0]["policy"]["ref_fused"])
    # split(key, n)[i] does not depend on n: rank 0's block is right, rank 1's not
    assert problems == [2, 3]


_LINE = re.compile(r"(\d+) fused rounds in (\d+) supersteps, accept rate ([\d.]+), "
                   r"mean live window ([\d.]+/\d+)")


@pytest.mark.parametrize("engine", sorted(CLI_RUNS))
def test_the_cli_serves_on_2x1_with_the_1x1_counters(runs, engine):
    out = runs["cli"][engine]
    assert "finite=True" in out and "finite=False" not in out
    ref, ref_out = runs["one"][engine]
    assert runs["quiet"] == ["", ""]  # rank 1 prints nothing
    if engine == "fused":
        assert out.startswith("[fused] sampled 8 chains (K=20)")
        assert "output (8, 8, 4), finite=True" in out
        depth = re.compile(r"sequential depth (\d+) => ([\d.]+)x")
        assert depth.search(out).groups() == depth.search(ref_out).groups()
        return
    line = next(ln for ln in out.splitlines() if ln.startswith("[continuous]"))
    assert "served 8 requests on 4 slots (unpacked, K=20" in line and "samples/s" in line
    assert "output (8, 4) per request, finite=True" in out
    assert _LINE.search(line).groups() == (
        str(ref["rounds_total"]), str(ref["supersteps"]), f"{ref['accept_rate']:.2f}",
        f"{ref['mean_window']:.1f}/8")
    assert out.count("[continuous]") == 1  # rank 1 prints nothing


@pytest.mark.parametrize("engine", sorted(CLI_RUNS))
def test_main_starts_a_rank_a_mesh_rank(engine, monkeypatch):
    """``main`` hands a mesh of two ranks to ``run_group(serve_rank, 2,
    --device, (argv,))`` and returns rank 0's result."""
    started = []
    monkeypatch.setattr(serve, "run_group",
                        lambda *a: started.append(a) or ["rank 0", None])
    argv = BASE + CLI_MESH + CLI_RUNS[engine]
    assert serve.main(argv) == "rank 0"
    assert started == [(serve.serve_rank, 2, "cpu", (argv,))]


def test_slots_that_do_not_split_give_the_jax_message():
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + ["--mesh", "2x1", "--slots", "3"])
    assert exc.value.code == ("--slots 3 must be a multiple of the mesh batch axes "
                              "(pod*data = 2) so the slot batch shards evenly")


MESH_REFUSED = {
    "packed over batch ranks beside a model axis": ("A13 item 11",
                                                    ["--mesh", "2x2", "--execution", "packed"]),
    "model-shards beside a model axis": ("A13 item 12", ["--mesh", "1x2", "--model-shards", "2"]),
    "packed over batch ranks": ("A13 item 11", ["--mesh", "2x1", "--execution", "packed"]),
    "shards": ("A13 item 12", ["--mesh", "2x1", "--shards", "2"]),
    "model-shards": ("A13 item 12", ["--mesh", "2x1", "--model-shards", "2"]),
    "seq-shards": ("A13 item 12", ["--mesh", "1x2x1", "--seq-shards", "2"]),
    "expert-parallel": ("A13 item 12", ["--mesh", "2x1", "--expert-parallel"]),
    "malformed": ("PODxDATAxMODEL", ["--mesh", "2x"]),
}


@pytest.mark.parametrize("what", sorted(MESH_REFUSED))
def test_a_mesh_the_port_cannot_serve_exits_2_naming_its_item(what, capsys):
    item, args = MESH_REFUSED[what]
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + args)
    assert exc.value.code == 2 and item in capsys.readouterr().err


def _layout(shape, names, world):
    """A ``ChainStateSharding`` of rank 0 whose batch group is a stand-in
    (no process group: the worker refuses before any collective)."""
    axes = tuple(a for a in ("pod", "data") if a in names)
    stand_in = types.SimpleNamespace(rank=0, world=world)
    return chain_state_shardings(MeshGroups(shape, names, 0, "cpu", {axes: stand_in}))


def test_the_worker_refuses_packed_rounds_over_batch_ranks_and_a_model_axis():
    dc = mp.config(mp.POLICY)
    fn = make_ddpm_model_fn(init_denoiser_params(dc, 0, device="cpu"), dc)
    kw = dict(device="cpu", theta=4)
    with pytest.raises(ValueError, match="A13 item 11"):
        ContinuousASDEngine(fn, t_sch.ddpm(10), (dc.seq_len, dc.d_data), num_slots=4,
                            execution="packed", state_sharding=_layout((2, 1), ("data", "model"),
                                                                       2), **kw)
    # a model group of its own beside the mesh's slot blocks (the sharded
    # front end or the model flags beside a mesh)
    other = types.SimpleNamespace(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="A13 item 12"):
        ContinuousASDEngine(fn, t_sch.ddpm(10), (dc.seq_len, dc.d_data), num_slots=4,
                            state_sharding=_layout((2, 1), ("data", "model"), 2),
                            model_group=other, **kw)
    with pytest.raises(ValueError, match="divisible by 2"):
        _layout((1, 2, 1), ("pod", "data", "model"), 2).rows(3)
    # one batch rank: packed execution is the one-rank worker's
    one = chain_state_shardings(MeshGroups((1, 1), ("data", "model"), 0, "cpu"))
    eng = ContinuousASDEngine(fn, t_sch.ddpm(10), (dc.seq_len, dc.d_data), num_slots=4,
                              execution="packed", state_sharding=one, **kw)
    assert eng.slot_rows == slice(0, 4) and eng._batch_group is None
