"""The serve mesh's ``model`` axis on the CPU: the continuous engine's slot
blocks beside the weights laid out by ``param_pspecs`` over the model ranks
(``ServeLayout``: tensor-parallel where ``tp_paths`` says so, every other
cut leaf gathered at use), and the fused sampler's rounds run eagerly over
them, against the port's own 1 x 1 runs and the JAX package's engine and
sampler on the same meshes.

One four-rank gloo group (meshes ``2x2`` and ``2x1x2``, then the serve CLI
at ``--mesh 2x2``, both engines) and one two-rank group (``1x2`` and
``1x1x2``, the fused sampler on ``1x2`` and a planted divergence) run the
ranks' side, ``tests/torch_mesh_serve_model_ranks.py``; beside them a
JAX subprocess a mesh, each with four forced host devices, builds the JAX
CLI's engine (``src/repro/launch/serve.py``: the params placed by
``param_pspecs(boxed, mesh)``, ``state_sharding=chain_state_shardings(
mesh)``) on its mesh, and the ``1x2`` one its ``run_fused`` body too, and
the test process runs the 1 x 1 engines, samplers and CLI.  The test process and
the ranks run one torch thread.

  * on ``1x2``, ``2x2`` and ``2x1x2``, for the policy smoke denoiser and a
    narrowed dense config whose ``wk`` / ``wv`` and time MLP are cut by
    ``param_pspecs``' fallback and gathered at use, every request's sample
    is within 1e-5 of the port's 1 x 1 run and of JAX's engine on the same
    mesh, with the same counters but where the accept-bit law lets one
    row's bit differ (the DDPM schedule's last step, whose sigma is 0: its
    test is the equality of two model calls' outputs, at the threshold by
    construction), as one row of the narrowed config's may against JAX;
  * ``DxM`` and ``PxDxM`` give the ``1xM`` run's bits and counters; the
    model ranks of a block hold the same bits of every slot-state field at
    every boundary, and their programs run eagerly;
  * a rank keeps exactly the layout's bytes of the weights, the narrowed
    config gathers its fallback-cut leaves at every model call, the policy
    smoke gathers nothing (every cut leaf is tensor-parallel);
  * the fused sampler on ``1x2`` is within 1e-5 of JAX's ``run_fused``
    body and of the port's 1 x 1 call, with the same rounds, both ranks in
    the same bits; the MoE denoiser on ``1x2`` within 1e-5 of 1 x 1;
  * a model rank whose model function diverges makes every rank of the
    group raise at the boundary;
  * the serve CLI at ``--mesh 2x2`` prints the JAX CLI's lines with the
    1 x 1 run's counters, both engines."""

import contextlib
import io
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_serve_model_ranks as ranks
from repro_torch import pytree
from repro_torch.core import prng
from repro_torch.core import schedules as t_sch
from repro_torch.core.asd import SamplerLoop, asd_sample_batched, init_chain_state
from repro_torch.distributed import group as t_group
from repro_torch.launch import serve
from repro_torch.models.diffusion import make_ddpm_model_fn
from repro_torch.weights import init_denoiser_params

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
TWO, FOUR = ("1x2", "1x1x2"), ("2x2", "2x1x2")
JAX_MESHES = ("1x2", "2x2", "2x1x2")
BASE = ["--device", "cpu", "--model", "paper-diffusion-policy-smoke", "--K", "20"]
CLI_RUNS = {"continuous": [], "fused": ["--engine", "fused"]}
CLI_MESH = ["--mesh", "2x2"]

# the JAX side: the JAX CLI's engine on each mesh (its params placed by
# param_pspecs, its slots by chain_state_shardings) and its run_fused body
# on one mesh, for each config
_JAX_SCRIPT = r"""
import dataclasses, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding
from repro.configs.registry import get_denoiser_config
from repro.core.asd import asd_sample_batched
from repro.core.schedules import ddpm
from repro.distributed.sharding import (batch_pspec, chain_state_shardings, param_pspecs,
                                        shardings_from_pspecs)
from repro.models.diffusion import denoiser_init, make_ddpm_model_fn
from repro.serving.engine import ContinuousASDEngine, Request

configs, meshes, fused_on, (K, theta, slots, counters) = (eval(a) for a in sys.argv[3:7])
data = dict(np.load(sys.argv[1]))
out = {}

def config(name):
    base, over = configs[name]
    dc = get_denoiser_config(base)
    return dc if not over else dataclasses.replace(
        dc, backbone=dataclasses.replace(dc.backbone, **over))

for spec, names in meshes:
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(dims))]).reshape(dims), axes)
    for name in names:
        dc = config(name)
        boxed = jax.eval_shape(lambda k: denoiser_init(k, dc), jax.random.PRNGKey(0))
        values = jax.tree_util.tree_map(lambda b: b.value, boxed,
                                        is_leaf=lambda b: hasattr(b, "logical_axes"))
        params = jax.tree_util.tree_map_with_path(
            lambda path, _: data[name + "/" + "/".join(p.key for p in path)], values)
        params = jax.device_put(params, shardings_from_pspecs(mesh, param_pspecs(boxed, mesh)))
        eng = ContinuousASDEngine(lambda p, cond: make_ddpm_model_fn(p, dc), params=params,
                                  schedule=ddpm(K), event_shape=(dc.seq_len, dc.d_data),
                                  num_slots=slots, theta=theta, eager_head=True,
                                  noise_mode="counter", keep_trajectory=False,
                                  state_sharding=chain_state_shardings(mesh))
        y0 = data[name + "#y0"]
        res = eng.serve([Request(i, key=jax.random.PRNGKey(100 + i), y0=y)
                         for i, y in enumerate(y0)])
        key = spec + "/" + name
        out[key + "/samples"] = np.stack([np.asarray(res[i]) for i in range(len(y0))])
        by_rid = {m.rid: [getattr(m, c) for c in counters] for m in eng.stats.per_request}
        out[key + "/counters"] = np.asarray([by_rid[i] for i in range(len(y0))])
        if spec != fused_on:
            continue

        @jax.jit
        def sample(p, y, k):
            r = asd_sample_batched(make_ddpm_model_fn(p, dc), ddpm(K), y, k, theta,
                                   eager_head=True, noise_mode="counter",
                                   keep_trajectory=False)
            return r.sample, r.rounds, r.head_calls

        s, r, h = sample(params, jax.device_put(data[name + "#fused_y0"],
                                                NamedSharding(mesh, batch_pspec(mesh))),
                         jax.random.PRNGKey(1))
        out.update({"fused/" + name + "/sample": np.asarray(s),
                    "fused/" + name + "/rounds": np.asarray(r),
                    "fused/" + name + "/head_calls": np.asarray(h)})
np.savez(sys.argv[2], **out)
"""


def _inputs(path):
    """Every config's numpy params (nonzero out_proj and norm scales), the
    engine's request y0 and the fused sampler's y0, written to ``path``."""
    flat = {}
    for name in ranks.CONFIGS:
        dc = ranks.config(name)
        tree = init_denoiser_params(dc, seed=3, out_scale=1.0, device="cpu")
        flat.update({f"{name}/{'/'.join(p)}": leaf.numpy() for p, leaf in pytree.paths(tree)})
        flat[f"{name}#y0"] = np.stack([r.y0 for r in ranks.requests(dc)])
        flat[f"{name}#fused_y0"] = ranks.fused_y0(dc)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _printed(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = serve.main(argv)
    return summary, out.getvalue()


@pytest.fixture(scope="module")
def runs(_one_thread):
    """The JAX subprocesses, the four- and two-rank groups, and the 1 x 1
    runs in this process, side by side."""
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        inputs = os.path.join(tmp, "inputs.npz")
        _inputs(inputs)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        # one JAX process a mesh, side by side: each compiles its own engines
        configs = repr({n: ranks.CONFIGS[n] for n in ranks.ENGINE_CONFIGS})
        statics = repr((ranks.K, ranks.THETA, ranks.SLOTS, ranks.COUNTERS))
        outs = [os.path.join(tmp, f"jax_{spec}.npz") for spec in JAX_MESHES]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, inputs, out, configs,
             repr([(spec, ranks.ENGINE_CONFIGS)]), repr(TWO[0]), statics],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for spec, out in zip(JAX_MESHES, outs)]
        four = pool.submit(t_group.run_group, ranks.rank_cases, 4, "cpu", (
            FOUR, inputs, False, [BASE + CLI_MESH + a for a in CLI_RUNS.values()]))
        two = pool.submit(t_group.run_group, ranks.rank_cases, 2, "cpu",
                          (TWO, inputs, True, (), True))
        try:
            ref = ranks.reference_cases(inputs)
            one = {name: _printed(BASE + a) for name, a in CLI_RUNS.items()}
            four, two = four.result(), two.result()
        finally:
            errs = [proc.communicate(timeout=300)[1] for proc in procs]
        jax = {}
        for proc, err, out in zip(procs, errs, outs):
            assert proc.returncode == 0, err[-3000:]
            jax.update(np.load(out))
    return dict(ranks={spec: two for spec in TWO} | {spec: four for spec in FOUR},
                jax=jax, ref=ref, one=one, cli=four)


def _bits(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[r], b[r]) for r in a)


CASES = [(spec, name) for spec in JAX_MESHES for name in ranks.ENGINE_CONFIGS]
ACCEPTS = ranks.COUNTERS.index("accepts")


def _law_problems(got: dict, want: dict) -> list:
    """Requests whose counters break the accept-bit law against ``want``'s:
    every counter equal but ``accepts``, which may differ by one row, the
    DDPM schedule's last step.  Its sigma is 0, where GRS accepts iff
    m_hat equals m to the bit, and the two come from model calls over other
    batches (and, under a model axis, other orders of the tensor-parallel
    sums): that row sits at the threshold by construction, and its sample
    is m_hat or m, equal to rounding.  Every other row is tested at its
    float threshold like any other, so its bit must agree."""
    bad = []
    for rid, w in want.items():
        g = got[rid]
        rest = [i for i in range(len(w)) if i != ACCEPTS]
        if [g[i] for i in rest] != [w[i] for i in rest] or abs(g[ACCEPTS] - w[ACCEPTS]) > 1:
            bad.append((rid, g, w))
    return bad


@pytest.mark.parametrize("spec,name", CASES)
def test_a_request_is_within_1e5_of_1x1_and_jax_under_the_accept_law(runs, spec, name):
    lead = runs["ranks"][spec][0]["engines"][spec, name]
    ref = runs["ref"]["engines"][name]
    jax = {k: runs["jax"][f"{spec}/{name}/{k}"] for k in ("samples", "counters")}
    assert sorted(lead["samples"]) == list(range(ranks.N_REQ))
    for rid, sample in lead["samples"].items():
        np.testing.assert_allclose(sample, ref["samples"][rid], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(sample, jax["samples"][rid], rtol=TOL, atol=TOL)
    jax_counters = {rid: tuple(int(v) for v in c) for rid, c in enumerate(jax["counters"])}
    assert _law_problems(lead["counters"], ref["counters"]) == []
    assert _law_problems(lead["counters"], jax_counters) == []
    accepts, proposals = jax["counters"][:, 3].sum(), jax["counters"][:, 4].sum()
    assert 0 < accepts < proposals  # the verify rejected some drafts


def test_the_accept_law_catches_a_counter_off_by_more_than_its_row():
    want = {0: (5, 5, 26, 5, 16)}
    assert _law_problems({0: (5, 5, 26, 6, 16)}, want) == []
    assert _law_problems({0: (5, 5, 26, 7, 16)}, want) and \
        _law_problems({0: (5, 5, 26, 5, 17)}, want)


@pytest.mark.parametrize("spec,name", [(s, n) for s in ("1x1x2",) + FOUR
                                       for n in ranks.ENGINE_CONFIGS])
def test_dxm_gives_the_1xm_bits_and_counters(runs, spec, name):
    one_m = runs["ranks"]["1x2"][0]["engines"]["1x2", name]
    for r in runs["ranks"][spec]:
        got = r["engines"][spec, name]
        assert got["counters"] == one_m["counters"]
        # rank 0 of each model line holds every request, the others their block's
        assert got["samples"] and all(np.array_equal(v, one_m["samples"][rid])
                                      for rid, v in got["samples"].items())
    assert _bits(runs["ranks"][spec][0]["engines"][spec, name]["samples"], one_m["samples"])


@pytest.mark.parametrize("spec,name", [(s, n) for s in TWO + FOUR for n in ranks.ENGINE_CONFIGS])
def test_the_model_ranks_of_a_block_hold_the_same_bits_at_every_boundary(runs, spec, name):
    blocks = {}
    for r in runs["ranks"][spec]:
        coords = r["coords"][spec]
        got = r["engines"][spec, name]
        assert got["eager"]  # host-staged collectives in the model call: no graphs
        blocks.setdefault((coords.get("pod", 0), coords["data"]), []).append(
            (coords["model"], got["rows"], got["digests"]))
    per, data_size = ranks.SLOTS // len(blocks), int(spec.split("x")[-2])
    for (pod, data), members in blocks.items():
        assert sorted(m for m, _, _ in members) == [0, 1]
        index = pod * data_size + data
        for _, rows, digests in members:
            assert rows == (index * per, (index + 1) * per)
            assert len(digests) > 3 and digests == members[0][2]


@pytest.mark.parametrize("spec,name", [(s, n) for s in ("1x2", "2x2")
                                       for n in ranks.ENGINE_CONFIGS])
def test_a_rank_keeps_the_layouts_bytes_of_the_weights(runs, spec, name):
    for r in runs["ranks"][spec]:
        got = r["engines"][spec, name]
        assert got["resident_bytes"] == got["layout_bytes"] < got["whole_bytes"]
        for path, shape in got["local_shapes"].items():
            spec_ = got["specs"][path]
            cut = [i for i, e in enumerate(spec_) if e is not None]
            assert len(cut) <= 1 and all(spec_[i] == "model" for i in cut), path
    policy = runs["ranks"][spec][0]["engines"][spec, "policy"]
    # the policy smoke: every leaf the layout cuts is tensor-parallel
    assert policy["gathered_paths"] == [] and len(policy["tp"]) == 5


def test_the_narrowed_config_gathers_its_fallback_cut_leaves_at_every_call(runs):
    got = runs["ranks"]["1x2"][1]["engines"]["1x2", "dense"]
    assert got["gathered_paths"] == ["decoder.g0.attn.wk", "decoder.g0.attn.wv",
                                     "t_mlp1", "t_mlp2"]
    assert got["specs"]["decoder.g0.attn.wk"] == (None, "model")  # cut on embed
    assert got["local_shapes"]["decoder.g0.attn.wk"] == (2, 128, 4, 64)
    per_call = 2 * (2 * 256 * 4 * 64) + 2 * 256 * 256
    assert got["calls"] >= got["rounds"] > 0
    assert got["gathered_elements"] == got["calls"] * per_call


@pytest.mark.parametrize("name", ranks.ENGINE_CONFIGS)
def test_the_fused_sampler_on_1x2_matches_jax_and_1x1(runs, name):
    blocks = [r["fused"][name] for r in runs["ranks"]["1x2"]]
    ref = runs["ref"]["fused"][name]
    for k in ("sample", "rounds", "head_calls"):
        assert np.array_equal(blocks[1][k], blocks[0][k])  # the model ranks agree
    np.testing.assert_allclose(blocks[0]["sample"], ref["sample"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(blocks[0]["sample"], runs["jax"][f"fused/{name}/sample"],
                               rtol=TOL, atol=TOL)
    for k in ("rounds", "head_calls"):
        assert blocks[0][k].tolist() == ref[k].tolist() == runs["jax"][f"fused/{name}/{k}"].tolist()


def test_the_moe_denoiser_on_1x2_is_within_1e5_of_1x1(runs):
    ref = runs["ref"]["engines"]["moe"]
    for r in runs["ranks"]["1x2"]:
        got = r["engines"]["1x2", "moe"]
        assert got["counters"] == ref["counters"]
        # the expert stacks are cut over model but are no TP leaves: gathered
        assert {p.rsplit(".", 1)[1] for p in got["gathered_paths"]} == {"w_gate", "w_up",
                                                                         "w_down"}
        for rid, sample in got["samples"].items():
            np.testing.assert_allclose(sample, ref["samples"][rid], rtol=TOL, atol=TOL)
    assert len(runs["ranks"]["1x2"][0]["engines"]["1x2", "moe"]["samples"]) == ranks.N_REQ


def test_a_diverging_model_rank_makes_every_rank_raise(runs):
    for r in runs["ranks"]["1x2"]:
        assert "model ranks [1] of this block hold other counters" in r["diverged"]


_LINE = re.compile(r"(\d+) fused rounds in (\d+) supersteps, accept rate ([\d.]+), "
                   r"mean live window ([\d.]+/\d+)")


@pytest.mark.parametrize("engine", sorted(CLI_RUNS))
def test_the_cli_serves_on_2x2_with_the_1x1_counters(runs, engine):
    i = list(CLI_RUNS).index(engine)
    out, summary = runs["cli"][0]["cli"][i]
    assert all(r["cli"][i] == ("", None) for r in runs["cli"][1:])  # the others print nothing
    ref, ref_out = runs["one"][engine]
    assert summary["finite"] and "finite=True" in out and "finite=False" not in out
    if engine == "fused":
        assert out.startswith("[fused] sampled 8 chains (K=20)")
        assert "output (8, 8, 4), finite=True" in out
        depth = re.compile(r"sequential depth (\d+) => ([\d.]+)x")
        assert depth.search(out).groups() == depth.search(ref_out).groups()
        return
    line = next(ln for ln in out.splitlines() if ln.startswith("[continuous]"))
    assert "served 8 requests on 4 slots (unpacked, K=20" in line and "samples/s" in line
    assert "mp=" not in line  # the JAX CLI's mesh line: no model-group clause
    assert "output (8, 4) per request, finite=True" in out
    assert _LINE.search(line).groups() == (
        str(ref["rounds_total"]), str(ref["supersteps"]), f"{ref['accept_rate']:.2f}",
        f"{ref['mean_window']:.1f}/8")
    for rid, sample in summary["samples"].items():
        np.testing.assert_allclose(sample, ref["samples"][rid], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("eager", [False, True])
def test_the_sampler_loop_captures_unless_asked_to_run_eagerly(eager):
    """The loop's program is eager exactly when asked (on the card it is
    otherwise captured; ``-k sampler_loop_eager`` in the card tests), and
    its result is the same bits either way."""
    dc = ranks.config("policy")
    fn = make_ddpm_model_fn(init_denoiser_params(dc, 0, device="cpu"), dc)
    sched = t_sch.ddpm(ranks.K)
    y0 = torch.from_numpy(ranks.fused_y0(dc))
    keys = prng.split(prng.PRNGKey(1), ranks.CHAINS)
    st = init_chain_state(sched, y0, ranks.THETA, False, key=keys, noise_mode="counter")
    loop = SamplerLoop(fn, sched, st, ranks.THETA, eager_head=True, keep_trajectory=False,
                       noise_mode="counter", **({"eager": True} if eager else {}))
    assert loop.program.eager is eager
    with torch.no_grad():
        got = loop.result(loop.run()).sample
        ref = asd_sample_batched(fn, sched, y0, ranks.THETA, eager_head=True,
                                 keep_trajectory=False, device="cpu", noise_mode="counter",
                                 keys=keys, eager=not eager).sample
    assert torch.equal(got, ref)
