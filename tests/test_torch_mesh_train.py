"""The port's mesh trainer against the JAX package's on the same meshes, on
the CPU: a two-rank and a four-rank gloo group
(``repro_torch.distributed.group.run_group``; the ranks' side is
``tests/torch_mesh_ranks.py``), and beside them three JAX subprocesses
(a share of the cases each) with four forced host devices.  The JAX side
draws the params (``lm_init`` at
PRNGKey(0), carried to the ranks by ``from_jax_lm_params``) and runs
``repro.launch.train.build``'s jitted step on each (arch, mesh, accum) of
the cases, 3 steps on the same MarkovLM batches; a JAX step under ``jit``
computes the same function whatever its arguments' shardings, so it is
the reference of both the port's layouts on that mesh, and the shards of
each layout are JAX's ``NamedSharding`` placements of it.

Cases (``torch_mesh_ranks.CASES``): reduced tinyllama on the meshes 2x1,
1x2, 2x2 and 2x1x1 (pod), each in the ``param_pspecs`` + ZeRO-1 and the
``fsdp_pspecs`` + ZeRO-1 layouts, each layout at accum 1 and 2 (the batch
pre-split into microbatches, as the JAX CLI does); reduced qwen3-moe on
1x2 (its expert stacks gathered at use) and on 2x1 (its aux loss, and
the masked mean of its batches, the whole batch's).  Both packages shard
leaves of ``MIN_SHARD`` elements.

  * each step's loss and grad norm within ``TOL`` (1e-5) relative;
  * every leaf's step-1 gradient block (the mean gradient, in AdamW's
    layout) within ``TOL`` of the leaf's largest magnitude (JAX's, from
    its first AdamW moment: mu = (1 - b1) g min(1, 1 / grad_norm));
  * the params and mu / nu after the last step, each rank's block against
    JAX's on the device at the rank's coordinates (``devices_indices_map``
    of the layout), mu / nu within ``TOL`` of the leaf's largest magnitude,
    the params within AdamW's bound (``ADAM_BOUND``) and all but 1 % of
    their elements within ``TOL`` or their AdamW sensitivity
    (``ADAM_SENSITIVITY``);
  * the initial blocks equal JAX's shards in bits, ranks whose blocks are
    the same slice hold the same bits, and each rank's resident bytes of
    params and of mu / nu are what the layout says, exactly;
  * three planted faults fail the gradient gate: no mean over the data
    axis, no psum of K's and V's gradients before their head slice, and
    the MoE's aux loss from each data rank's own block;
  * two steps on 2x1 into a checkpoint resumed on 1x2 to step 4 match the
    straight 1x2 run;
  * ``restore_sharded`` of a checkpoint written by the JAX package's
    ``save`` gives each rank of 2x2 JAX's ``restore_sharded`` shard on its
    device, in bits, in both layouts.
"""

import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.data.pipeline import MarkovLM as JMarkovLM
from repro_torch.distributed import group as t_group

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
# AdamW's bound on a param element after STEPS steps: its update is
# lr (m^ / (sqrt(v^) + eps) + wd p), and m^ / sqrt(v^) of a gradient
# element that is ~0 next to its leaf (|g| below TOL of the largest) may
# take any sign in either package, so such an element may move 2 lr a
# step apart; every other element's update agrees within float32 rounding
ADAM_BOUND = 2 * ranks.LR * ranks.STEPS
# AdamW's sensitivity, an element's own bound: its update lr m^ / sqrt(v^)
# carries the relative error of its gradient, which the gradient gate
# holds to TOL max|g| / |g_e|; m and v together at most twice that, over
# STEPS steps of at most LR each, with the last moment mu_e for g_e
ADAM_SENSITIVITY = 2 * ranks.LR * ranks.STEPS * TOL

# the JAX side, for a subset of the cases: the params (lm_init at
# PRNGKey(0); written first, for the ranks, by the process named to) and
# a checkpoint of them, then each reference's steps, the step-1 gradient,
# the shard indices of every case's layouts, and restore_sharded of the
# checkpoint (where asked)
_JAX_SCRIPT = r"""
import functools, os, sys
import numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint.manager import restore_sharded, save
from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.distributed import sharding as sh
from repro.launch import train as j_train
from repro.models.lm import lm_init
from repro.nn.param import unbox

batches, out_path, ckpt, cases = sys.argv[1:5]
STEPS, LR, MIN_SHARD, TINY = eval(sys.argv[5])
write, restore = eval(sys.argv[6]), sys.argv[7] == "restore"
cases = eval(cases)
flat = dict(np.load(batches))
# the CLI's build at the test's small widths: leaves of MIN_SHARD shard
j_train.param_pspecs = functools.partial(sh.param_pspecs, min_shard_elems=MIN_SHARD)
is_p = lambda x: isinstance(x, P)


def paths(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], pre + (k,))
    else:
        yield "/".join(pre), tree


def mesh_of(spec):
    dims = tuple(int(x) for x in spec.split("x"))
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return Mesh(np.asarray(jax.devices()[:int(np.prod(dims))]).reshape(dims), names)


def layout(cfg, mesh, name):
    boxed = jax.eval_shape(lambda k: lm_init(k, cfg), jax.random.PRNGKey(0))
    if name == "param":
        pspecs = sh.param_pspecs(boxed, mesh, min_shard_elems=MIN_SHARD)
    else:
        pspecs = sh.fsdp_pspecs(boxed, mesh, min_shard_elems=MIN_SHARD)
    shapes = unbox(boxed)

    def one(spec, shape):  # ZeRO-1 where the spec does not already use data
        named = {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}
        return spec if "data" in named else sh.zero1_pspec(spec, shape.shape, mesh)

    mu = jax.tree_util.tree_map(one, pspecs, shapes, is_leaf=is_p)
    return shapes, pspecs, {"mu": mu, "nu": mu, "step": P()}


def indices(tree, specs, mesh):
    out = {}
    for (k, leaf), (_, spec) in zip(paths(tree), paths(specs)):
        m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
        out[k] = np.array([[[s.start or 0, leaf.shape[d] if s.stop is None else s.stop]
                            for d, s in enumerate(m[dev])] for dev in mesh.devices.flat],
                          np.int64).reshape(mesh.devices.size, len(leaf.shape), 2)
    return out


inits, cfgs = {}, {}
for arch in sorted({c[0] for c in cases.values()}):
    cfgs[arch] = reduced(get_config(arch))
    inits[arch] = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: unbox(lm_init(k, cfgs[arch])))(jax.random.PRNGKey(0)))
    if arch in write:  # the ranks' params (renamed into place when whole)
        if restore:
            save(ckpt, 7, {"params": inits[arch]})
        np.savez(write[arch] + ".tmp.npz", **{f"{arch}/{k}": v for k, v in paths(inits[arch])})
        os.replace(write[arch] + ".tmp.npz", write[arch])

res = {}
for name, (arch, spec, lay, accum) in cases.items():
    cfg, mesh = cfgs[arch], mesh_of(spec)
    shapes, pspecs, ospecs = layout(cfg, mesh, lay)
    for part, specs in (("params", pspecs), ("mu", ospecs["mu"])):
        for k, v in indices(shapes, specs, mesh).items():
            res[f"{name}/idx/{part}/{k}"] = v
    ref = f"{arch}/{spec}/a{accum}"
    if f"{ref}/losses" in res:
        continue
    # repro.launch.train.build's step, from init()'s values (lm_init at
    # PRNGKey(0)) on init()'s shardings, which each step's outputs are put
    # back on (the jit's output shardings differ; no recompile)
    jitted, _, p_shard = j_train.build(cfg, mesh, accum, LR, STEPS)
    _, _, ospecs = layout(cfg, mesh, "param")
    o_shard = sh.shardings_from_pspecs(mesh, ospecs)
    params = jax.device_put(inits[arch], p_shard)
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), inits[arch])
    opt_state = jax.device_put({"mu": zeros, "nu": zeros, "step": np.zeros((), np.int32)},
                               o_shard)
    bshard = NamedSharding(mesh, sh.batch_pspec(mesh))
    losses, norms = [], []
    for s in range(STEPS):
        b = {k: flat[f"{arch}/batch{s}/{k}"] for k in ("tokens", "labels", "mask")
             if f"{arch}/batch{s}/{k}" in flat}
        if accum > 1:  # the JAX CLI's batch_fn
            b = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:]) for k, v in b.items()}
        else:
            b = jax.device_put(b, bshard)
        params, opt_state, m = jitted(params, opt_state, b,
                                      jax.random.fold_in(jax.random.PRNGKey(1), s))
        params, opt_state = jax.device_put((params, opt_state), (p_shard, o_shard))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if s == 0:
            # step 1's mean gradient from its AdamW moment: mu = (1 - b1) g
            # clip, clip = min(1, 1 / grad_norm) (b1 0.9, clip norm 1)
            clip = min(1.0, 1.0 / max(norms[0], 1e-9))
            for k, v in paths(opt_state["mu"]):
                res[f"{ref}/grad/{k}"] = np.asarray(v) / np.float32(0.1 * clip)
    res[f"{ref}/losses"] = np.array(losses)
    res[f"{ref}/grad_norms"] = np.array(norms)
    for part, tree in (("params", params), ("mu", opt_state["mu"]), ("nu", opt_state["nu"])):
        for k, v in paths(tree):
            res[f"{ref}/{part}/{k}"] = np.asarray(v)

# restore_sharded of the checkpoint on 2x2, in each layout
mesh = mesh_of("2x2")
for lay in ("param", "fsdp") if restore else ():
    shapes, pspecs, _ = layout(cfgs[TINY], mesh, lay)
    target = {"params": jax.tree_util.tree_map(lambda b: np.zeros(b.shape, b.dtype), shapes)}
    tree, manifest = restore_sharded(ckpt, target,
                                     {"params": sh.shardings_from_pspecs(mesh, pspecs)})
    res[f"restore/{lay}/step"] = np.array(manifest["step"])
    for k, arr in paths(tree["params"]):
        by_dev = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
        res[f"restore/{lay}/{k}"] = np.stack([by_dev[d.id] for d in mesh.devices.flat])
np.savez(out_path, **res)
"""


def _batches(path):
    """The steps' MarkovLM batches of both archs, as the JAX CLI draws them;
    the MoE's with a mask that keeps about 90 % of the first half of the
    rows' positions and 50 % of the second half's."""
    flat = {}
    rng = np.random.default_rng(3)
    keep = np.repeat([0.9, 0.5], ranks.BATCH // 2)[:, None]
    for arch in (ranks.TINY, ranks.MOE):
        cfg = j_reduced(j_get_config(arch))
        data = JMarkovLM(vocab=cfg.vocab_size, seq_len=ranks.SEQ, batch=ranks.BATCH)
        for s in range(max(ranks.STEPS, ranks.RESUME_STEPS)):
            for k, v in data.batch_at(s).items():
                flat[f"{arch}/batch{s}/{k}"] = v
            if arch == ranks.MOE:
                flat[f"{arch}/batch{s}/mask"] = (
                    rng.random((ranks.BATCH, ranks.SEQ)) < keep).astype(np.float32)
    np.savez(path, **flat)
    return flat


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], pre + (k,))
    else:
        yield "/".join(pre), tree


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the JAX side in three processes at once: (cases, whose params it writes
# for the ranks, whether it writes the checkpoint and restores it)
_JAX_PARTS = (
    (("2x1_param_a1", "2x1_fsdp_a1", "1x2_param_a2", "1x2_fsdp_a2"), ranks.TINY, True),
    (("2x2_param_a2", "2x2_fsdp_a2", "2x1x1_param_a1", "2x1x1_fsdp_a1"), None, False),
    (("moe_1x2_param_a1", "moe_2x1_param_a1"), ranks.MOE, False),
)


@pytest.fixture(scope="module")
def runs():
    """The JAX subprocesses, and beside them the two-rank and the
    four-rank groups, which start their cases once the JAX side has
    written the params."""
    by_world = {}
    for name, case in ranks.CASES.items():
        by_world.setdefault(ranks.world_of(case[1]), []).append(name)
    assert sorted(n for part in _JAX_PARTS for n in part[0]) == sorted(ranks.CASES)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        batches = os.path.join(tmp, "batches.npz")
        params = {arch: os.path.join(tmp, f"params_{i}.npz")
                  for i, arch in enumerate((ranks.TINY, ranks.MOE))}
        flat = _batches(batches)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        outs = [os.path.join(tmp, f"jax_{i}.npz") for i in range(len(_JAX_PARTS))]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, batches, out, os.path.join(tmp, "jax_ckpt"),
             repr({n: ranks.CASES[n] for n in names}),
             repr((ranks.STEPS, ranks.LR, ranks.MIN_SHARD, ranks.TINY)),
             repr({} if arch is None else {arch: params[arch]}),
             "restore" if restore else "-"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for out, (names, arch, restore) in zip(outs, _JAX_PARTS)]
        paths = tuple(params.values())
        try:
            four = pool.submit(t_group.run_group, ranks.rank_cases, 4, "cpu",
                               (batches, paths, by_world[4], tmp))
            two = t_group.run_group(ranks.rank_cases, 2, "cpu",
                                    (batches, paths, by_world[2], tmp))
            four = four.result()
        finally:
            errs = []
            for proc in procs:
                if proc.poll() is None and not all(map(os.path.exists, paths)):
                    proc.kill()
                errs.append(proc.communicate(timeout=600)[1])
        jax_out = {}
        for proc, err, out in zip(procs, errs, outs):
            assert proc.returncode == 0, err[-3000:]
            jax_out.update(np.load(out))
        for path in paths:
            flat.update(np.load(path))
    by_case = {}
    for r in two + four:
        for name, res in r["cases"].items():
            by_case.setdefault(name, []).append(res)
    return dict(flat=flat, jax=jax_out, cases=by_case, two=two, four=four)


def _block(full, idx):
    return full[tuple(slice(a, b) for a, b in idx)]


def _grad_problems(runs, name, key="grads"):
    """Leaves whose step-1 gradient block is off JAX's on some rank."""
    ref = ranks.reference(name)
    bad = []
    for r, res in enumerate(runs["cases"][name]):
        for path, block in res[key].items():
            full = runs["jax"][f"{ref}/grad/{path}"]
            want = _block(full, runs["jax"][f"{name}/idx/mu/{path}"][r])
            scale = max(float(np.abs(full).max()), 1e-30)
            if block.shape != want.shape or not np.abs(block - want).max() <= TOL * scale:
                bad.append((r, path))
    return bad


CASE_NAMES = sorted(ranks.CASES)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_losses_and_grad_norms_match_the_jax_step_on_the_same_mesh(runs, name):
    res = runs["cases"][name]
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(res[0][key], runs["jax"][f"{ranks.reference(name)}/{key}"],
                                   rtol=TOL, atol=0)
        assert all(r[key] == res[0][key] for r in res)  # every rank the same bits
    assert np.all(np.isfinite(res[0]["losses"]))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_step_1_gradient_blocks_match_jax(runs, name):
    assert _grad_problems(runs, name) == []


@pytest.mark.parametrize("name", CASE_NAMES)
def test_params_and_adamw_blocks_after_the_last_step_match_jax_shards(runs, name):
    for r, res in enumerate(runs["cases"][name]):
        for part, idx_of in (("params", "params"), ("mu", "mu"), ("nu", "mu")):
            for path, block in res[part].items():
                full = runs["jax"][f"{ranks.reference(name)}/{part}/{path}"]
                want = _block(full, runs["jax"][f"{name}/idx/{idx_of}/{path}"][r])
                assert block.shape == want.shape, (r, part, path)
                err = np.abs(block - want)
                scale = TOL * max(float(np.abs(full).max()), 1e-30)
                if part == "params":
                    assert err.max() <= ADAM_BOUND, (r, path, err.max())
                    # all but the elements of a ~0 gradient agree to float32,
                    # or within their AdamW sensitivity
                    mu_full = runs["jax"][f"{ranks.reference(name)}/mu/{path}"]
                    mu = _block(mu_full, runs["jax"][f"{name}/idx/params/{path}"][r])
                    sens = (ADAM_SENSITIVITY * float(np.abs(mu_full).max())
                            / np.maximum(np.abs(mu), 1e-30))
                    bound = np.maximum(scale + TOL * np.abs(want), sens)
                    assert np.mean(err > bound) < 0.01, (r, path)
                else:
                    assert err.max() <= scale, (r, part, path, err.max())


@pytest.mark.parametrize("name", CASE_NAMES)
def test_initial_blocks_are_jax_shards_and_replicas_hold_the_same_bits(runs, name):
    arch = ranks.CASES[name][0]
    res = runs["cases"][name]
    for r, rank in enumerate(res):
        for path, block in rank["init"].items():
            want = _block(runs["flat"][f"{arch}/{path}"],
                          runs["jax"][f"{name}/idx/params/{path}"][r])
            assert np.array_equal(block, want), (r, path)
    for path in res[0]["params"]:
        idx = runs["jax"][f"{name}/idx/params/{path}"]
        for r in range(1, len(res)):
            for q in range(r):
                if np.array_equal(idx[r], idx[q]):  # the same slice: the same bits
                    assert np.array_equal(res[r]["params"][path].view(np.int32),
                                          res[q]["params"][path].view(np.int32)), (r, q, path)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_resident_bytes_are_what_the_layout_says(runs, name):
    res = runs["cases"][name]
    for r, rank in enumerate(res):
        jax_bytes = {part: sum(4 * int(np.prod(np.diff(runs["jax"][f"{name}/idx/{part}/{p}"][r],
                                                       axis=1)))
                               for p in rank["params"]) for part in ("params", "mu")}
        assert rank["param_bytes"] == rank["layout_param_bytes"] == jax_bytes["params"]
        assert rank["mu_nu_bytes"] == rank["layout_mu_nu_bytes"] == 2 * jax_bytes["mu"]
    if ranks.world_of(ranks.CASES[name][1]) > 1 and ranks.CASES[name][1] != "2x1x1":
        full = sum(4 * v.size for k, v in runs["flat"].items()
                   if k.startswith(ranks.CASES[name][0] + "/") and "/batch" not in k)
        assert res[0]["mu_nu_bytes"] < 2 * full  # ZeRO-1 / FSDP cut AdamW's state


def test_tensor_parallel_and_gathered_leaves():
    """1x2 under param_pspecs: attention's wq / wo and the FFN compute
    tensor-parallel; wk / wv (the model fallback), the vocab leaves and the
    MoE expert stacks are gathered at use; FSDP computes nothing TP."""
    flat_tp = {"decoder/g0/attn/wq", "decoder/g0/attn/wo", "decoder/g0/ffn/w_down",
               "decoder/g0/ffn/w_gate", "decoder/g0/ffn/w_up"}
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.launch.train import mesh_layout

    for arch, want in ((ranks.TINY, flat_tp),
                       (ranks.MOE, {"decoder/g0/attn/wq", "decoder/g0/attn/wo"})):
        for layout, tp in (("param", want), ("fsdp", set())):
            lay = mesh_layout(ranks.config(arch), MeshGroups((1, 2), ("data", "model"), 0),
                              layout, ranks.MIN_SHARD)
            assert {"/".join(p) for p in lay.tp} == tp, (arch, layout)
            if layout == "param":
                specs = dict(_paths(lay.params))
                assert "model" in specs["decoder/g0/attn/wk"]  # fallback: gathered
                assert specs["embed/table"] == ("model",)


@pytest.mark.parametrize("name,fault", sorted(ranks.FAULTS.items()))
def test_planted_faults_fail_the_gradient_gate(runs, name, fault):
    assert _grad_problems(runs, name) == []
    bad = _grad_problems(runs, name, "fault_grads")
    assert bad, fault
    if fault == "no_f_on_kv":  # K / V and what feeds them lose their gradient
        assert {p for _, p in bad} >= {"decoder/g0/attn/wk", "decoder/g0/attn/wv"}


def test_resume_on_another_mesh_matches_the_straight_run(runs):
    for rank in runs["two"]:
        res = rank["resume"]
        first, resumed, straight = (res[k] for k in (ranks.RESUME_FROM, ranks.RESUME_TO,
                                                     "straight"))
        assert first["last"] == 2 and resumed["last"] == straight["last"] == 4
        assert len(resumed["losses"]) == 2  # steps 3 and 4 only
        np.testing.assert_allclose(first["losses"] + resumed["losses"], straight["losses"],
                                   rtol=TOL, atol=0)
        for path, block in straight["params"].items():
            np.testing.assert_allclose(resumed["params"][path], block, rtol=0,
                                       atol=ADAM_BOUND)
            assert np.mean(np.abs(resumed["params"][path] - block) > TOL) < 0.01, path


@pytest.mark.parametrize("layout", ranks.RESTORE_LAYOUTS)
def test_restore_sharded_reads_a_jax_checkpoint_into_jax_shards(runs, layout):
    assert int(runs["jax"][f"restore/{layout}/step"]) == 7
    sharded = 0
    for r, rank in enumerate(runs["four"]):
        res = rank["restore"][layout]
        assert res["step"] == 7
        for path, block in res["params"].items():
            want = runs["jax"][f"restore/{layout}/{path}"][r]
            assert np.array_equal(block, want), (r, path)
            sharded += block.size < runs["flat"][f"{ranks.TINY}/{path}"].size
    assert sharded  # the layout cut some leaf
