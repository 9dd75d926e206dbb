"""The port's checkpoints and training loop against the JAX package's, in
one process: a checkpoint either package writes restores in the other, the
manifest's bytes are msgpack's, and ``loop.run`` resumes, stops on a
signal and rolls back as the reference's does."""

import os
import shutil
import signal

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_ckpt
from repro_torch import pytree
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.configs.registry import paper_diffusion_policy_smoke
from repro_torch.data.pipeline import GMMSequences
from repro_torch.models.diffusion import sl_denoiser_loss
from repro_torch.training import loop as t_loop
from repro_torch.training.optimizer import adamw, constant_schedule
from repro_torch.training.train_step import make_train_step
from repro_torch.weights import denoiser_init_params


def _state(seed=0):
    """A small {"params", "opt"} tree as the loop saves it."""
    g = torch.Generator().manual_seed(seed)
    params = {"decoder": {"g0": {"attn": {"wq": torch.randn(2, 4, 2, 3, generator=g)}},
                          "g1": {"scale": torch.randn(2, 4, generator=g)}},
              "out_proj": torch.randn(4, 5, generator=g)}
    opt = adamw(constant_schedule(1e-3))
    st = opt.init(params)
    st["step"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": st}


def _numpy(tree):
    return pytree.map(lambda t: t.numpy().copy(), tree)


def _assert_same(a, b):
    la, lb = list(pytree.paths(a)), list(pytree.paths(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), p


def test_keys_are_the_reference_keystr():
    tree = _state()
    keys, _, _ = j_ckpt._flatten(_numpy(tree))
    assert t_ckpt._flatten(tree)[0] == keys
    assert "['params']['decoder']['g0']['attn']['wq']" in keys
    assert "['opt']['mu']['out_proj']" in keys and "['opt']['step']" in keys


@pytest.mark.parametrize("writer", ["save", "save_async"])
def test_the_port_writes_and_the_reference_restores(tmp_path, writer):
    tree = _state(1)
    if writer == "save":
        t_ckpt.save(str(tmp_path), 3, tree, extra={"data_step": 3})
    else:
        t_ckpt.save_async(str(tmp_path), 3, tree, extra={"data_step": 3}).join()
    assert j_ckpt.latest_step(str(tmp_path)) == 3
    got, manifest = j_ckpt.restore(str(tmp_path), target=_numpy(tree))
    _assert_same(got, _numpy(tree))
    assert manifest["step"] == 3 and manifest["extra"] == {"data_step": 3}
    assert np.asarray(got["opt"]["step"]).dtype == np.int32


def test_the_reference_writes_and_the_port_restores(tmp_path):
    tree = _state(2)
    j_ckpt.save(str(tmp_path), 5, jax.tree_util.tree_map(jnp.asarray, _numpy(tree)),
                extra={"data_step": 5, "preempted": False})
    target = _state(3)
    got, manifest = t_ckpt.restore(str(tmp_path), target=target)
    _assert_same(got, tree)
    assert got["opt"]["step"].dtype == torch.int32
    assert manifest == j_ckpt.restore(str(tmp_path))[1]
    flat, _ = t_ckpt.restore(str(tmp_path))
    assert sorted(flat) == sorted(j_ckpt.restore(str(tmp_path))[0])


def test_manifest_bytes_equal_the_references(tmp_path):
    tree = _state(4)
    extra = {"data_step": 300, "preempted": True, "note": None, "lr": 1.5e-3}
    t_ckpt.save(str(tmp_path / "port"), 300, tree, extra=extra)
    j_ckpt.save(str(tmp_path / "jax"), 300, _numpy(tree), extra=extra)
    read = lambda w: (tmp_path / w / "step_000000300" / "manifest.msgpack").read_bytes()
    assert read("port") == read("jax")
    assert read("port") == msgpack.packb(msgpack.unpackb(read("jax")))
    assert not any(p.name.startswith("tmp_") for p in (tmp_path / "port").iterdir())


def test_restore_checks_shapes_and_keys(tmp_path):
    t_ckpt.save(str(tmp_path), 1, _state())
    bad = _state()
    bad["params"]["out_proj"] = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="out_proj"):
        t_ckpt.restore(str(tmp_path), target=bad)
    extra = _state()
    extra["params"]["cond_proj"] = torch.zeros(2, 4)
    with pytest.raises(KeyError, match="cond_proj"):
        t_ckpt.restore(str(tmp_path), target=extra)
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore(str(tmp_path / "none"))


def test_latest_step_and_retain(tmp_path):
    assert t_ckpt.latest_step(str(tmp_path / "none")) is None
    for s in (2, 10, 4, 8):
        t_ckpt.save(str(tmp_path), s, {"x": torch.zeros(1)})
    assert t_ckpt.latest_step(str(tmp_path)) == 10
    t_ckpt.retain(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_000000008", "step_000000010"]


def test_save_async_snapshots_before_returning(tmp_path):
    """The leaves are copied to the host before save_async returns, so an
    in-place update right after it does not reach the checkpoint."""
    tree = {"w": torch.ones(1000)}
    th = t_ckpt.save_async(str(tmp_path), 1, tree)
    tree["w"].add_(1.0)
    th.join(timeout=30)
    assert not th.is_alive()
    got, _ = t_ckpt.restore(str(tmp_path), target=tree)
    assert torch.equal(got["w"], torch.ones(1000))


# ------------------------------------------------------------------ msgpack

_VALUES = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "scalars": [None, True, False, 0.0, -2.5, 1e300, 3.0e-8, float("inf")],
    "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535, "f" * 65536,
             "ünïcödé ['x']"],
    "arrays": [[], list(range(15)), list(range(16)), list(range(70000)),
               [[1, 2], [3, [4, {"k": None}]]]],
    "maps": [{}, {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
             {f"k{i}": [i] for i in range(70000)}, {"a": {"b": {"c": [1.5, "x"]}}}],
    "manifest": [{"step": 12, "keys": ["['params']['w']"] * 40, "shapes": [[2, 3]] * 40,
                  "dtypes": ["float32"] * 40, "extra": {"data_step": 12,
                                                        "preempted": False}}],
}


@pytest.mark.parametrize("kind", sorted(_VALUES))
def test_msgpack_codec_matches_msgpack(kind):
    for obj in _VALUES[kind]:
        packed = msgpack.packb(obj)
        assert _msgpack.packb(obj) == packed
        assert _msgpack.unpackb(packed) == msgpack.unpackb(packed)
        assert msgpack.unpackb(_msgpack.packb(obj)) == _msgpack.unpackb(packed)


def test_msgpack_decoder_reads_float32_and_tuples():
    packed = msgpack.packb({"f": 1.25, "t": (1, 2)}, use_single_float=True)
    assert _msgpack.unpackb(packed) == {"f": 1.25, "t": [1, 2]}


def test_msgpack_codec_refuses_what_it_does_not_know():
    with pytest.raises(TypeError):
        _msgpack.packb({"x": np.int64(3)})
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(b"raw bytes"))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")


# --------------------------------------------------------------------- loop


def _trainer():
    dc = paper_diffusion_policy_smoke()
    data = GMMSequences(seq_len=dc.seq_len, d_data=dc.d_data, batch=4, seed=1)
    opt = adamw(constant_schedule(3e-3))

    def loss_fn(p, batch, gen):
        return sl_denoiser_loss(p, dc, batch["x0"], gen, 0.05, 50.0), {}

    def fresh():
        params = denoiser_init_params(dc, torch.Generator().manual_seed(0), device="cpu")
        return params, opt.init(params)

    return make_train_step(loss_fn, opt), fresh, lambda s: {"x0": data.batch_at(s)}


def _run(tmp, total, fresh, step, batch_fn, **kw):
    params, st = fresh()
    cfg = t_loop.LoopConfig(total_steps=total, ckpt_dir=str(tmp), ckpt_every=3, keep=2,
                            log_every=1)
    return t_loop.run(step, params, st, batch_fn, 11, cfg, device="cpu", **kw)


def test_loop_resumes_to_the_unbroken_run(tmp_path):
    step, fresh, batch_fn = _trainer()
    p5, s5, last, hist = _run(tmp_path / "a", 5, fresh, step, batch_fn)
    assert last == 5 and [h["step"] for h in hist] == [1, 2, 3, 4, 5]
    assert sorted(os.listdir(tmp_path / "a")) == ["step_000000003", "step_000000005"]
    shutil.copytree(tmp_path / "a" / "step_000000003", tmp_path / "b" / "step_000000003")
    p5b, s5b, last_b, hist_b = _run(tmp_path / "b", 5, fresh, step, batch_fn)
    assert last_b == 5 and [h["step"] for h in hist_b] == [4, 5]
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist[3:]]
    _assert_same({"p": p5b, "s": s5b}, {"p": p5, "s": s5})
    # the final checkpoint is the live state, bit for bit
    got, manifest = t_ckpt.restore(str(tmp_path / "a"), target={"params": p5, "opt": s5})
    _assert_same(got, {"params": p5, "opt": s5})
    assert manifest["extra"] == {"data_step": 5, "preempted": False}
    assert int(s5["step"]) == 5


def test_loop_stops_on_sigterm_and_resumes(tmp_path):
    step, fresh, batch_fn = _trainer()
    ref = _run(tmp_path / "ref", 5, fresh, step, batch_fn)

    def kill_at_two(s, metrics):
        if s == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    _, _, last, _ = _run(tmp_path / "run", 5, fresh, step, batch_fn, log_fn=kill_at_two)
    assert last == 2 and signal.getsignal(signal.SIGTERM) is before
    _, manifest = t_ckpt.restore(str(tmp_path / "run"))
    assert manifest["step"] == 2 and manifest["extra"]["preempted"] is True
    p, s, last, hist = _run(tmp_path / "run", 5, fresh, step, batch_fn)
    assert last == 5 and [h["step"] for h in hist] == [3, 4, 5]
    _assert_same({"p": p, "s": s}, {"p": ref[0], "s": ref[1]})


def test_loop_rolls_back_after_max_bad_steps(tmp_path):
    """Non-finite steps are skipped; after max_bad_steps in a row the loop
    restores the last checkpoint and goes on from its step."""
    calls = []

    def fake_step(params, opt_state, batch, gen):
        calls.append(int(batch["i"]))
        bad = len(calls) in (4, 5)  # the 4th and 5th calls fail
        if not bad:
            params = {"w": params["w"] + 1}
        return params, opt_state, {"loss": torch.tensor(float(len(calls))),
                                   "finite": not bad}

    cfg = t_loop.LoopConfig(total_steps=5, ckpt_dir=str(tmp_path), ckpt_every=3,
                            max_bad_steps=2)
    params, _, last, hist = t_loop.run(fake_step, {"w": torch.zeros(())},
                                       {"step": torch.zeros((), dtype=torch.int32)},
                                       lambda s: {"i": np.int64(s)}, 0, cfg, device="cpu")
    # steps 0, 1, 2 run (checkpoint at 3); step 3 is skipped (its update
    # dropped, the data step still advances), step 4 is the second bad step
    # in a row and rolls back to the step-3 checkpoint; steps 3 and 4 rerun
    assert calls == [0, 1, 2, 3, 4, 3, 4]
    assert last == 5 and float(params["w"]) == 5.0
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 4, 5]


def test_step_generators_depend_on_seed_and_step_alone():
    a = torch.rand(4, generator=t_loop.step_generator(3, 17, "cpu"))
    b = torch.rand(4, generator=t_loop.step_generator(3, 17, "cpu"))
    c = torch.rand(4, generator=t_loop.step_generator(3, 18, "cpu"))
    d = torch.rand(4, generator=t_loop.step_generator(4, 17, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_tree_order_and_keys_are_jax_s():
    """The port's trees flatten as JAX flattens dicts (sorted keys at every
    level, whatever the insertion order), with JAX's keystr for each path;
    unflatten and map keep the structure."""
    tree = {"params": {"z": np.arange(4.0), "c": {"y": np.ones(1), "x": np.full(2, 5.0)}},
            "opt": {"step": np.int32(3), "mu": {"b": np.ones(2), "a": np.zeros(3)}}}
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = list(pytree.paths(tree))
    assert [t_ckpt.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))
    assert [id(x) for x in pytree.leaves(tree)] == [id(x) for _, x in want]
    doubled = pytree.map(lambda x: x * 2, tree)
    back = pytree.unflatten(tree, [x * 2 for x in pytree.leaves(tree)])
    for t in (doubled, back):
        assert jax.tree_util.tree_structure(t) == jax.tree_util.tree_structure(tree)
        assert all(np.array_equal(a, 2 * b)
                   for a, b in zip(pytree.leaves(t), pytree.leaves(tree)))
