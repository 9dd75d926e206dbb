"""The port's LM trainer against the JAX package's, at small size (reduced
configs, float32): ``linear_scan``'s gradients (B7's backward, a reversed
scan) against autograd through its plain loop and against ``jax.grad`` of
the JAX package's ``mamba_fwd``, ``lm_init_params`` against the JAX init's
law, five steps of the train CLI's ``build`` + ``loop.run`` against the
JAX CLI's ``build`` + ``run`` at a 1 x 1 mesh from the same params (at
``--accum`` 1 and 2), the same on a mesh of ranks (2x1 and 1x2, two gloo
ranks) against the JAX CLI, and the CLI itself (``--mesh 2x1``, resume).  The MoE archs' CLI
runs are in tests/test_torch_moe_train.py.

Tolerances: gradients within 1e-4 of each leaf's largest magnitude;
trajectories of five AdamW steps within 1e-4 in the loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.data.pipeline import MarkovLM as JMarkovLM
from repro.launch import train as j_train
from repro.models import lm as j_lm
from repro.nn import ssm as j_ssm
from repro.nn.param import unbox
from repro.training.loop import LoopConfig as JLoopConfig
from repro.training.loop import run as j_run
from repro_torch import pytree
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.kernels.ssm_scan.ops import linear_scan, ssm_scan_plain
from repro_torch.launch import train as t_train
from repro_torch.nn import ssm as t_ssm
from repro_torch.training.loop import LoopConfig, run
from repro_torch.weights import from_jax_lm_params, lm_init_params

from repro_torch.distributed.group import run_group

import torch_mesh_ranks as mesh_ranks
from tests.test_torch_lm_train import B, _close_grads, _jax_tree, _jnp, _np, _t


# ------------------------------------------------------------ B7 backward


@pytest.mark.parametrize("shape", [(2, 33, 7), (1, 1, 5), (3, 9, 130)])
def test_linear_scan_gradients_match_autograd_through_the_plain_loop(shape):
    rng = np.random.default_rng(sum(shape))
    a = torch.from_numpy(rng.uniform(0.4, 1.0, shape).astype(np.float32)).requires_grad_()
    b = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_()
    G = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = linear_scan.launches, linear_scan.backward_launches
    h = linear_scan(a, b)
    assert h.grad_fn is not None
    da, db = torch.autograd.grad(h, (a, b), G)
    ra, rb = torch.autograd.grad(ssm_scan_plain(a, b), (a, b), G)
    torch.testing.assert_close(da, ra, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(db, rb, atol=1e-6, rtol=1e-5)
    assert (linear_scan.launches, linear_scan.backward_launches) == before  # no kernel here


def test_mamba_gradients_match_jax_grad():
    """The mamba mixer's gradients (input and every param) through B7's
    backward on the CPU against jax.grad of the JAX package's mamba_fwd
    (its chunked associative scan)."""
    jcfg, tcfg, tree = _jax_tree("hymba-1.5b")
    p = jax.tree_util.tree_map(lambda a: a[1], tree["decoder"]["g0"]["mamba"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 40, 64)).astype(np.float32)
    w = rng.standard_normal((B, 40, 64)).astype(np.float32)
    j_gp, j_gx = jax.jit(jax.grad(
        lambda p, x: jnp.sum(j_ssm.mamba_fwd(p, x, jcfg, chunk=16) * w),
        argnums=(0, 1)))(_jnp(p), jnp.asarray(x))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    out = (t_ssm.mamba_fwd(tp, tx, tcfg) * _t(w)).sum()
    grads = torch.autograd.grad(out, [tx] + [tp[k] for k in sorted(tp)])
    _close_grads({"x": grads[0], **dict(zip(sorted(tp), grads[1:]))},
                 {"x": j_gx, **{k: j_gp[k] for k in sorted(tp)}})


# ------------------------------------------------------------------- init


@pytest.mark.parametrize("name", ["xlstm-125m", "hymba-1.5b", "llama-3.2-vision-11b"])
def test_lm_init_params_has_the_jax_init_law(name):
    """Leaf by leaf against the JAX init: the same zeros and constants
    (norms, biases, gates zero; b_f 3; A_log, D) and, where drawn, the same
    mean and standard deviation within sampling error."""
    jcfg, tcfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    jtree = unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg))
    ttree = lm_init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for (path, t), (_, j) in zip(pytree.paths(ttree), pytree.paths(jtree)):
        t, j = _np(t), np.asarray(j)
        assert t.shape == j.shape, path
        if j.std() == 0 or path[-1] in ("A_log",):
            np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=str(path))
        else:
            assert abs(t.std() / j.std() - 1) < 0.15, (path, t.std(), j.std())
            assert abs(t.mean() - j.mean()) < 0.1 * j.std() + 0.02, path


# ---------------------------------------------------- train CLI against JAX


@functools.lru_cache(maxsize=None)
def _jax_cli_run(jcfg, accum, lr, steps, batch, seq):
    """The JAX CLI's build and run at a 1 x 1 mesh, as its main does (once
    a module for each set of arguments: the 1 x 1 and the mesh tests share
    it; nothing mutates the result)."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jitted, init, _ = j_train.build(jcfg, mesh, accum, lr, steps)
    params, opt_state = init()
    tree = jax.tree_util.tree_map(np.array, params)
    data = JMarkovLM(vocab=jcfg.vocab_size, seq_len=seq, batch=batch)

    def batch_fn(step):
        b = data.batch_at(step)
        if accum > 1:
            b = jax.tree_util.tree_map(
                lambda x: x.reshape((accum, x.shape[0] // accum) + x.shape[1:]), b)
        return b

    _, _, last, hist = j_run(jitted, params, opt_state, batch_fn, jax.random.PRNGKey(1),
                             JLoopConfig(total_steps=steps, log_every=5))
    return tree, [h["loss"] for h in hist]


@pytest.mark.parametrize("accum", [1, 2])
def test_five_cli_steps_follow_the_jax_cli(accum):
    """tinyllama (the CLI's default arch) reduced: the port's ``build`` and
    ``loop.run`` from the JAX ``init()``'s params, on the same MarkovLM
    batches, against the JAX CLI's losses."""
    jcfg = j_reduced(j_get_config("tinyllama-1.1b"))
    tcfg = reduced(get_config("tinyllama-1.1b"))
    steps, batch, seq, lr = 5, 4, 16, 3e-3
    tree, j_losses = _jax_cli_run(jcfg, accum, lr, steps, batch, seq)
    step, init, _ = t_train.build(tcfg, None, accum, lr, steps, device="cpu")
    _, opt_state = init()
    data = MarkovLM(vocab=tcfg.vocab_size, seq_len=seq, batch=batch)
    _, _, last, hist = run(step, from_jax_lm_params(tree, tcfg, device="cpu"), opt_state,
                           data.batch_at, 1, LoopConfig(total_steps=steps), device="cpu")
    assert last == steps
    np.testing.assert_allclose([h["loss"] for h in hist], j_losses, atol=1e-4, rtol=0)
    assert j_losses[-1] < j_losses[0]


@pytest.mark.parametrize("mesh,accum", [("2x1", 1), ("1x2", 2)])
def test_mesh_steps_follow_the_jax_cli(mesh, accum, tmp_path):
    """The same five steps on a mesh of ranks (``build`` on each rank of a
    gloo group: data parallelism with ZeRO-1, or tensor parallelism with
    the microbatches pre-split), from the JAX ``init()``'s params, against
    the JAX CLI's losses: a step on a mesh computes the 1 x 1 step's
    function."""
    jcfg = j_reduced(j_get_config("tinyllama-1.1b"))
    steps, batch, seq = 5, 4, 16
    tree, j_losses = _jax_cli_run(jcfg, accum, mesh_ranks.LR, steps, batch, seq)
    data = MarkovLM(vocab=jcfg.vocab_size, seq_len=seq, batch=batch)
    flat = {f"{mesh_ranks.TINY}/{'/'.join(p)}": np.asarray(v) for p, v in pytree.paths(tree)}
    for s in range(steps):
        flat.update({f"{mesh_ranks.TINY}/batch{s}/{k}": v for k, v in data.batch_at(s).items()})
    np.savez(tmp_path / "inputs.npz", **flat)
    losses = run_group(mesh_ranks.cli_case, 2, "cpu",
                       (str(tmp_path / "inputs.npz"), mesh_ranks.TINY, mesh, steps, accum))
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], j_losses, atol=1e-4, rtol=0)


CLI = ("--device", "cpu", "--batch", "4", "--seq", "16")


def test_cli_trains_on_a_mesh(capfd):
    """``--mesh 2x1`` starts two ranks; rank 0 prints the JAX CLI's lines,
    and the losses are the 1 x 1 CLI's."""
    single = t_train.main(list(CLI + ("--steps", "2")))
    capfd.readouterr()
    meshed = t_train.main(list(CLI + ("--steps", "2", "--mesh", "2x1")))
    lines = capfd.readouterr().out.strip().splitlines()
    first, last = (meshed["history"][i]["loss"] for i in (0, -1))
    assert lines == [f"done at step 2: loss {first:.3f} -> {last:.3f}"]
    assert meshed["last_step"] == 2
    np.testing.assert_allclose([h["loss"] for h in meshed["history"]],
                               [h["loss"] for h in single["history"]], rtol=1e-5, atol=0)


def test_cli_trains_and_resumes(tmp_path, capsys):
    """20 steps straight, against 10 steps into a checkpoint directory and
    a second call to 20 that resumes there: the same losses."""
    straight = t_train.main(list(CLI + ("--steps", "20")))
    out = capsys.readouterr().out
    assert "step 5: loss" in out and "step 20: loss" in out
    assert f"done at step 20: loss {straight['history'][0]['loss']:.3f}" in out
    first = t_train.main(list(CLI + ("--steps", "10", "--ckpt-dir", str(tmp_path))))
    second = t_train.main(list(CLI + ("--steps", "20", "--ckpt-dir", str(tmp_path))))
    assert first["last_step"] == 10 and second["last_step"] == 20
    assert [h["step"] for h in second["history"]] == list(range(11, 21))
    losses = [h["loss"] for h in first["history"] + second["history"]]
    np.testing.assert_allclose(losses, [h["loss"] for h in straight["history"]],
                               atol=1e-6, rtol=0)
    assert len(straight["data_s"]) == 20
    assert all(np.isfinite(losses))
