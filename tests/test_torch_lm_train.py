"""The LM trainer's data and loss against the JAX package's, at small size
(reduced configs, float32): ``MarkovLM`` bit for bit, and ``lm_loss`` and
its gradients against ``jax.value_and_grad`` (xlstm, hymba through B7's
backward, tinyllama, and gemma2 with its softcaps and tied head; with and
without a mask).  The train step, B7's backward alone, the init and the
CLI are in tests/test_torch_lm_train_cli.py.

Tolerances: the loss within 2e-5, gradients within 1e-4 of each leaf's
largest magnitude (float32 sums in other orders through a whole model).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.data.pipeline import MarkovLM as JMarkovLM
from repro.models import lm as j_lm
from repro.nn.param import unbox
from repro_torch import pytree
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.models import lm as t_lm
from repro_torch.weights import from_jax_lm_params

B, L = 2, 16
LOSS_ARCHS = ("xlstm-125m", "hymba-1.5b", "tinyllama-1.1b", "gemma2-9b")
# leaves the JAX init leaves zero (or at a constant), drawn here so every
# leaf gets a gradient
_ZEROED = ("scale", "conv_b", "dt_bias", "bq", "bk", "bv", "b_i", "b_gates")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(name):
    """(JAX reduced config, port reduced config, the JAX init as numpy with
    the leaves it zeroes drawn normal * 0.3)."""
    jcfg, tcfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    tree = jax.tree_util.tree_map(np.array, unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg)))
    rng = np.random.default_rng(400)

    def perturb(t, key=None):
        if isinstance(t, dict):
            return {k: perturb(v, k) for k, v in t.items()}
        if key in _ZEROED:
            return (t + 0.3 * rng.standard_normal(t.shape)).astype(np.float32)
        return t

    return jcfg, tcfg, perturb(tree)


def _batch(mask: bool, seed=7):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (B, L)).astype(np.int32),
             "labels": rng.integers(0, 256, (B, L)).astype(np.int32)}
    if mask:
        batch["mask"] = (rng.random((B, L)) < 0.6).astype(np.float32)
    return batch


def _close_grads(tg, jg, rel=1e-4):
    """Every leaf within ``rel`` of its largest magnitude; no leaf all zero."""
    for (path, t), (_, j) in zip(pytree.paths(tg), pytree.paths(jg)):
        j = np.asarray(j)
        scale = np.abs(j).max()
        assert scale > 0, path
        np.testing.assert_allclose(_np(t), j, atol=rel * scale, rtol=0, err_msg=str(path))


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("step", [0, 3])
def test_markov_lm_is_the_jax_pipelines_bit_for_bit(step):
    t = MarkovLM(vocab=300, seq_len=12, batch=3, seed=5).batch_at(step)
    j = JMarkovLM(vocab=300, seq_len=12, batch=3, seed=5).batch_at(step)
    assert set(t) == {"tokens", "labels"}
    for k in t:
        assert isinstance(t[k], np.ndarray) and t[k].dtype == np.int32
        np.testing.assert_array_equal(t[k], np.asarray(j[k]))
    np.testing.assert_array_equal(t["tokens"][:, 1:], t["labels"][:, :-1])


# ------------------------------------------------------------------- loss


@pytest.fixture(scope="module", params=LOSS_ARCHS)
def loss_arch(request):
    """(name, port config, port params, {mask: (JAX loss, metrics, grads)})."""
    jcfg, tcfg, tree = _jax_tree(request.param)
    vg = jax.jit(jax.value_and_grad(lambda p, b: j_lm.lm_loss(p, b, jcfg), has_aux=True))
    ref = {}
    for mask in (False, True):
        # one compile for both: JAX's loss without a mask is its loss with
        # a mask of ones, op for op
        batch = dict(_batch(mask), mask=np.ones((B, L), np.float32)) if not mask else \
            _batch(mask)
        (loss, metrics), grads = vg(_jnp(tree), _jnp(batch))
        ref[mask] = (float(loss), jax.tree_util.tree_map(np.asarray, metrics),
                     jax.tree_util.tree_map(np.asarray, grads))
    return request.param, tcfg, from_jax_lm_params(tree, tcfg, device="cpu"), ref


@pytest.mark.parametrize("mask", [False, True])
def test_lm_loss_and_gradients_match(loss_arch, mask):
    """The loss, its metrics and every leaf's gradient (labels as int32, as
    numpy gives them; the port casts them for gather)."""
    name, tcfg, params, ref = loss_arch
    j_loss, j_metrics, j_grads = ref[mask]
    ps = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    batch = {k: _t(v) for k, v in _batch(mask).items()}
    loss, metrics = t_lm.lm_loss(pytree.unflatten(params, ps), batch, tcfg)
    grads = torch.autograd.grad(loss, ps)
    assert abs(loss.item() - j_loss) <= 2e-5 * max(1.0, abs(j_loss))
    assert metrics["tokens"].item() == float(j_metrics["tokens"])
    assert abs(metrics["nll"].item() - float(j_metrics["nll"])) <= 2e-5 * abs(j_loss)
    assert metrics["moe_aux"].item() == float(j_metrics["moe_aux"]) == 0.0
    _close_grads(pytree.unflatten(params, grads), j_grads)


def test_lm_loss_denominator_is_at_least_one():
    _, tcfg, tree = _jax_tree("tinyllama-1.1b")
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    batch = {k: _t(v) for k, v in _batch(True).items()}
    batch["mask"] = torch.zeros(B, L)
    loss, metrics = t_lm.lm_loss(params, batch, tcfg)
    assert loss.item() == 0.0 and metrics["tokens"].item() == 1.0
