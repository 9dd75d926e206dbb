"""MoE training in the port against the JAX package, at small size (reduced
configs, float32): ``lm_loss`` of reduced qwen3-moe-30b-a3b and dbrx-132b
and every leaf's gradient against ``jax.value_and_grad`` of the JAX
``lm_loss`` (with and without capacity drops, with remat, the aux weight
at 0), the summed aux loss, five trainer steps against the JAX CLI's, the
CLI at both MoE archs, dbrx's config and full-width tree, and the bf16
draw in runs.

Tolerances: the loss within 2e-5, each leaf's gradient within 1e-4 of its
largest magnitude (float32 sums in other orders through a whole model),
``moe_aux`` within 1e-6, trajectories of five AdamW steps within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import lm as j_lm
from repro.nn.param import unbox
from repro_torch import pytree, weights
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.launch import train as t_train
from repro_torch.models import lm as t_lm
from repro_torch.training.loop import LoopConfig, run
from repro_torch.weights import from_jax_lm_params, init_lm_params, lm_param_shapes

from tests.test_torch_lm_train import _close_grads, _jax_tree, _jnp, _t
from tests.test_torch_lm_train_cli import _jax_cli_run

MOE_ARCHS = ("qwen3-moe-30b-a3b", "dbrx-132b")
B, L = 2, 32
# jax.eval_shape of the JAX package's lm_init for dbrx-132b at full width
DBRX_PARAMS = 131_596_523_520


def _batch(seed=11):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (B, L)).astype(np.int32) for k in ("tokens", "labels")}


def _cfgs(name, capacity_factor):
    """(JAX config, port config) reduced, at ``capacity_factor`` if given."""
    jcfg, tcfg, _ = _jax_tree(name)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _tree(name):
    """The JAX init with its zeroed leaves drawn (``_jax_tree``), and the
    routers scaled by 25 (std 0.5): the tokens' choices spread, so the
    capacity drops pairs where it is tight."""
    _, _, tree = _jax_tree(name)
    tree = jax.tree_util.tree_map(np.copy, tree)
    tree["decoder"]["g0"]["moe"]["router"] *= np.float32(25.0)
    return tree


@functools.lru_cache(maxsize=None)
def _jax_ref(name, capacity_factor):
    """{aux weight: (loss, metrics, grads)} of the JAX package's lm_loss at
    the default weight and at 0, from one compile (the weight is an
    argument)."""
    jcfg, _ = _cfgs(name, capacity_factor)

    def loss(p, b, w):
        return j_lm.lm_loss(p, b, dataclasses.replace(jcfg, router_aux_weight=w))

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    out = {}
    for w in (jcfg.router_aux_weight, 0.0):
        (lv, metrics), grads = vg(_jnp(_tree(name)), _jnp(_batch()), jnp.float32(w))
        out[w] = (float(lv), jax.tree_util.tree_map(np.asarray, metrics),
                  jax.tree_util.tree_map(np.asarray, grads))
    return out


def _routes(fn):
    """``fn()`` with every port ``_route`` call's (params, x, cfg) recorded:
    (its result, the records)."""
    from repro_torch.nn import moe

    seen, route = [], moe._route

    def recorded(params, x, cfg, capacity=None):
        seen.append(({k: v.detach() for k, v in params.items()}, x.detach(), cfg))
        return route(params, x, cfg, capacity)

    moe._route = recorded
    try:
        return fn(), seen
    finally:
        moe._route = route


def _drops_and_edge_ties(records):
    """The (token, expert) pairs the capacity dropped over the recorded
    routes, and the positive ties at the capacity's edge (where two top-k's
    could keep different tokens)."""
    from repro_torch.nn import moe

    dropped = ties = 0
    for params, x, cfg in records:
        _, _, keep, _, _, _ = moe._route(params, x, cfg)
        C, n = keep.shape[-1], x.shape[1]
        dropped += x.shape[0] * n * cfg.top_k - int(keep.sum())
        if C < n:
            w = moe._route(params, x, cfg, n)[0].sort(-1, descending=True).values
            ties += int(((w[..., C - 1] == w[..., C]) & (w[..., C] > 0)).sum())
    return dropped, ties


# (arch, capacity_factor (None: the reduced config's 4.0, nothing drops),
# remat, aux weight 0)
CASES = [(name, cf, False, False) for name in MOE_ARCHS for cf in (None, 1.0)]
CASES += [("qwen3-moe-30b-a3b", 1.0, True, False), ("dbrx-132b", None, False, True)]


@pytest.mark.parametrize("name,capacity_factor,remat,no_aux", CASES, ids=[
    f"{n}-cf{cf or 4:g}{'-remat' if r else ''}{'-aux_weight_0' if a else ''}"
    for n, cf, r, a in CASES])
def test_moe_lm_loss_and_gradients_match(name, capacity_factor, remat, no_aux):
    """The loss, ``nll``, ``moe_aux`` (the sum over layers) and every leaf's
    gradient against ``jax.value_and_grad``.  capacity_factor 1.0: the
    capacity drops pairs (no positive tie at its edge, where the two
    top-k's could keep different tokens).  remat: the port's layers run
    under checkpoint (the JAX package's values are the same with its remat:
    the same math recomputed).  The aux weight at 0 takes the aux term out
    of the router's gradient, against JAX's at 0, and the router's
    gradient moves by more than the tolerance."""
    jcfg, tcfg = _cfgs(name, capacity_factor)
    tcfg = dataclasses.replace(tcfg, remat=remat,
                               router_aux_weight=0.0 if no_aux else tcfg.router_aux_weight)
    ref = _jax_ref(name, capacity_factor)
    j_loss, j_metrics, j_grads = ref[tcfg.router_aux_weight]
    params = from_jax_lm_params(_tree(name), tcfg, device="cpu")
    ps = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    batch = {k: _t(v) for k, v in _batch().items()}
    (loss, metrics), records = _routes(
        lambda: t_lm.lm_loss(pytree.unflatten(params, ps), batch, tcfg))
    grads = torch.autograd.grad(loss, ps)
    dropped, ties = _drops_and_edge_ties(records)
    assert len(records) == tcfg.n_layers  # the forward's (a recompute is after)
    assert (dropped > 0) == (capacity_factor is not None) and ties == 0, (dropped, ties)
    assert abs(loss.item() - j_loss) <= 2e-5 * max(1.0, abs(j_loss))
    assert abs(metrics["nll"].item() - float(j_metrics["nll"])) <= 2e-5 * abs(j_loss)
    aux = metrics["moe_aux"]
    assert aux.dtype == torch.float32 and aux.dim() == 0 and aux.item() > 0
    assert abs(aux.item() - float(j_metrics["moe_aux"])) <= 1e-6 * max(1.0, aux.item())
    assert metrics["tokens"].item() == float(j_metrics["tokens"]) == B * L
    tg = pytree.unflatten(params, grads)
    _close_grads(tg, j_grads)
    if no_aux:
        with_aux = ref[jcfg.router_aux_weight][2]["decoder"]["g0"]["moe"]["router"]
        without = j_grads["decoder"]["g0"]["moe"]["router"]
        assert np.abs(with_aux - without).max() > 1e-3 * np.abs(with_aux).max()
        assert abs(loss.item() - float(j_metrics["nll"])) <= 2e-5 * abs(j_loss)


def test_moe_aux_is_the_sum_over_layers():
    """``moe_aux`` is the sum of each layer's aux loss (``_aux_loss`` of its
    route), not their mean."""
    from repro_torch.nn import moe

    _, tcfg = _cfgs("qwen3-moe-30b-a3b", None)
    params = from_jax_lm_params(_tree("qwen3-moe-30b-a3b"), tcfg, device="cpu")
    batch = {k: _t(v) for k, v in _batch().items()}
    (_, metrics), records = _routes(lambda: t_lm.lm_loss(params, batch, tcfg))
    per_layer = [moe._aux_loss(*moe._route(p, x, c)[3:5], c).item() for p, x, c in records]
    assert len(per_layer) == tcfg.n_layers == 2 and min(per_layer) > 0
    np.testing.assert_allclose(metrics["moe_aux"].item(), sum(per_layer), rtol=1e-6)


# ----------------------------------------------------------------- trainer


def test_five_cli_steps_of_the_moe_follow_the_jax_cli():
    """Reduced qwen3-moe: the port's ``build`` and ``loop.run`` from the
    JAX ``init()``'s params, on the same MarkovLM batches, against the JAX
    CLI's losses (as the dense arch in test_torch_lm_train_cli.py)."""
    name = "qwen3-moe-30b-a3b"
    jcfg, tcfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    steps, batch, seq, lr = 5, 4, 16, 3e-3
    tree, j_losses = _jax_cli_run(jcfg, 1, lr, steps, batch, seq)
    step, init, _ = t_train.build(tcfg, None, 1, lr, steps, device="cpu")
    _, opt_state = init()
    data = MarkovLM(vocab=tcfg.vocab_size, seq_len=seq, batch=batch)
    aux = []
    _, _, last, hist = run(step, from_jax_lm_params(tree, tcfg, device="cpu"), opt_state,
                           data.batch_at, 1, LoopConfig(total_steps=steps, log_every=1),
                           log_fn=lambda s, m: aux.append(m["moe_aux"]), device="cpu")
    assert last == steps
    np.testing.assert_allclose([h["loss"] for h in hist], j_losses, atol=1e-4, rtol=0)
    assert len(aux) == steps and all(a > 0 for a in aux)
    assert j_losses[-1] < j_losses[0]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_cli_trains_the_moe_archs(name, capsys):
    res = t_train.main(["--arch", name, "--scale", "smoke", "--device", "cpu", "--steps", "2",
                        "--batch", "4", "--seq", "16"])
    assert res["last_step"] == 2 and len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert "done at step 2" in capsys.readouterr().out


# ------------------------------------------------------------------ dbrx


def test_dbrx_config_and_full_width_tree_are_the_jax_packages():
    """dbrx-132b's config, full and reduced, is the JAX package's, and its
    full-width tree (shapes only, nothing allocated) is the JAX init's,
    131.6 B parameters."""
    name = "dbrx-132b"
    from repro_torch.configs import dbrx_132b

    for tcfg, jcfg in ((get_config(name), j_get_config(name)),
                       (reduced(get_config(name)), j_reduced(j_get_config(name)))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dbrx_132b.CONFIG == get_config(name)
    jcfg = j_get_config(name)
    abstract = jax.eval_shape(lambda: unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg)))
    shapes = lm_param_shapes(get_config(name))
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), abstract)
    total = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert total == DBRX_PARAMS == sum(a.size for a in jax.tree_util.tree_leaves(abstract))


def test_bf16_draw_in_runs_keeps_the_law(monkeypatch):
    """``init_lm_params(dtype=bf16)`` on reduced dbrx with runs of 1000
    numbers: every leaf ``lm_compute_params`` casts comes out in bf16 at the
    law of its whole shape (an expert stack's fan-in counts E x d, wq's d x
    heads, the router normal * 0.02), the runs are fresh draws (no two equal), the
    rest stays float32."""
    cfg = reduced(get_config("dbrx-132b"))
    monkeypatch.setattr(weights, "_DRAW_CHUNK", 1000)
    tree = init_lm_params(cfg, 3, device="cpu", dtype=torch.bfloat16)
    g0 = tree["decoder"]["g0"]
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    for leaf, std in ((g0["moe"]["w_gate"], (E * d) ** -0.5),
                      (g0["moe"]["w_up"], (E * d) ** -0.5),
                      (g0["moe"]["w_down"], (E * ff) ** -0.5),
                      (g0["moe"]["router"], 0.02), (tree["embed"]["table"], 0.02),
                      (tree["head"]["w"], 0.02),
                      (g0["attn"]["wq"], (d * cfg.n_heads) ** -0.5)):
        assert leaf.dtype == torch.bfloat16
        flat = leaf.float().reshape(-1)
        assert abs(flat.std().item() / std - 1) < 5 / np.sqrt(2 * flat.numel())
        assert abs(flat.mean().item()) < 5 * std / np.sqrt(flat.numel())
        if flat.numel() >= 2000:
            assert not torch.equal(flat[:1000], flat[1000:2000])
    assert g0["ffn_norm"]["scale"].dtype == torch.float32
    assert tree["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("step", [0, 5])
def test_markov_lm_at_the_moe_vocab_is_the_jax_pipelines(step):
    """MarkovLM at qwen3-moe's vocab (151,936): its draws, searches of
    cumulative sums made once, are the JAX pipeline's ``rng.choice`` calls
    bit for bit."""
    from repro.data.pipeline import MarkovLM as JMarkovLM

    t = MarkovLM(vocab=151_936, seq_len=40, batch=3, seed=2).batch_at(step)
    j = JMarkovLM(vocab=151_936, seq_len=40, batch=3, seed=2).batch_at(step)
    for k in ("tokens", "labels"):
        assert t[k].dtype == np.int32
        np.testing.assert_array_equal(t[k], np.asarray(j[k]))


def test_adamw_a_group_of_leaves_at_a_time_is_one_group_bit_for_bit(monkeypatch):
    """AdamW updates a group of leaves at a time (its temporaries a group's,
    not the tree's): groups of one leaf, a group of vectors alone among
    them, give the bits of one group of every leaf over three steps."""
    from repro_torch.training import optimizer

    g = torch.Generator().manual_seed(9)
    tree = {"a": torch.randn(30, 20, generator=g), "b": {"c": torch.randn(7, generator=g),
                                                         "d": torch.randn(5, generator=g)},
            "e": torch.randn(3, 5, 6, generator=g)}
    grads = pytree.map(lambda t: torch.randn(t.shape, generator=g), tree)
    out = []
    for group_bytes in (1 << 30, 4):
        monkeypatch.setattr(optimizer, "_GROUP_BYTES", group_bytes)
        assert len(list(optimizer._groups([(None,) * 3 + (p,) for p in pytree.leaves(
            tree)]))) == (1 if group_bytes > 4 else 4)
        opt = optimizer.adamw(optimizer.cosine_schedule(1e-2, 2, 10))
        params = pytree.map(torch.clone, tree)
        state = opt.init(params)
        for _ in range(3):
            params, state, _ = opt.update(grads, state, params)
        out.append(pytree.leaves({"p": params, "mu": state["mu"], "nu": state["nu"]}))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert not torch.equal(out[0][0], tree["a"])
