"""The port's dense LM archs against the JAX package on their ``reduced``
configs in float32: tinyllama-1.1b, yi-6b, gemma2-9b (alternating window
32 and full attention, attention and final softcaps, the embedding scale,
tied embeddings) and qwen2.5-14b (QKV biases).  Each ``attn`` block's
forward, prefill and decode steps (both of gemma2's group members, each
with its own window), ``lm_fwd``, ``lm_prefill`` + ``lm_decode_step`` with
``pos`` as a Python int and as device data; the param trees and full-width
counts; gemma2's bf16 embedding scale and its tied head.

The params are drawn with numpy from a seed in the JAX init's tree (the
port's ``lm_param_shapes``, held to ``lm_init``'s tree below) and its law,
except that the leaves its init leaves zero (norm scales, QKV biases) are
drawn too (normal * 0.1), so no leaf is trivially zero.
Tolerances as tests/test_torch_lm.py: 1e-5 on single layers, 2e-4 on
logits (both packages compute in float32 but sum in other orders).
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
from repro.models import blocks as j_blocks
from repro.models import lm as j_lm
from repro.nn.param import unbox
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm as t_lm
from repro_torch.weights import from_jax_lm_params, init_lm_params, lm_param_shapes

DENSE = ("tinyllama-1.1b", "yi-6b", "gemma2-9b", "qwen2.5-14b")
# full-width parameter counts (jax.eval_shape of the JAX package's lm_init)
PARAMS = {"tinyllama-1.1b": 1_100_048_384, "yi-6b": 6_061_035_520,
          "gemma2-9b": 9_241_404_928, "qwen2.5-14b": 14_770_033_664,
          "xlstm-125m": 172_980_528}
B, L, P = 2, 48, 40  # L > 32: gemma2's reduced window bites


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree_util.tree_map(_t, tree)


def _layer(tree, r):
    return jax.tree_util.tree_map(lambda a: a[r], tree)


def _acts(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _draw(shapes, rng, key=None, stacked=False):
    """Leaves of ``shapes`` in key order: norm scales and QKV biases normal *
    0.1, the embedding table and head normal * 0.02, products normal /
    sqrt(fan-in) (all axes but the last and the stacked layers axis)."""
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, k, stacked or k == "decoder") for k, v in shapes.items()}
    a = rng.standard_normal(shapes).astype(np.float32)
    if key in ("scale", "bq", "bk", "bv"):
        return a * np.float32(0.1)
    if key in ("table", "w"):
        return a * np.float32(0.02)
    return a / np.float32(np.sqrt(np.prod(shapes[int(stacked):-1])))


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(name, JAX reduced config, port reduced config, perturbed JAX params
    as numpy arrays, tokens)."""
    jcfg, tcfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    tree = _draw(lm_param_shapes(tcfg), np.random.default_rng(200))
    tokens = np.random.default_rng(5).integers(0, 256, (B, L))
    return name, jcfg, tcfg, tree, tokens


@pytest.fixture(scope="module", params=DENSE)
def arch(request):
    return _arch(request.param)


def test_the_configs_are_the_jax_packages():
    for name in DENSE + ("xlstm-125m",):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
        assert (dataclasses.asdict(reduced(get_config(name)))
                == dataclasses.asdict(j_reduced(j_get_config(name))))
    assert get_config("gemma2-9b").resolved_head_dim == 256


@pytest.mark.parametrize("name", DENSE + ("xlstm-125m",))
def test_lm_param_shapes_are_the_jax_init_tree(name):
    for jcfg, tcfg in ((j_get_config(name), get_config(name)),
                       (j_reduced(j_get_config(name)), reduced(get_config(name)))):
        abstract = jax.eval_shape(lambda: unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg)))
        assert lm_param_shapes(tcfg) == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                               abstract)
    count = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        lm_param_shapes(get_config(name)), is_leaf=lambda x: isinstance(x, tuple)))
    assert count == PARAMS[name]
    assert ("head" in lm_param_shapes(get_config(name))) == (name != "gemma2-9b")


# ------------------------------------------------------------------ blocks


def test_attn_block_matches(arch):
    """Every group member (gemma2: window 32, then full) at layer 1: the
    forward with the naive and the flash core, the prefill's output and
    caches, and decode steps at P..L-1."""
    name, jcfg, tcfg, tree, _ = arch
    for gi, (jd, td) in enumerate(zip(jcfg.group, tcfg.group)):
        window = td.window
        p = _layer(tree["decoder"][f"g{gi}"], 1)
        x = _acts(10 + gi, (B, L, 64))
        jo, _ = jax.jit(lambda p, x: j_blocks.attn_block_fwd(
            p, x, jcfg, jd, dict(causal=True), window))(_jnp(p), jnp.asarray(x))
        for impl in ("naive", "flash"):
            to, aux = t_blocks.attn_block_fwd(_tt(p), _t(x), tcfg, td,
                                              dict(causal=True, impl=impl), window)
            np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
            assert aux == {}

        jc = j_blocks.attn_block_cache_init(_jnp(p), jcfg, jd, B, L, jnp.float32)
        tc = t_blocks.attn_block_cache_init(_tt(p), tcfg, td, B, L, torch.float32)
        jo, jc, _ = jax.jit(lambda p, x, c: j_blocks.attn_block_prefill(
            p, x, c, jcfg, jd, dict(causal=True), window))(_jnp(p), jnp.asarray(x[:, :P]), jc)
        j_step = jax.jit(lambda p, x, c, pos: j_blocks.attn_block_step(p, x, c, pos, jcfg, jd,
                                                                       window))
        to, tc = t_blocks.attn_block_prefill(_tt(p), _t(x[:, :P]), tc, tcfg, td,
                                             dict(causal=True), window)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
        for pos in range(P, L):
            jo, jc = j_step(_jnp(p), jnp.asarray(x[:, pos:pos + 1]), jc,
                            jnp.asarray(pos, jnp.int32))
            to, tc = t_blocks.attn_block_step(_tt(p), _t(x[:, pos:pos + 1]), tc, pos, tcfg,
                                              td, window)
            np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), atol=1e-5, rtol=1e-5)


def test_gemma2_group_members_keep_their_windows():
    """The decoder hands each member of gemma2's group its own window: a
    forward with the windows swapped between the members differs."""
    _, _, tcfg, tree, tokens = _arch("gemma2-9b")
    assert [d.window for d in tcfg.group] == [32, 0]
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    swapped = dataclasses.replace(tcfg, group=tuple(
        dataclasses.replace(d, window=w) for d, w in zip(tcfg.group, (0, 32))))
    a = t_lm.lm_fwd(params, _t(tokens), tcfg)
    b = t_lm.lm_fwd(params, _t(tokens), swapped)
    assert torch.equal(a[:, :32], b[:, :32]) and not torch.allclose(a[:, 32:], b[:, 32:])


# --------------------------------------------------------------------- LM


@pytest.fixture(scope="module")
def jax_logits(arch):
    """JAX's forward logits, its prefill logits and its decode logits."""
    _, jcfg, _, tree, tokens = arch
    params = _jnp(tree)
    full, _ = jax.jit(lambda t: j_lm.lm_fwd(params, t, jcfg))(jnp.asarray(tokens))
    caches = j_lm.lm_cache_init(params, jcfg, B, L, dtype=jnp.float32)
    pre, caches = jax.jit(lambda t, c: j_lm.lm_prefill(params, t, c, jcfg))(
        jnp.asarray(tokens[:, :P]), caches)
    step = jax.jit(lambda tok, c, pos: j_lm.lm_decode_step(params, tok, c, pos, jcfg))
    dec = []
    for i in range(P, L):
        lg, caches = step(jnp.asarray(tokens[:, i]), caches, jnp.asarray(i, jnp.int32))
        dec.append(np.asarray(lg[:, 0]))
    return np.asarray(full), np.asarray(pre[:, 0]), np.stack(dec, 1)


def test_lm_fwd_matches(arch, jax_logits):
    _, _, tcfg, tree, tokens = arch
    t = t_lm.lm_fwd(from_jax_lm_params(tree, tcfg, device="cpu"), _t(tokens), tcfg)
    assert tuple(t.shape) == (B, L, 256) and t.dtype == torch.float32
    assert np.abs(jax_logits[0]).max() > 0.1
    np.testing.assert_allclose(_np(t), jax_logits[0], atol=2e-4, rtol=0)


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_lm_prefill_and_decode_match(arch, jax_logits, pos_kind):
    """Prefill and greedy-decode steps against JAX's; ``pos`` as a Python
    int, or as one 0-d int32 tensor advanced in place (a captured step's
    form, JAX's traced ``pos``)."""
    _, _, tcfg, tree, tokens = arch
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    caches = t_lm.lm_cache_init(params, tcfg, B, L, dtype=torch.float32)
    pre, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, tcfg)
    np.testing.assert_allclose(_np(pre[:, 0]), jax_logits[1], atol=2e-4, rtol=0)
    pos = torch.tensor(P, dtype=torch.int32)
    dec = []
    for i in range(P, L):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches,
                                         i if pos_kind == "int" else pos, tcfg)
        pos.add_(1)
        dec.append(_np(lg[:, 0]))
    np.testing.assert_allclose(np.stack(dec, 1), jax_logits[2], atol=2e-4, rtol=0)
    assert tuple(caches["g0"]["k"].shape) == (tcfg.n_repeats, B, L, tcfg.n_kv_heads, 16)


# ------------------------------------------------------------------ gemma2


def test_gemma2_bf16_embedding_scale_is_rounded_first():
    """JAX multiplies by jnp.asarray(sqrt(3584), bf16) = 59.75: the port's
    bf16 embedding equals JAX's bit for bit, and differs from a product by
    the unrounded 59.866."""
    jcfg = dataclasses.replace(j_reduced(j_get_config("gemma2-9b")),
                               compute_dtype="bfloat16", embed_scale=3584.0 ** 0.5)
    tcfg = dataclasses.replace(reduced(get_config("gemma2-9b")), compute_dtype="bfloat16",
                               embed_scale=3584.0 ** 0.5)
    table = _acts(3, (256, 64))
    ids = np.random.default_rng(4).integers(0, 256, (2, 9))
    j = j_lm._embed({"embed": {"table": jnp.asarray(table)}}, jnp.asarray(ids), jcfg,
                    jnp.bfloat16)
    t = t_lm._embed({"embed": {"table": _t(table)}}, _t(ids), tcfg)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(t), np.asarray(j.astype(jnp.float32)))
    assert float(torch.tensor(3584.0 ** 0.5, dtype=torch.bfloat16)) == 59.75
    unrounded = (_t(table)[_t(ids)].to(torch.bfloat16).float() * 3584.0 ** 0.5).to(
        torch.bfloat16)
    assert not torch.equal(t, unrounded)


def test_gemma2_tied_head_reads_the_embedding_table():
    """gemma2 has no ``head``: its logits are x @ embed.table^T, capped at
    30; a change to the table moves the logits of every position."""
    _, jcfg, tcfg, tree, tokens = _arch("gemma2-9b")
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    assert "head" not in params and tcfg.final_softcap == 30.0
    x = _t(_acts(6, (B, 3, 64)))
    t = t_lm._head(params, x, tcfg)
    j = j_lm._head(_jnp(tree), jnp.asarray(_np(x)), jcfg)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(t), _np(30.0 * torch.tanh(x @ params["embed"]["table"].T
                                                             / 30.0)), atol=1e-5)
    moved = dict(params, embed={"table": params["embed"]["table"] * 1.5})
    assert not torch.allclose(t_lm.lm_fwd(moved, _t(tokens), tcfg)[:, 0],
                              t_lm.lm_fwd(params, _t(tokens), tcfg)[:, 0])


# ------------------------------------------------------------------ weights


def test_init_lm_params_draws_every_leaf_nonzero(arch):
    """The port's random init: the JAX init's tree, with the norms and the
    QKV biases drawn (normal * 0.1), no leaf zero."""
    name, _, tcfg, _, _ = arch
    params = init_lm_params(tcfg, 0, device="cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == lm_param_shapes(tcfg)
    for leaf in jax.tree_util.tree_leaves(params):
        assert leaf.abs().min() > 0
    if name == "qwen2.5-14b":
        bq = params["decoder"]["g0"]["attn"]["bq"]
        assert 0.05 < bq.std().item() < 0.2
