"""The port's llama-3.2-vision-11b (gated cross-attention to the vision
stub's patch embeddings, every 5th layer) and musicgen-medium (frame
inputs, sinusoidal positions, the GELU FFN) against the JAX package on
their ``reduced`` configs in float32: cross-attention, the ``xattn``
block's forward, prefill and decode steps, ``lm_fwd``, ``lm_prefill`` +
``lm_decode_step`` (``pos`` as a Python int and as device data), the param
trees and full-width counts.

The JAX package's three xattn paths differ: the forward ropes q at 0..L-1
and the vision keys at 0..Nv-1, the prefill and the step rope neither.  So
its forward and its prefill + decode give other logits for llama-vision,
and the port reproduces each path, not their agreement.

The params are drawn with numpy from a seed in the JAX init's tree and law,
except that the leaves its init leaves zero (norm scales, the xattn
``gate``) are drawn too.  Tolerances as tests/test_torch_lm.py: 1e-5 on
single layers, 2e-4 on logits.
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
from repro.nn import attention as j_attn
from repro.nn import ffn as j_ffn
from repro.nn import layers as j_layers
from repro.nn.param import unbox
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import ffn as t_ffn
from repro_torch.nn import layers as t_layers
from repro_torch.weights import from_jax_lm_params, init_lm_params, lm_param_shapes

VISION, MUSIC = "llama-3.2-vision-11b", "musicgen-medium"
PARAMS = {VISION: 9_775_157_256, MUSIC: 1_362_249_216}
B, L, P = 2, 24, 18


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
    """Leaves of ``shapes`` in key order: norm scales normal * 0.1, the
    xattn gate normal (tanh(gate) far from 0), the table and head normal *
    0.02, products normal / sqrt(fan-in)."""
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, k, stacked or k == "decoder") for k, v in shapes.items()}
    a = rng.standard_normal(shapes).astype(np.float32)
    if key == "scale":
        return a * np.float32(0.1)
    if key == "gate":
        return a
    if key in ("table", "w"):
        return a * np.float32(0.02)
    return a / np.float32(np.sqrt(np.prod(shapes[int(stacked):-1])))


@functools.lru_cache(maxsize=None)
def _arch(name):
    """(JAX reduced config, port reduced config, params as numpy arrays,
    inputs: token ids or frames (B, L(, d)), vision (B, Nv, d) or None)."""
    jcfg, tcfg = j_reduced(j_get_config(name)), reduced(get_config(name))
    tree = _draw(lm_param_shapes(tcfg), np.random.default_rng(300))
    if tcfg.embed_inputs:
        inputs = np.random.default_rng(6).integers(0, 256, (B, L))
    else:
        inputs = _acts(6, (B, L, 64))
    vision = _acts(7, (B, tcfg.n_vision_tokens, 64)) if tcfg.n_vision_tokens else None
    return jcfg, tcfg, tree, inputs, vision


def test_the_configs_are_the_jax_packages():
    for name in (VISION, MUSIC):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
        assert (dataclasses.asdict(reduced(get_config(name)))
                == dataclasses.asdict(j_reduced(j_get_config(name))))
    assert reduced(get_config(VISION)).n_vision_tokens == 16


@pytest.mark.parametrize("name", [VISION, MUSIC])
def test_lm_param_shapes_are_the_jax_init_tree(name):
    """The trees (the vision arch's one gate a xattn layer; musicgen's head
    and no embedding table) and the full-width counts."""
    for jcfg, tcfg in ((j_get_config(name), get_config(name)),
                       (j_reduced(j_get_config(name)), reduced(get_config(name)))):
        abstract = jax.eval_shape(lambda: unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg)))
        assert lm_param_shapes(tcfg) == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                               abstract)
    shapes = lm_param_shapes(get_config(name))
    count = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda x: isinstance(x, tuple)))
    assert count == PARAMS[name]
    if name == VISION:
        assert shapes["decoder"]["g4"]["attn"]["gate"] == (8,)
    else:
        assert "embed" not in shapes and "w_gate" not in shapes["decoder"]["g0"]["ffn"]


# ----------------------------------------------------------- cross-attention


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_cross_attention_matches(impl):
    """attn_fwd with kv_x: non-causal over the Nv vision tokens, RoPE on q at
    0..L-1 and on the vision keys at 0..Nv-1, times tanh(gate)."""
    jcfg, tcfg, tree, _, vision = _arch(VISION)
    p = _layer(tree["decoder"]["g4"]["attn"], 1)
    x = _acts(8, (B, L, 64))
    j = j_attn.attn_fwd(_jnp(p), jnp.asarray(x), jcfg, kv_x=jnp.asarray(vision), causal=False)
    t = t_attn.attn_fwd(_tt(p), _t(x), tcfg, kv_x=_t(vision), causal=False, impl=impl)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=1e-5)
    no_gate = t_attn.attn_fwd({k: v for k, v in _tt(p).items() if k != "gate"}, _t(x), tcfg,
                              kv_x=_t(vision), causal=False, impl=impl)
    torch.testing.assert_close(t, torch.tanh(_t(p["gate"])) * no_gate, atol=1e-6, rtol=1e-5)


def test_xattn_block_matches():
    """The block's forward (roped), the prefill that fills the cache with
    the vision tokens' raw KV heads (not roped), and steps that read it."""
    jcfg, tcfg, tree, _, vision = _arch(VISION)
    jd, td = jcfg.group[4], tcfg.group[4]
    p = _layer(tree["decoder"]["g4"], 0)
    x = _acts(9, (B, L, 64))
    ctx = dict(causal=True, vision=jnp.asarray(vision))
    jo, _ = jax.jit(lambda p, x: j_blocks.xattn_block_fwd(p, x, jcfg, jd, ctx, 0))(
        _jnp(p), jnp.asarray(x))
    for impl in ("naive", "flash"):
        to, aux = t_blocks.xattn_block_fwd(_tt(p), _t(x), tcfg, td,
                                           dict(causal=True, vision=_t(vision), impl=impl), 0)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
        assert aux == {}

    jc = j_blocks.xattn_block_cache_init(_jnp(p), jcfg, jd, B, L, jnp.float32)
    tc = t_blocks.xattn_block_cache_init(_tt(p), tcfg, td, B, L, torch.float32)
    assert tuple(tc["k"].shape) == jc["k"].shape == (B, 16, 2, 16)
    jo, jc, _ = jax.jit(lambda p, x, c: j_blocks.xattn_block_prefill(
        p, x, c, jcfg, jd, dict(ctx, impl="chunked"), 0))(_jnp(p), jnp.asarray(x[:, :P]), jc)
    to, tc = t_blocks.xattn_block_prefill(_tt(p), _t(x[:, :P]), tc, tcfg, td,
                                          dict(causal=True, vision=_t(vision)), 0)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), atol=1e-5, rtol=1e-5)
    before = {k: v.clone() for k, v in tc.items()}
    j_step = jax.jit(lambda p, x, c: j_blocks.xattn_block_step(p, x, c, 0, jcfg, jd, 0))
    for pos in range(P, L):
        jo, jc = j_step(_jnp(p), jnp.asarray(x[:, pos:pos + 1]), jc)
        to, tc = t_blocks.xattn_block_step(_tt(p), _t(x[:, pos:pos + 1]), tc, pos, tcfg, td, 0)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    assert all(torch.equal(tc[k], before[k]) for k in tc)


def test_xattn_block_needs_the_vision_embeddings():
    _, tcfg, tree, _, _ = _arch(VISION)
    with pytest.raises(ValueError, match="vision"):
        t_blocks.xattn_block_fwd(_tt(_layer(tree["decoder"]["g4"], 0)), torch.zeros(B, 4, 64),
                                 tcfg, tcfg.group[4], dict(causal=True), 0)


# --------------------------------------------------------------------- LM


@functools.lru_cache(maxsize=None)
def _jax_logits(name):
    """JAX's forward logits, its prefill logits and its decode logits."""
    jcfg, _, tree, inputs, vision = _arch(name)
    params = _jnp(tree)
    vis = None if vision is None else jnp.asarray(vision)
    full, _ = jax.jit(lambda t: j_lm.lm_fwd(params, t, jcfg, vision=vis))(jnp.asarray(inputs))
    caches = j_lm.lm_cache_init(params, jcfg, B, L, dtype=jnp.float32)
    pre, caches = jax.jit(lambda t, c: j_lm.lm_prefill(params, t, c, jcfg, vision=vis))(
        jnp.asarray(inputs[:, :P]), caches)
    step = jax.jit(lambda tok, c, pos: j_lm.lm_decode_step(params, tok, c, pos, jcfg))
    dec = [np.asarray(pre[:, 0])]
    for i in range(P, L):
        tok = inputs[:, i] if jcfg.embed_inputs else inputs[:, i:i + 1]
        lg, caches = step(jnp.asarray(tok), caches, jnp.asarray(i, jnp.int32))
        dec.append(np.asarray(lg[:, 0]))
    return np.asarray(full), np.stack(dec, 1)


def _port_logits(name, pos_kind="int"):
    """The port's forward logits, and its prefill then decode logits, with
    ``pos`` a Python int or one 0-d int32 tensor advanced in place."""
    _, tcfg, tree, inputs, vision = _arch(name)
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    vis = None if vision is None else _t(vision)
    full = t_lm.lm_fwd(params, _t(inputs), tcfg, vision=vis)
    caches = t_lm.lm_cache_init(params, tcfg, B, L, dtype=torch.float32)
    pre, caches = t_lm.lm_prefill(params, _t(inputs[:, :P]), caches, tcfg, vision=vis)
    dec, pos = [_np(pre[:, 0])], torch.tensor(P, dtype=torch.int32)
    for i in range(P, L):
        tok = inputs[:, i] if tcfg.embed_inputs else inputs[:, i:i + 1]
        lg, caches = t_lm.lm_decode_step(params, _t(tok), caches,
                                         i if pos_kind == "int" else pos, tcfg)
        pos.add_(1)
        dec.append(_np(lg[:, 0]))
    return _np(full), np.stack(dec, 1)


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
@pytest.mark.parametrize("name", [VISION, MUSIC])
def test_lm_paths_match(name, pos_kind):
    """lm_fwd, and lm_prefill + lm_decode_step (the prefill's last row, then
    one row a step), against JAX's, within 2e-4."""
    j_full, j_dec = _jax_logits(name)
    t_full, t_dec = _port_logits(name, pos_kind)
    assert t_full.shape == (B, L, 256) and np.abs(j_full).max() > 0.1
    np.testing.assert_allclose(t_full, j_full, atol=2e-4, rtol=0)
    np.testing.assert_allclose(t_dec, j_dec, atol=2e-4, rtol=0)


def test_vision_forward_and_decode_differ_as_in_jax():
    """JAX's forward ropes the xattn queries and vision keys, its prefill
    and steps do not: its decode logits are not its forward's.  The port's
    paths differ the same way (each path within 2e-4 of JAX's, so their
    difference within 4e-4 of JAX's), and musicgen's agree."""
    j_full, j_dec = _jax_logits(VISION)
    t_full, t_dec = _port_logits(VISION)
    j_gap, t_gap = j_dec - j_full[:, P - 1:], t_dec - t_full[:, P - 1:]
    assert np.abs(j_gap).max() > 1e-2 and np.abs(t_gap).max() > 1e-2
    np.testing.assert_allclose(t_gap, j_gap, atol=4e-4, rtol=0)
    m_full, m_dec = _port_logits(MUSIC)
    np.testing.assert_allclose(m_dec, m_full[:, P - 1:], atol=2e-4, rtol=0)


# ---------------------------------------------------------- musicgen parts


def test_gelu_ffn_is_jaxs_tanh_gelu():
    """jax.nn.gelu defaults to the tanh form: the port's GELU FFN matches
    JAX's within 1e-6, and the erf form would not."""
    x = 3 * _acts(11, (4, 50))
    np.testing.assert_allclose(
        _np(torch.nn.functional.gelu(_t(x), approximate="tanh")),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    assert np.abs(_np(torch.nn.functional.gelu(_t(x))) - np.asarray(
        jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4
    rng = np.random.default_rng(12)
    p = {"w_up": rng.standard_normal((64, 128)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((128, 64)).astype(np.float32) / 11}
    h = _acts(13, (B, 5, 64))
    np.testing.assert_allclose(_np(t_ffn.ffn_apply(_tt(p), _t(h))),
                               np.asarray(j_ffn.ffn_apply(_jnp(p), jnp.asarray(h))),
                               atol=1e-5, rtol=1e-5)


def test_frame_embedding_and_sinusoidal_positions_match():
    """musicgen's _embed: frames cast to the compute dtype plus
    sinusoidal_embed(0..L-1), in float32 (within 1e-6: sin and cos differ by
    an ulp between the libraries) and in bf16 (bit for bit), and one decode
    position given as a 0-d tensor."""
    jcfg, tcfg, _, frames, _ = _arch(MUSIC)
    np.testing.assert_allclose(
        _np(t_layers.sinusoidal_embed(torch.arange(L), 64)),
        np.asarray(j_layers.sinusoidal_embed(jnp.arange(L), 64)), atol=1e-6)
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, compute_dtype=dtype)
        tc = dataclasses.replace(tcfg, compute_dtype=dtype)
        j = j_lm._embed({}, jnp.asarray(frames), jc, jnp.dtype(dtype))
        t = t_lm._embed({}, _t(frames), tc)
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(t), np.asarray(j.astype(jnp.float32)),
                                   atol=1e-6 if dtype == "float32" else 0, rtol=0)
    one = t_lm._embed({}, _t(frames[:, 7:8]), tcfg, torch.tensor(7))
    torch.testing.assert_close(one, t_lm._embed({}, _t(frames), tcfg)[:, 7:8])


def test_init_lm_params_draws_the_gates_nonzero():
    """The port's random init draws each xattn layer's gate (normal: the JAX
    init's 0 would make the layer a no-op), and musicgen's tree has a head
    and no embedding table."""
    params = init_lm_params(reduced(get_config(VISION)), 0, device="cpu")
    gate = params["decoder"]["g4"]["attn"]["gate"]
    assert tuple(gate.shape) == (2,) and gate.abs().min() > 0
    music = init_lm_params(reduced(get_config(MUSIC)), 0, device="cpu")
    assert "embed" not in music and tuple(music["head"]["w"].shape) == (64, 256)
