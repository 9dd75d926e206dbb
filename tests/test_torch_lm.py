"""The port's hymba LM path against the JAX package on ``reduced(hymba-1.5b)``
(2 layers, d_model 64, 4 heads over 2 KV heads, windows (0, 32), N = 8),
float32: RoPE, attention prefill and decode step, the mamba mixer, the
hymba block, ``lm_fwd``, ``lm_prefill`` + ``lm_decode_step``, the weight
converter and the random init.

The JAX params are ``lm_init``'s with seeded noise added to the leaves that
init leaves zero (norm scales, ``conv_b``, ``dt_bias``), so no leaf is
trivially zero.  Tolerances: 1e-5 on single layers and 2e-4 on logits (the
JAX package's own decode == forward bound, tests/test_models.py): both
packages compute in float32 but sum in other orders (XLA's associative
scan and chunked softmax against the port's sequential scan and plain
softmax).
"""

import dataclasses

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
from repro.nn import layers as j_layers
from repro.nn import ssm as j_ssm
from repro.nn.param import unbox
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers
from repro_torch.nn import ssm as t_ssm
from repro_torch.weights import from_jax_lm_params, init_lm_params, lm_param_shapes

NAME = "hymba-1.5b"
B, L, P = 2, 48, 40  # L > 32, so the window of layer 1 bites


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def cfgs():
    return j_reduced(j_get_config(NAME)), reduced(get_config(NAME))


@pytest.fixture(scope="module")
def tree(cfgs):
    """Perturbed JAX params as nested numpy arrays."""
    tree = jax.tree_util.tree_map(np.array, unbox(j_lm.lm_init(jax.random.PRNGKey(0),
                                                                cfgs[0])))
    rng = np.random.default_rng(100)

    def perturb(t, name=None):
        if isinstance(t, dict):
            return {k: perturb(v, k) for k, v in t.items()}
        if name in ("scale", "conv_b", "dt_bias"):
            return (t + 0.3 * rng.standard_normal(t.shape)).astype(np.float32)
        return t

    return perturb(tree)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(0, 256, (B, L))


def _layer(tree, r):
    return jax.tree_util.tree_map(lambda a: a[r], tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree_util.tree_map(_t, tree)


def _acts(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ configs


def test_the_configs_are_the_jax_packages(cfgs):
    """hymba, and every other ported arch, full and reduced."""
    from repro_torch.configs.archs import ARCHS

    full_j, full_t = j_get_config(NAME), get_config(NAME)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(cfgs[1]) == dataclasses.asdict(cfgs[0])
    assert len(ARCHS) == 10  # the eight dense archs, dbrx-132b and qwen3-moe-30b-a3b
    for name in ARCHS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
        assert (dataclasses.asdict(reduced(get_config(name)))
                == dataclasses.asdict(j_reduced(j_get_config(name))))
    assert full_t.d_inner == full_j.d_inner == 1600
    assert cfgs[1].group[0].window_per_repeat == (0, 32)


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_lm_param_shapes_are_the_jax_init_tree(size):
    jcfg = j_get_config(NAME) if size == "full" else j_reduced(j_get_config(NAME))
    tcfg = get_config(NAME) if size == "full" else reduced(get_config(NAME))
    abstract = jax.eval_shape(lambda: unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg)))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), abstract)
    assert lm_param_shapes(tcfg) == want
    if size == "full":
        count = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
            lm_param_shapes(tcfg), is_leaf=lambda x: isinstance(x, tuple)))
        assert count == 1_403_345_600


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 4093])
def test_apply_rope_matches(dtype, offset):
    x = _acts(1, (2, 7, 3, 16))
    pos = np.arange(7) + offset
    j = j_layers.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e4)
    t = t_layers.apply_rope(_t(x).to(getattr(torch, dtype)), _t(pos), 1e4)
    assert t.dtype == getattr(torch, dtype)
    # float32: sin/cos of large angles differ by an ulp or two of the angle;
    # bfloat16: one rounding of the output (8 mantissa bits) on each side
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(t.float()), np.asarray(j.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_softcap_embedding_and_unembedding_match():
    x = 40 * _acts(2, (3, 5))
    np.testing.assert_allclose(_np(t_layers.softcap(_t(x), 30.0)),
                               np.asarray(j_layers.softcap(jnp.asarray(x), 30.0)), atol=1e-5)
    assert torch.equal(t_layers.softcap(_t(x), 0.0), _t(x))
    table, ids = _acts(3, (11, 6)), np.array([[0, 10, 3], [3, 3, 1]])
    np.testing.assert_array_equal(
        _np(t_layers.embedding_apply({"table": _t(table)}, _t(ids), torch.float32)),
        np.asarray(j_layers.embedding_apply({"table": jnp.asarray(table)}, jnp.asarray(ids),
                                            jnp.float32)))
    h = _acts(4, (2, 6))
    np.testing.assert_allclose(
        _np(t_layers.unembed_apply({"table": _t(table)}, _t(h))),
        np.asarray(j_layers.unembed_apply({"table": jnp.asarray(table)}, jnp.asarray(h))),
        atol=1e-5)


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("window", [0, 5])
def test_attn_fwd_with_rope_matches(cfgs, tree, impl, window):
    jcfg, tcfg = cfgs
    p = _layer(tree["decoder"]["g0"]["attn"], 1)
    x = _acts(6, (B, 12, 64))
    j = j_attn.attn_fwd(_jnp(p), jnp.asarray(x), jcfg, window=window, causal=True)
    t = t_attn.attn_fwd(_tt(p), _t(x), tcfg, window=window, causal=True, impl=impl)
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 6])
def test_attn_prefill_and_step_match(cfgs, tree, window):
    jcfg, tcfg = cfgs
    p = _layer(tree["decoder"]["g0"]["attn"], 0)
    x = _acts(7, (B, 14, 64))
    Lp, S = 10, 16
    jc = j_attn.init_kv_cache(jcfg, B, S, jnp.float32)
    tc = t_attn.init_kv_cache(tcfg, B, S, torch.float32)
    jo, jc = j_attn.attn_prefill(_jnp(p), jnp.asarray(x[:, :Lp]), jc, jcfg, window=window)
    to, tc = t_attn.attn_prefill(_tt(p), _t(x[:, :Lp]), tc, tcfg, window=window)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), atol=1e-5)
    for pos in range(Lp, 14):
        jo, jc = j_attn.attn_step(_jnp(p), jnp.asarray(x[:, pos:pos + 1]), jc,
                                  jnp.asarray(pos, jnp.int32), jcfg, window=window)
        to, tc = t_attn.attn_step(_tt(p), _t(x[:, pos:pos + 1]), tc, pos, tcfg,
                                  window=window)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), atol=1e-5)


# ------------------------------------------------------------------- mamba


@pytest.mark.parametrize("Lm,chunk", [(1, 1024), (2, 1024), (40, 16), (48, 1024)])
@pytest.mark.parametrize("return_state", [False, True])
def test_mamba_fwd_matches(cfgs, tree, Lm, chunk, return_state):
    """The JAX mixer scans in chunks (40 with chunk 16 pads its last chunk
    and recomputes the exact final state); the port scans all of L."""
    jcfg, tcfg = cfgs
    p = _layer(tree["decoder"]["g0"]["mamba"], 1)
    x = _acts(8 + Lm, (B, Lm, 64))
    j = j_ssm.mamba_fwd(_jnp(p), jnp.asarray(x), jcfg, return_state=return_state,
                        chunk=chunk)
    t = t_ssm.mamba_fwd(_tt(p), _t(x), tcfg, return_state=return_state)
    if not return_state:
        j, t = (j, {}), (t, {})
    np.testing.assert_allclose(_np(t[0]), np.asarray(j[0]), atol=1e-5, rtol=1e-5)
    assert set(t[1]) == set(j[1])
    for name in t[1]:
        assert tuple(t[1][name].shape) == j[1][name].shape
        np.testing.assert_allclose(_np(t[1][name]), np.asarray(j[1][name]), atol=1e-5,
                                   rtol=1e-5)


def test_mamba_step_matches(cfgs, tree):
    jcfg, tcfg = cfgs
    p = _layer(tree["decoder"]["g0"]["mamba"], 0)
    x = _acts(9, (B, 9, 64))
    _, js = j_ssm.mamba_fwd(_jnp(p), jnp.asarray(x[:, :5]), jcfg, return_state=True)
    _, ts = t_ssm.mamba_fwd(_tt(p), _t(x[:, :5]), tcfg, return_state=True)
    for i in range(5, 9):
        jo, js = j_ssm.mamba_step(_jnp(p), jnp.asarray(x[:, i:i + 1]), js, jcfg)
        to, ts = t_ssm.mamba_step(_tt(p), _t(x[:, i:i + 1]), ts, tcfg)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(ts[name]), np.asarray(js[name]), atol=1e-5)
    init = t_ssm.mamba_init_state(_tt(p), tcfg, 3)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: v.shape for k, v in j_ssm.mamba_init_state(_jnp(p), jcfg, 3).items()}


# ------------------------------------------------------------------- block


@pytest.mark.parametrize("window", [0, 32])
def test_hymba_block_matches(cfgs, tree, window):
    jcfg, tcfg = cfgs
    desc = tcfg.group[0]
    p = _layer(tree["decoder"]["g0"], 1)
    x = _acts(10, (B, L, 64))
    jo, _ = j_blocks.hymba_block_fwd(_jnp(p), jnp.asarray(x), jcfg, jcfg.group[0],
                                     dict(causal=True), window)
    to, aux = t_blocks.hymba_block_fwd(_tt(p), _t(x), tcfg, desc, dict(causal=True), window)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    assert aux == {}  # no MoE FFN

    jc = j_blocks.hymba_block_cache_init(_jnp(p), jcfg, jcfg.group[0], B, L, jnp.float32)
    tc = t_blocks.hymba_block_cache_init(_tt(p), tcfg, desc, B, L, torch.float32)
    jo, jc, _ = j_blocks.hymba_block_prefill(_jnp(p), jnp.asarray(x[:, :P]), jc, jcfg,
                                             jcfg.group[0], dict(causal=True), window)
    to, tc = t_blocks.hymba_block_prefill(_tt(p), _t(x[:, :P]), tc, tcfg, desc,
                                          dict(causal=True), window)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for pos in (P, P + 1):
        jo, jc = j_blocks.hymba_block_step(_jnp(p), jnp.asarray(x[:, pos:pos + 1]), jc,
                                           jnp.asarray(pos, jnp.int32), jcfg,
                                           jcfg.group[0], window)
        to, tc = t_blocks.hymba_block_step(_tt(p), _t(x[:, pos:pos + 1]), tc, pos, tcfg,
                                           desc, window)
        np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tc["ssm"]["ssm"]), np.asarray(jc["ssm"]["ssm"]),
                               atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------- LM


@pytest.fixture(scope="module")
def jax_logits(cfgs, tree, tokens):
    """JAX's forward logits, its prefill logits and its decode logits."""
    jcfg = cfgs[0]
    params = _jnp(tree)
    full, _ = j_lm.lm_fwd(params, jnp.asarray(tokens), jcfg)
    caches = j_lm.lm_cache_init(params, jcfg, B, L, dtype=jnp.float32)
    pre, caches = j_lm.lm_prefill(params, jnp.asarray(tokens[:, :P]), caches, jcfg)
    step = jax.jit(lambda tok, c, pos: j_lm.lm_decode_step(params, tok, c, pos, jcfg))
    dec = []
    for i in range(P, L):
        lg, caches = step(jnp.asarray(tokens[:, i]), caches, jnp.asarray(i, jnp.int32))
        dec.append(np.asarray(lg[:, 0]))
    return np.asarray(full), np.asarray(pre[:, 0]), np.stack(dec, 1)


def test_lm_fwd_matches(cfgs, tree, tokens, jax_logits):
    t = t_lm.lm_fwd(from_jax_lm_params(tree, cfgs[1], device="cpu"), _t(tokens), cfgs[1])
    assert tuple(t.shape) == (B, L, 256) and t.dtype == torch.float32
    assert np.abs(jax_logits[0]).max() > 0.1
    np.testing.assert_allclose(_np(t), jax_logits[0], atol=2e-4, rtol=0)


def _port_decode(params, tokens, cfg, cache_dtype=torch.float32):
    caches = t_lm.lm_cache_init(params, cfg, B, L, dtype=cache_dtype)
    pre, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, cfg)
    dec = []
    for i in range(P, L):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches, i, cfg)
        dec.append(_np(lg[:, 0]))
    return _np(pre[:, 0]), np.stack(dec, 1), caches


def test_lm_prefill_and_decode_match(cfgs, tree, tokens, jax_logits):
    pre, dec, caches = _port_decode(from_jax_lm_params(tree, cfgs[1], device="cpu"), tokens,
                                    cfgs[1])
    np.testing.assert_allclose(pre, jax_logits[1], atol=2e-4, rtol=0)
    np.testing.assert_allclose(dec, jax_logits[2], atol=2e-4, rtol=0)
    g0 = caches["g0"]
    assert tuple(g0["kv"]["k"].shape) == (2, B, L, 2, 16)
    assert tuple(g0["ssm"]["ssm"].shape) == (2, B, 64, 8)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_decode_with_pos_as_device_data(cfgs, tree, tokens, jax_logits, dtype):
    """``pos`` as a 0-d tensor (JAX's ``pos: () int32``, traced in the
    jitted JAX step of ``jax_logits``), advanced in place as a captured
    decode advances it: the JAX decode logits within 2e-4, and the int
    ``pos`` decode's logits and caches bit for bit."""
    params = from_jax_lm_params(tree, cfgs[1], device="cpu")
    want_pre, want_dec, want_caches = _port_decode(params, tokens, cfgs[1])
    caches = t_lm.lm_cache_init(params, cfgs[1], B, L, dtype=torch.float32)
    _, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, cfgs[1])
    pos = torch.tensor(P, dtype=dtype)
    dec = []
    for i in range(P, L):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches, pos, cfgs[1])
        pos.add_(1)
        dec.append(_np(lg[:, 0]))
    dec = np.stack(dec, 1)
    np.testing.assert_allclose(dec, jax_logits[2], atol=2e-4, rtol=0)
    assert np.array_equal(dec.view(np.int32), want_dec.view(np.int32))
    for a, b in zip(jax.tree_util.tree_leaves(caches), jax.tree_util.tree_leaves(want_caches)):
        assert torch.equal(a, b)
    assert int(pos) == L


def test_port_decode_matches_port_forward(cfgs, tokens):
    """decode == forward at every position, the invariant of the JAX
    package's test_decode_matches_forward, on the port's own init."""
    cfg = cfgs[1]
    params = init_lm_params(cfg, 3, device="cpu")
    full = _np(t_lm.lm_fwd(params, _t(tokens), cfg))
    pre, dec, _ = _port_decode(params, tokens, cfg)
    np.testing.assert_allclose(pre, full[:, P - 1], atol=2e-4, rtol=0)
    np.testing.assert_allclose(dec, full[:, P:], atol=2e-4, rtol=0)
    assert np.abs(full).max() > 0.1


def test_compute_params_give_the_same_logits(cfgs, tokens):
    cfg = dataclasses.replace(cfgs[1], compute_dtype="bfloat16")
    params = init_lm_params(cfg, 4, device="cpu")
    cp = t_lm.lm_compute_params(params, cfg)
    assert cp["decoder"]["g0"]["mamba"]["in_proj"].dtype == torch.bfloat16
    assert cp["decoder"]["g0"]["mamba"]["x_proj"].dtype == torch.float32
    assert torch.equal(t_lm.lm_fwd(cp, _t(tokens), cfg), t_lm.lm_fwd(params, _t(tokens), cfg))
    a = _port_decode(cp, tokens, cfg, torch.bfloat16)
    b = _port_decode(params, tokens, cfg, torch.bfloat16)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------- bfloat16
# The main path computes in bfloat16 with a bfloat16 KV cache.  Outside the
# attention core the port follows the JAX package's casts op for op, so it
# gives the bits of JAX run op by op, but for the odd one-ulp flip where a
# matmul sums in another order (0.2 % of the elements at most, measured); a
# port that stays in float32 matches none of them, and one that casts the
# conv, SiLU, scores, probabilities or cache elsewhere changes many.  The
# JAX side runs with scan_layers=False and unjitted: XLA fuses a compiled
# layer scan and may then skip a bfloat16 rounding inside the fusion (its
# excess-precision rule), which an op run alone never does.  The core is the
# one deliberate difference: kernel B2 and its plain version keep the scores
# in float32, where JAX's naive and chunked cores round them to bfloat16.


def _bf16(cfg):
    return dataclasses.replace(cfg, compute_dtype="bfloat16", scan_layers=False)


def _from_jax(tree):
    """JAX arrays -> torch tensors of the same dtype (bfloat16 or float32)."""
    def conv(a):
        a = jnp.asarray(a)
        t = torch.from_numpy(np.array(a.astype(jnp.float32)))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t

    return jax.tree_util.tree_map(conv, tree)


def _same_bits(t, j):
    """t against j of the same dtype: 99 % of the elements equal bits, the
    rest two bfloat16 ulps (2^-6 relative: a flip in each input of a sum)
    apart or within 1e-6 of each other."""
    j = jnp.asarray(j)
    assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16 else torch.float32)
    t, j = _np(t), np.asarray(j.astype(jnp.float32))
    assert np.mean(t == j) >= 0.99
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=2.0 ** -6)


def _same_state(tc, jc):
    """Caches: the bfloat16 KV and the float32 conv state as ``_same_bits``;
    the float32 SSM state within 1e-6 (the port scans sequentially, JAX
    associatively)."""
    _same_bits(tc["kv"]["k"], jc["kv"]["k"])
    _same_bits(tc["kv"]["v"], jc["kv"]["v"])
    _same_bits(tc["ssm"]["conv"], jc["ssm"]["conv"])
    np.testing.assert_allclose(_np(tc["ssm"]["ssm"]), np.asarray(jc["ssm"]["ssm"]),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window", [0, 32])
def test_bf16_hymba_block_follows_the_jax_casts(cfgs, tree, window):
    """The forward with the naive core, the caches a prefill writes, and
    decode steps from JAX's caches, in bfloat16."""
    jcfg, tcfg = _bf16(cfgs[0]), _bf16(cfgs[1])
    jd, td = jcfg.group[0], tcfg.group[0]
    p = _layer(tree["decoder"]["g0"], 1)
    xj = jnp.asarray(_acts(11, (B, L, 64)), jnp.bfloat16)
    xt = _from_jax(xj)
    jo, _ = j_blocks.hymba_block_fwd(_jnp(p), xj, jcfg, jd, dict(causal=True, impl="naive"),
                                     window)
    _same_bits(t_blocks.hymba_block_fwd(_tt(p), xt, tcfg, td,
                                        dict(causal=True, impl="naive"), window)[0], jo)

    jc = j_blocks.hymba_block_cache_init(_jnp(p), jcfg, jd, B, L, jnp.bfloat16)
    tc = t_blocks.hymba_block_cache_init(_tt(p), tcfg, td, B, L, torch.bfloat16)
    _, jc, _ = j_blocks.hymba_block_prefill(_jnp(p), xj[:, :P], jc, jcfg, jd,
                                            dict(causal=True), window)
    _, tc = t_blocks.hymba_block_prefill(_tt(p), xt[:, :P], tc, tcfg, td, dict(causal=True),
                                         window)
    _same_state(tc, jc)
    tc = _from_jax(jc)
    for pos in range(P, L):
        jo, jc = j_blocks.hymba_block_step(_jnp(p), xj[:, pos:pos + 1], jc,
                                           jnp.asarray(pos, jnp.int32), jcfg, jd, window)
        to, tc = t_blocks.hymba_block_step(_tt(p), xt[:, pos:pos + 1], tc, pos, tcfg, td,
                                           window)
        _same_bits(to, jo)
    _same_state(tc, jc)


def test_bf16_lm_decode_follows_the_jax_casts(cfgs, tree, tokens):
    """Greedy-decode steps of the whole LM (embedding, both layers, final
    norm, head) from JAX's bfloat16 prefill caches."""
    jcfg, tcfg = _bf16(cfgs[0]), _bf16(cfgs[1])
    jp = _jnp(tree)
    jc = j_lm.lm_cache_init(jp, jcfg, B, L, dtype=jnp.bfloat16)
    _, jc = j_lm.lm_prefill(jp, jnp.asarray(tokens[:, :P]), jc, jcfg)
    tc = _from_jax(jc)
    tp = from_jax_lm_params(tree, tcfg, device="cpu")
    for i in range(P, L):
        jl, jc = j_lm.lm_decode_step(jp, jnp.asarray(tokens[:, i]), jc,
                                     jnp.asarray(i, jnp.int32), jcfg)
        tl, tc = t_lm.lm_decode_step(tp, _t(tokens[:, i]), tc, i, tcfg)
        _same_bits(tl, jl)
    for g in range(2):
        _same_state(jax.tree_util.tree_map(lambda a: a[g], tc["g0"]),
                    jax.tree_util.tree_map(lambda a: a[g], jc["g0"]))


def test_bf16_lm_fwd_and_prefill_match(cfgs, tree, tokens):
    """The whole bfloat16 forward and prefill against JAX's (naive and
    chunked cores): the float32 scores of B2 against JAX's bfloat16 scores
    move the logits by about 1.2e-2 relative L2 at this size, so they are
    held at 3e-2.  This bound checks the path as a whole; the casts are
    held by the two tests above."""
    jcfg, tcfg = _bf16(cfgs[0]), _bf16(cfgs[1])
    jp, tp = _jnp(tree), from_jax_lm_params(tree, tcfg, device="cpu")
    jf, _ = j_lm.lm_fwd(jp, jnp.asarray(tokens), jcfg)
    tf = t_lm.lm_fwd(tp, _t(tokens), tcfg)
    jc = j_lm.lm_cache_init(jp, jcfg, B, L, dtype=jnp.bfloat16)
    jl, _ = j_lm.lm_prefill(jp, jnp.asarray(tokens[:, :P]), jc, jcfg)
    tl, _ = t_lm.lm_prefill(tp, _t(tokens[:, :P]),
                            t_lm.lm_cache_init(tp, tcfg, B, L, dtype=torch.bfloat16), tcfg)
    for t, j in ((tf, jf), (tl, jl)):
        assert t.dtype == torch.bfloat16
        j = np.asarray(j.astype(jnp.float32))
        assert np.linalg.norm(_np(t) - j) <= 3e-2 * np.linalg.norm(j)


# ------------------------------------------------------------------ weights


def _edit(tree, path, value):
    out = jax.tree_util.tree_map(lambda a: a, tree)
    node = out
    for k in path[:-1]:
        node = node[k]
    if value is None:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return out


@pytest.mark.parametrize("path,value,match", [
    (("decoder", "g0", "mamba", "A_log"), None, "expected keys"),
    (("decoder", "g0", "mamba", "extra"), np.zeros(3, np.float32), "expected keys"),
    (("head",), None, "expected keys"),
    (("decoder", "g0", "mamba", "x_proj"), np.zeros((2, 64, 19), np.float32),
     "expected shape"),
    (("embed", "table"), np.zeros((255, 64), np.float32), "expected shape"),
])
def test_from_jax_lm_params_refuses_wrong_keys_and_shapes(cfgs, tree, path, value, match):
    with pytest.raises(ValueError, match=match):
        from_jax_lm_params(_edit(tree, path, value), cfgs[1], device="cpu")


def test_from_jax_lm_params_converts_every_leaf(cfgs, tree):
    params = from_jax_lm_params(tree, cfgs[1], device="cpu")
    np.testing.assert_array_equal(_np(params["decoder"]["g0"]["mamba"]["dt_bias"]),
                                  tree["decoder"]["g0"]["mamba"]["dt_bias"])
    assert params["head"]["w"].dtype == torch.float32


def test_init_lm_params(cfgs):
    cfg = cfgs[1]
    params = init_lm_params(cfg, 0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    assert shapes == lm_param_shapes(cfg)
    m = params["decoder"]["g0"]["mamba"]
    torch.testing.assert_close(m["A_log"][1, 7], torch.log(torch.arange(1.0, 9.0)))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    for leaf in (m["conv_b"], m["dt_bias"], params["final_norm"]["scale"],
                 params["decoder"]["g0"]["mix_norm"]["scale"]):
        assert leaf.abs().min() > 0
    again = init_lm_params(cfg, 0, device="cpu")
    assert torch.equal(again["head"]["w"], params["head"]["w"])
    assert not torch.equal(init_lm_params(cfg, 1, device="cpu")["head"]["w"],
                           params["head"]["w"])


def test_lm_entry_points_run_on_cuda_unless_asked(cfgs, tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm_params(cfgs[1], 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_lm_params(tree, cfgs[1])


def _group(*descs):
    from repro_torch.configs.base import BlockDesc

    return dict(group=tuple(BlockDesc(*d) for d in descs))


@pytest.mark.parametrize("change", [_group(("mlstm", 0, None, True)),
                                    _group(("slstm", 0, None, True)),
                                    _group(("attn", 0, None, True)),
                                    _group(("hymba", 0, None, True))])
def test_lm_refuses_what_is_not_ported(cfgs, tokens, change):
    """MoE FFNs on the blocks no arch has them in (embedding scales,
    sinusoidal positions, frames, tied embeddings and the xlstm blocks are
    ported since; see test_torch_lm_dense.py, test_torch_lm_xattn_frames.py
    and test_torch_xlstm.py).  The attn block's MoE FFN is ported (see
    test_torch_moe.py), and so is its loss (the router's aux term added;
    see test_torch_moe_train.py): ``lm_loss`` runs it."""
    cfg = dataclasses.replace(cfgs[1], **change)
    if cfg.group[0].kind == "attn":
        cfg = dataclasses.replace(cfg, n_experts=4, top_k=2)
        params = init_lm_params(cfg, 0, device="cpu")
        loss, metrics = t_lm.lm_loss(params, {"tokens": _t(tokens), "labels": _t(tokens)},
                                     cfg)
        assert torch.isfinite(loss) and metrics["moe_aux"].item() > 0
        assert torch.allclose(loss, metrics["nll"] + cfg.router_aux_weight * metrics["moe_aux"])
        return
    params = init_lm_params(cfgs[1], 0, device="cpu")
    with pytest.raises(NotImplementedError):
        t_lm.lm_fwd(params, _t(tokens), cfg)


def test_decoder_refuses_missing_parts_and_window_lists(cfgs, monkeypatch):
    """A block with no cache_init (every ported block has all four
    functions, so a forward-only stub is registered), and a window list of
    the wrong length."""
    from repro_torch.configs.base import BlockDesc
    from repro_torch.models import blocks as t_blocks
    from repro_torch.models.decoder import decoder_cache_init, decoder_fwd

    cfg = cfgs[1]
    params = init_lm_params(cfg, 0, device="cpu")
    monkeypatch.setitem(t_blocks.BLOCKS, "fwd_only", t_blocks.Block(t_blocks.attn_block_fwd))
    stub = dataclasses.replace(cfg, group=(BlockDesc("fwd_only"),))
    with pytest.raises(NotImplementedError, match="cache_init"):
        decoder_cache_init(params["decoder"], stub, B, 8)
    three = dataclasses.replace(cfg, group=(BlockDesc("hymba", window_per_repeat=(0, 4, 4)),))
    with pytest.raises(ValueError, match="per-repeat windows"):
        decoder_fwd(params["decoder"], torch.zeros(B, 4, 64), three, dict(causal=True))
