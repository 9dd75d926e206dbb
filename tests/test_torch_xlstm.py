"""The port's xlstm-125m path against the JAX package on its ``reduced``
config (2 repeats of the (mlstm, slstm) group, d_model 64, 4 heads:
mLSTM heads of 32 over din 128, sLSTM heads of 16 and an FFN of 85),
float32: the mLSTM cell chunkwise (one chunk, and chunks of 8 over L 20,
which carries the state across chunks and pads the last), its decode
step, the sLSTM cell and its step, both blocks' four functions (the
prefill and the step writing the state into a view of a stacked cache),
``lm_fwd``, ``lm_prefill`` + ``lm_decode_step`` with ``pos`` as device
data; and, in bfloat16, the cast rule of ``lm_compute_params`` (mLSTM's
q, k, v and gate weights and sLSTM's gates stay float32).

The params are drawn with numpy from a seed in the JAX init's tree, with
the gates' weights and the biases larger than the JAX init draws them (so
the stabilizer and the gates move) and no leaf zero.  Tolerances as
tests/test_torch_lm.py: 1e-5 on single layers, 2e-4 on logits.
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
from repro.nn import ssm as j_ssm
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import blocks as t_blocks
from repro_torch.models import lm as t_lm
from repro_torch.nn import ssm as t_ssm
from repro_torch.nn.layers import cast_leaves
from repro_torch.weights import from_jax_lm_params, init_lm_params, lm_param_shapes

NAME = "xlstm-125m"
B, L, P = 2, 24, 16
_STD = {"scale": 0.3, "conv_b": 0.3, "b_i": 0.5, "b_gates": 0.3, "w_i": 0.2, "w_f": 0.2,
        "conv_w": 0.3, "r_gates": 0.2, "table": 0.02, "w": 0.02}


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
    """Leaves in key order: normal * ``_STD`` where listed (``b_f`` 3 +
    normal * 0.3), else lecun-normal (all axes but the last and the stacked
    layers axis)."""
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, k, stacked or k == "decoder") for k, v in shapes.items()}
    a = rng.standard_normal(shapes).astype(np.float32)
    if key == "b_f":
        return np.float32(3.0) + a * np.float32(0.3)
    if key in _STD:
        return a * np.float32(_STD[key])
    return a / np.float32(np.sqrt(np.prod(shapes[int(stacked):-1])))


@pytest.fixture(scope="module")
def cfgs():
    return j_reduced(j_get_config(NAME)), reduced(get_config(NAME))


@pytest.fixture(scope="module")
def tree(cfgs):
    return _draw(lm_param_shapes(cfgs[1]), np.random.default_rng(300))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(6).integers(0, 256, (B, L))


def _cell(tree, g, r=1):
    return _layer(tree["decoder"][g]["cell"], r)


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=tol, rtol=tol)


def _close_state(ts, js, tol=1e-5):
    assert set(ts) == set(js)
    for k in js:
        _close(ts[k], js[k], tol)


# ------------------------------------------------------------------ cells


@pytest.mark.parametrize("chunk", [20, 8])
@pytest.mark.parametrize("return_state", [False, True])
def test_mlstm_fwd_matches(cfgs, tree, chunk, return_state):
    """L 20 at chunk 20 (the full parallel form) and chunk 8 (three chunks,
    the last padded by 4 steps that must leave the state as it is)."""
    jcfg, tcfg = cfgs
    p, x = _cell(tree, "g0"), _acts(20, (B, 20, 64))
    j = j_ssm.mlstm_fwd(_jnp(p), jnp.asarray(x), jcfg, return_state=return_state,
                        chunk=chunk)
    t = t_ssm.mlstm_fwd(_tt(p), _t(x), tcfg, return_state=return_state, chunk=chunk)
    if not return_state:
        _close(t, j)
        return
    _close(t[0], j[0])
    _close_state(t[1], j[1])
    assert tuple(t[1]["C"].shape) == (B, 4, 32, 32) and tuple(t[1]["conv"].shape) == (B, 3,
                                                                                       128)


def test_mlstm_fwd_pads_without_moving_the_state(cfgs, tree):
    """Chunks of 8 over 20 positions (padded) give the state of the
    unpadded chunk-20 run, and both the output of a chunk-4 run."""
    tcfg = cfgs[1]
    p, x = _tt(_cell(tree, "g0")), _t(_acts(21, (B, 20, 64)))
    o20, s20 = t_ssm.mlstm_fwd(p, x, tcfg, return_state=True, chunk=20)
    o8, s8 = t_ssm.mlstm_fwd(p, x, tcfg, return_state=True, chunk=8)
    o4 = t_ssm.mlstm_fwd(p, x, tcfg, chunk=4)
    for a in (o8, o4):
        torch.testing.assert_close(a, o20, atol=1e-5, rtol=1e-5)
    for k in s20:
        torch.testing.assert_close(s8[k], s20[k], atol=1e-5, rtol=1e-5)


def _prefilled(cfgs, tree, g, fwd_name):
    """(port params, x, JAX state after a prefill of P positions)."""
    jcfg = cfgs[0]
    p, x = _cell(tree, g), _acts(22, (B, L, 64))
    _, js = getattr(j_ssm, fwd_name)(_jnp(p), jnp.asarray(x[:, :P]), jcfg, return_state=True)
    return p, x, js


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_step_matches_from_a_prefilled_state(cfgs, tree, cell):
    """Decode steps P..L-1 from JAX's prefilled state: the output and the
    state after each step."""
    jcfg, tcfg = cfgs
    g = "g0" if cell == "mlstm" else "g1"
    p, x, js = _prefilled(cfgs, tree, g, f"{cell}_fwd")
    j_step = jax.jit(lambda p, x, s: getattr(j_ssm, f"{cell}_step")(p, x, s, jcfg))
    ts = _tt(js)
    for pos in range(P, L):
        jo, js = j_step(_jnp(p), jnp.asarray(x[:, pos:pos + 1]), js)
        to, ts = getattr(t_ssm, f"{cell}_step")(_tt(p), _t(x[:, pos:pos + 1]), ts, tcfg)
        _close(to, jo)
        _close_state(ts, js)


@pytest.mark.parametrize("return_state", [False, True])
def test_slstm_fwd_matches(cfgs, tree, return_state):
    jcfg, tcfg = cfgs
    p, x = _cell(tree, "g1"), _acts(23, (B, 20, 64))
    j = j_ssm.slstm_fwd(_jnp(p), jnp.asarray(x), jcfg, return_state=return_state)
    t = t_ssm.slstm_fwd(_tt(p), _t(x), tcfg, return_state=return_state)
    if not return_state:
        _close(t, j)
        return
    _close(t[0], j[0])
    _close_state(t[1], j[1])
    assert tuple(t[1]["m"].shape) == (B, 4, 16)


# ----------------------------------------------------------------- blocks


@pytest.mark.parametrize("kind,g", [("mlstm", "g0"), ("slstm", "g1")])
def test_block_matches(cfgs, tree, kind, g):
    """fwd; cache_init (zeros, m = -inf, on the params' device); prefill
    into layer 1's view of a cache stacked over two layers (layer 0 left
    untouched); steps P..L-1 against JAX's from its prefill."""
    jcfg, tcfg = cfgs
    jfns = [getattr(j_blocks, f"{kind}_block_{part}")
            for part in ("fwd", "cache_init", "prefill", "step")]
    tb = t_blocks.BLOCKS[kind]
    jd, td = jcfg.group[int(g[1])], tcfg.group[int(g[1])]
    p = _layer(tree["decoder"][g], 1)
    x = _acts(24, (B, L, 64))
    jo, _ = jfns[0](_jnp(p), jnp.asarray(x), jcfg, jd, dict(causal=True), 0)
    to, aux = tb.fwd(_tt(p), _t(x), tcfg, td, dict(causal=True), 0)
    _close(to, jo)
    assert aux == {}

    jc = jfns[1](_jnp(p), jcfg, jd, B, L, jnp.float32)
    one = tb.cache_init(_tt(p), tcfg, td, B, L, torch.float32)
    _close_state(one, jc, 0)
    assert all(v.dtype == torch.float32 for v in one.values())
    stacked = {k: torch.stack([torch.full_like(v, 7.0), v]) for k, v in one.items()}
    view = {k: v[1] for k, v in stacked.items()}
    jo, jc, _ = jfns[2](_jnp(p), jnp.asarray(x[:, :P]), jc, jcfg, jd, dict(causal=True), 0)
    to, tc = tb.prefill(_tt(p), _t(x[:, :P]), view, tcfg, td, dict(causal=True), 0)
    _close(to, jo)
    _close_state({k: v[1] for k, v in stacked.items()}, jc)
    assert all(bool((v[0] == 7.0).all()) for v in stacked.values())
    j_step = jax.jit(lambda p, x, c, pos: jfns[3](p, x, c, pos, jcfg, jd, 0))
    for pos in range(P, L):
        jo, jc = j_step(_jnp(p), jnp.asarray(x[:, pos:pos + 1]), jc,
                        jnp.asarray(pos, jnp.int32))
        to, tc = tb.step(_tt(p), _t(x[:, pos:pos + 1]), view, pos, tcfg, td, 0)
        _close(to, jo)
    _close_state({k: v[1] for k, v in stacked.items()}, jc)


# --------------------------------------------------------------------- LM


@pytest.fixture(scope="module")
def jax_logits(cfgs, tree, tokens):
    """JAX's forward logits, its prefill logits and its decode logits."""
    jcfg = cfgs[0]
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


def test_lm_fwd_matches(cfgs, tree, tokens, jax_logits):
    tcfg = cfgs[1]
    t = t_lm.lm_fwd(from_jax_lm_params(tree, tcfg, device="cpu"), _t(tokens), tcfg)
    assert tuple(t.shape) == (B, L, 256) and t.dtype == torch.float32
    assert np.abs(jax_logits[0]).max() > 0.1
    np.testing.assert_allclose(_np(t), jax_logits[0], atol=2e-4, rtol=0)


def test_lm_prefill_and_decode_match(cfgs, tree, tokens, jax_logits):
    """Prefill and decode steps against JAX's, ``pos`` one 0-d int32 tensor
    advanced in place (a captured step's form); the caches are the
    decoder's stacked ones, written through each layer's view."""
    tcfg = cfgs[1]
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    caches = t_lm.lm_cache_init(params, tcfg, B, L, dtype=torch.float32)
    assert tuple(caches["g0"]["C"].shape) == (2, B, 4, 32, 32)
    assert bool(torch.isinf(caches["g1"]["m"]).all())
    pre, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, tcfg)
    np.testing.assert_allclose(_np(pre[:, 0]), jax_logits[1], atol=2e-4, rtol=0)
    pos = torch.tensor(P, dtype=torch.int32)
    dec = []
    for i in range(P, L):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches, pos, tcfg)
        pos.add_(1)
        dec.append(_np(lg[:, 0]))
    np.testing.assert_allclose(np.stack(dec, 1), jax_logits[2], atol=2e-4, rtol=0)
    assert torch.isfinite(caches["g1"]["m"]).all()


def test_port_decode_matches_port_forward(cfgs, tokens):
    """decode == forward at every position, on the port's own init."""
    cfg = cfgs[1]
    params = init_lm_params(cfg, 3, device="cpu")
    full = _np(t_lm.lm_fwd(params, _t(tokens), cfg))
    caches = t_lm.lm_cache_init(params, cfg, B, L, dtype=torch.float32)
    pre, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, cfg)
    dec = [_np(pre[:, 0])]
    for i in range(P, L - 1):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches, i, cfg)
        dec.append(_np(lg[:, 0]))
    np.testing.assert_allclose(np.stack(dec, 1), full[:, P - 1:L - 1], atol=2e-4, rtol=0)


# --------------------------------------------------------------- bfloat16


def _bf16_decode(params, cfg, tokens):
    caches = t_lm.lm_cache_init(params, cfg, B, L, dtype=torch.bfloat16)
    pre, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, cfg)
    rows = [pre[:, 0]]
    for i in range(P, L):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches, i, cfg)
        rows.append(lg[:, 0])
    return torch.stack(rows, 1)


def test_compute_params_keep_the_cells_float32_leaves(cfgs, tokens):
    """In bfloat16, ``lm_compute_params`` casts the cells' projections only:
    the decode logits from the cast params equal those from the uncast ones
    bit for bit, as do the forward's.  Casting by leaf name alone (mLSTM's
    wq, wk, wv too, which its decode step reads in float32) changes them."""
    cfg = dataclasses.replace(cfgs[1], compute_dtype="bfloat16")
    params = init_lm_params(cfg, 4, device="cpu")
    cp = t_lm.lm_compute_params(params, cfg)
    m, s = cp["decoder"]["g0"]["cell"], cp["decoder"]["g1"]["cell"]
    for leaf in ("up_proj", "down_proj"):
        assert m[leaf].dtype == s[leaf].dtype == torch.bfloat16
    assert s["gate_proj"].dtype == torch.bfloat16
    for leaf in ("wq", "wk", "wv", "conv_w", "w_i", "w_f", "b_f"):
        assert m[leaf].dtype == torch.float32
    for leaf in ("w_gates", "r_gates", "b_gates"):
        assert s[leaf].dtype == torch.float32
    assert cp["head"]["w"].dtype == cp["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(t_lm.lm_fwd(cp, _t(tokens), cfg), t_lm.lm_fwd(params, _t(tokens), cfg))
    ref = _bf16_decode(params, cfg, tokens)
    assert torch.equal(_bf16_decode(cp, cfg, tokens), ref)
    by_name = cast_leaves(params, t_lm._COMPUTE_LEAVES, torch.bfloat16)
    assert by_name["decoder"]["g0"]["cell"]["wq"].dtype == torch.bfloat16
    assert not torch.equal(_bf16_decode(by_name, cfg, tokens), ref)


def test_a_leaf_cast_alone_follows_its_path(cfgs):
    """A subtree cast alone (chip_smoke.py's leaf-by-leaf cast) takes the
    rule of its place in the tree."""
    cfg = dataclasses.replace(cfgs[1], compute_dtype="bfloat16")
    wq = torch.ones(3)
    cell = ("decoder", "g0", "cell")
    assert t_lm.lm_compute_params({"wq": wq}, cfg, cell)["wq"].dtype == torch.float32
    assert t_lm.lm_compute_params({"up_proj": wq}, cfg, cell)["up_proj"].dtype == \
        torch.bfloat16
    assert t_lm.lm_compute_params({"wq": wq}, cfg, ("decoder", "g0", "attn"))["wq"].dtype \
        == torch.bfloat16


def test_init_lm_params_law(cfgs):
    """The random init: the tree of the JAX init, no leaf zero, mLSTM's
    forget bias near 3."""
    cfg = cfgs[1]
    params = init_lm_params(cfg, 0, device="cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == lm_param_shapes(cfg)
    for leaf in jax.tree_util.tree_leaves(params):
        assert leaf.abs().min() > 0
    b_f = params["decoder"]["g0"]["cell"]["b_f"]
    assert 2.5 < float(b_f.min()) and float(b_f.max()) < 3.5
    assert 0.03 < float(params["decoder"]["g1"]["cell"]["r_gates"].std()) < 0.07
