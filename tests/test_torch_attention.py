"""The port's layers, FFN and attention against the JAX package at small
size, float32.  On the CPU ``flash_mha`` is the kernel's plain version; the
JAX package's Pallas kernel runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.flash_attention.ops import flash_mha as j_flash_mha
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.nn import attention as j_attn
from repro.nn import ffn as j_ffn
from repro.nn import layers as j_layers
from repro.nn.param import unbox
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha
from repro_torch.nn import attention as t_attn
from repro_torch.nn import ffn as t_ffn
from repro_torch.nn import layers as t_layers


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_layers.rmsnorm_apply({"scale": _t(scale)}, _t(x))),
        _np(j_layers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=1e-6, rtol=1e-6)
    w, b = (rng.standard_normal(s).astype(np.float32) for s in ((16, 7), (7,)))
    np.testing.assert_allclose(
        _np(t_layers.dense_apply({"w": _t(w), "b": _t(b)}, _t(x))),
        _np(j_layers.dense_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x))), atol=1e-5)
    for dim in (64, 9):
        # cos/sin of float32 arguments up to 5000 rad: the two libraries'
        # range reductions differ in the last bits
        pos = np.array([0.0, 1.5, 37.0, 5000.0], np.float32)
        np.testing.assert_allclose(
            _np(t_layers.sinusoidal_embed(_t(pos), dim)),
            _np(j_layers.sinusoidal_embed(jnp.asarray(pos), dim)), atol=1e-5)


def test_ffn_matches():
    rng = np.random.default_rng(1)
    p = {"w_up": rng.standard_normal((16, 32)), "w_down": rng.standard_normal((32, 16)),
         "w_gate": rng.standard_normal((16, 32))}
    p = {k: (v / 4).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_ffn.ffn_apply({k: _t(v) for k, v in p.items()}, _t(x))),
        _np(j_ffn.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)


ATTN_CASES = {
    "full": dict(causal=False, window=0, softcap=0.0),
    "causal": dict(causal=True, window=0, softcap=0.0),
    "window": dict(causal=True, window=7, softcap=0.0),
    "window-noncausal": dict(causal=False, window=9, softcap=0.0),
    "softcap": dict(causal=True, window=0, softcap=5.0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_matches_pallas_interpret_and_references(case):
    """Ragged L = 40 with 16-row blocks: the Pallas kernel pads and masks."""
    opts = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    B, L, H, hd = 2, 40, 3, 16
    q, k, v = (rng.standard_normal((B, L, H, hd)).astype(np.float32) for _ in range(3))
    out = _np(flash_mha(_t(q), _t(k), _t(v), **opts))  # CPU: the plain version
    np.testing.assert_allclose(out, _np(attention_plain(_t(q), _t(k), _t(v), **opts)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = j_flash_mha(jq, jk, jv, block_q=16, block_k=16, **opts)
    np.testing.assert_allclose(out, _np(pallas), atol=1e-5, rtol=0)
    flat = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, L, hd)
    ref = j_attention_ref(flat(jq), flat(jk), flat(jv), **opts)
    np.testing.assert_allclose(out, _np(ref).reshape(B, H, L, hd).transpose(0, 2, 1, 3),
                               atol=1e-5, rtol=0)
    pos = jnp.arange(L)
    mask = j_attn.attn_mask(pos, pos, opts["causal"], opts["window"])
    naive = j_attn.attn_core_naive(jq, jk, jv, mask, opts["softcap"])
    np.testing.assert_allclose(out, _np(naive), atol=1e-5, rtol=0)
    t_mask = t_attn.attn_mask(L, L, opts["causal"], opts["window"], "cpu")
    np.testing.assert_allclose(
        _np(t_attn.attn_core_naive(_t(q), _t(k), _t(v), t_mask, opts["softcap"])),
        _np(naive), atol=1e-5, rtol=0)


def test_plain_attention_masks_a_padded_key_tail():
    rng = np.random.default_rng(2)
    q, k, v = (_t(rng.standard_normal((1, 12, 2, 8)).astype(np.float32)) for _ in range(3))
    short = attention_plain(q, k[:, :9], v[:, :9], causal=False)
    padded = attention_plain(q, k, v, causal=False, true_seq_k=9)
    torch.testing.assert_close(padded, short)


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 5), (True, 3)])
def test_attn_fwd_gqa_bias_matches(impl, causal, window):
    kw = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=1, qkv_bias=True, pos_embed="none",
              compute_dtype="float32")
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    p = unbox(j_attn.attn_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    p = {k: np.array(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    jo = j_attn.attn_fwd({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                         jcfg, causal=causal, window=window)
    to = t_attn.attn_fwd({k: _t(v) for k, v in p.items()}, _t(x), tcfg,
                         causal=causal, window=window, impl=impl)
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5, rtol=1e-5)
