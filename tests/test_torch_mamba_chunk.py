"""The port's chunked ``mamba_fwd`` on the reduced hymba-1.5b (float32): any
chunk gives the bits of one scan over all of L (the carry folded into a
chunk's first drive keeps the plain loop's roundings), with one scan call
a chunk and no scan input longer than the chunk; its final state and its
gradient against the unchunked run; against the JAX package's chunked
mixer at the same chunks; and the hymba block at L > 1024 (two of its
default chunks) against the JAX block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.models import blocks as j_blocks
from repro.nn import ssm as j_ssm
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import blocks as t_blocks
from repro_torch.nn import ssm as t_ssm
from repro_torch.weights import init_lm_params

B, L = 2, 29


def _np(x):
    return x.detach().float().numpy()


@pytest.fixture(scope="module")
def layer():
    """(port config, JAX config, the port's layer-1 params of the first
    hymba block (float32), an input (B, L, d))."""
    cfg, jcfg = reduced(get_config("hymba-1.5b")), j_reduced(j_get_config("hymba-1.5b"))
    params = init_lm_params(cfg, 0, device="cpu")["decoder"]["g0"]
    block = {k: {n: v[1] for n, v in sub.items()} for k, sub in params.items()}
    x = torch.randn(B, L, cfg.d_model, generator=torch.Generator().manual_seed(3))
    return cfg, jcfg, block, x


@pytest.mark.parametrize("chunk", [4, 7, L, 1024])
def test_any_chunk_gives_the_unchunked_bits(layer, chunk, monkeypatch):
    cfg, _, block, x = layer
    whole, whole_state = t_ssm.mamba_fwd(block["mamba"], x, cfg, return_state=True,
                                         chunk=1 << 20)
    shapes = []
    scan = t_ssm.linear_scan
    monkeypatch.setattr(t_ssm, "linear_scan",
                        lambda a, b: shapes.append(tuple(a.shape)) or scan(a, b))
    out, state = t_ssm.mamba_fwd(block["mamba"], x, cfg, return_state=True, chunk=chunk)
    assert torch.equal(out, whole)
    assert torch.equal(state["ssm"], whole_state["ssm"])
    assert torch.equal(state["conv"], whole_state["conv"])
    D = cfg.d_inner * cfg.ssm_state
    n = -(-L // chunk)
    assert shapes == [(B, min(chunk, L - i * chunk), D) for i in range(n)]


def test_the_chunk_must_be_positive(layer):
    cfg, _, block, x = layer
    with pytest.raises(ValueError, match="chunk"):
        t_ssm.mamba_fwd(block["mamba"], x, cfg, chunk=0)


def test_the_gradient_flows_through_the_carry(layer):
    """Autograd through chunks of 4 (the carry into each chunk included)
    against autograd through one scan, for the input and every leaf, within
    1e-5 of each gradient's scale: the backward sums the carry's share into
    the gradient at another place than one scan does."""
    cfg, _, block, x = layer
    w = torch.randn(B, L, cfg.d_model, generator=torch.Generator().manual_seed(4))
    grads = []
    for chunk in (4, 1 << 20):
        p = {k: v.clone().requires_grad_() for k, v in block["mamba"].items()}
        xi = x.clone().requires_grad_()
        (t_ssm.mamba_fwd(p, xi, cfg, chunk=chunk) * w).sum().backward()
        grads.append({"x": xi.grad, **{k: v.grad for k, v in p.items()}})
    for name, g in grads[1].items():
        scale = g.abs().max().item()
        assert scale > 0, name
        np.testing.assert_allclose(_np(grads[0][name]), _np(g), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", [4, 16])
def test_the_chunked_mixer_matches_jax(layer, chunk):
    """The JAX mixer at the same chunk (it pads its last chunk and
    recomputes the final state; the port's last chunk is just shorter)."""
    cfg, jcfg, block, x = layer
    jp = {k: jnp.asarray(_np(v)) for k, v in block["mamba"].items()}
    jo, js = jax.jit(lambda p, x: j_ssm.mamba_fwd(p, x, jcfg, return_state=True,
                                                  chunk=chunk))(jp, jnp.asarray(_np(x)))
    to, ts = t_ssm.mamba_fwd(block["mamba"], x, cfg, return_state=True, chunk=chunk)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(ts[name]), np.asarray(js[name]), atol=1e-5, rtol=1e-5)


def test_the_hymba_block_past_one_chunk_matches_jax(layer, monkeypatch):
    """The block at L 1030 (full attention, the mixer at its default chunk
    of 1024: two scans) against the JAX block, within 1e-4 (float32 sums
    over 1030 keys in other orders)."""
    cfg, jcfg, block, _ = layer
    desc, jdesc = cfg.group[0], jcfg.group[0]
    x = torch.randn(1, 1030, cfg.d_model, generator=torch.Generator().manual_seed(5))
    jp = jax.tree_util.tree_map(lambda v: jnp.asarray(_np(v)), block)
    jo, _ = jax.jit(lambda p, x: j_blocks.hymba_block_fwd(p, x, jcfg, jdesc,
                                                          dict(causal=True), 0))(
        jp, jnp.asarray(_np(x)))
    calls = []
    scan = t_ssm.linear_scan
    monkeypatch.setattr(t_ssm, "linear_scan",
                        lambda a, b: calls.append(a.shape[1]) or scan(a, b))
    to, _ = t_blocks.hymba_block_fwd(block, x, cfg, desc, dict(causal=True), 0)
    assert calls == [1024, 6]
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-4, rtol=1e-4)
