"""The port's denoiser, its weight converter and its random init against
the JAX package at small size (float32 unless stated)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.models.diffusion import denoiser_fwd as j_denoiser_fwd
from repro.models.diffusion import denoiser_init, make_ddpm_model_fn as j_make_ddpm
from repro.models.diffusion import make_sl_model_fn as j_make_sl
from repro.nn.param import unbox
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.configs.registry import paper_pixel_dit
from repro_torch.models.diffusion import make_ddpm_model_fn as t_make_ddpm
from repro_torch.models.diffusion import denoiser_fwd as t_denoiser_fwd
from repro_torch.models.diffusion import make_sl_model_fn as t_make_sl
from repro_torch.weights import from_jax_params, init_denoiser_params, param_shapes


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturbed_tree(seed=0, out_scale=0.05):
    """JAX params with nonzero out_proj and norm scales (its init zeroes
    both, which would hide a missing (1 + scale) and make every output 0)."""
    tree = jax.tree_util.tree_map(np.array, unbox(denoiser_init(jax.random.PRNGKey(seed),
                                                                j_smoke())))
    rng = np.random.default_rng(seed + 100)
    tree["out_proj"] = (out_scale * rng.standard_normal(tree["out_proj"].shape)
                        ).astype(np.float32)
    tree["final_norm"]["scale"] = (0.3 * rng.standard_normal(64)).astype(np.float32)
    for name in ("attn_norm", "ffn_norm"):
        leaf = tree["decoder"]["g0"][name]
        leaf["scale"] = (0.3 * rng.standard_normal(leaf["scale"].shape)).astype(np.float32)
    return tree


def _bf16(dc):
    return dataclasses.replace(dc, backbone=dataclasses.replace(
        dc.backbone, compute_dtype="bfloat16"))


@pytest.mark.parametrize("impl", ["flash", "naive"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_fwd_through_from_jax_params_matches(impl, dtype):
    jdc, tdc = j_smoke(), t_smoke()
    if dtype == "bfloat16":
        jdc, tdc = _bf16(jdc), _bf16(tdc)
    tree = _perturbed_tree()
    rng = np.random.default_rng(4)
    t = rng.uniform(0.05, 20.0, (3,)).astype(np.float32)
    y = rng.standard_normal((3, 8, 4)).astype(np.float32)
    jo = _np(j_denoiser_fwd(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(t),
                            jnp.asarray(y), jdc))
    params = from_jax_params(tree, tdc, device="cpu")
    to = _np(t_denoiser_fwd(params, _t(t), _t(y), tdc, attn_impl=impl))
    assert np.abs(jo).max() > 0.1  # out_proj and the norms really act
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    else:
        # both compute in bf16 (8 mantissa bits) but round at other places:
        # XLA fuses and keeps some intermediates in float32, PyTorch rounds
        # after each op; outputs here are O(1), so 2e-2 is a few bf16 ulps
        np.testing.assert_allclose(to, jo, atol=2e-2, rtol=0)


def test_model_fns_match():
    jdc, tdc = j_smoke(), t_smoke()
    tree = _perturbed_tree(1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = from_jax_params(tree, tdc, device="cpu")
    rng = np.random.default_rng(5)
    t = rng.uniform(0.0, 30.0, (4,)).astype(np.float32)
    y = rng.standard_normal((4, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        _np(t_make_sl(params, tdc)(_t(t), _t(y))),
        _np(j_make_sl(jparams, jdc)(jnp.asarray(t), jnp.asarray(y))), atol=1e-5, rtol=1e-5)
    steps = np.array([0.0, 3.0, 7.0, 11.0], np.float32)
    np.testing.assert_allclose(
        _np(t_make_ddpm(params, tdc)(_t(steps), _t(y))),
        _np(j_make_ddpm(jparams, jdc)(jnp.asarray(steps), jnp.asarray(y))),
        atol=1e-5, rtol=1e-5)


def test_from_jax_params_checks_keys_and_shapes():
    tdc = t_smoke()
    tree = _perturbed_tree()
    bad = dict(tree, out_proj=tree["out_proj"][:, :2])
    with pytest.raises(ValueError, match="out_proj"):
        from_jax_params(bad, tdc, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "t_mlp2"}
    with pytest.raises(ValueError, match="expected keys"):
        from_jax_params(missing, tdc, device="cpu")


def test_init_denoiser_params_layout_and_nonzero_leaves():
    tdc = t_smoke()
    params = init_denoiser_params(tdc, 3, device="cpu")
    jtree = unbox(denoiser_init(jax.random.PRNGKey(0), j_smoke()))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == shapes
    assert param_shapes(tdc) == shapes
    assert params["out_proj"].abs().min() > 0
    assert params["decoder"]["g0"]["ffn_norm"]["scale"].abs().max() > 0
    again = init_denoiser_params(tdc, 3, device="cpu")
    assert torch.equal(again["decoder"]["g0"]["attn"]["wq"],
                       params["decoder"]["g0"]["attn"]["wq"])
    full = param_shapes(paper_pixel_dit())
    assert full["decoder"]["g0"]["attn"]["wq"] == (24, 1024, 16, 64)
