"""The slice as a whole: ASD sampling of the smoke denoiser through the
port against the JAX package, with the same weights and the same noise."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import asd as j_asd
from repro.core import schedules as j_sch
from repro.models.diffusion import denoiser_init, make_sl_model_fn as j_make_sl
from repro.nn.param import unbox
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import asd as t_asd
from repro_torch.core import schedules as t_sch
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.grs.ops import grs
from repro_torch.models.diffusion import make_sl_model_fn as t_make_sl
from repro_torch.weights import from_jax_params

K, THETA, CHAINS = 16, 4, 3


def _tree():
    """JAX init with out_proj and the norm scales made nonzero: with the
    init's zero out_proj every speculation would be accepted."""
    tree = jax.tree_util.tree_map(
        np.array, unbox(denoiser_init(jax.random.PRNGKey(0), j_smoke())))
    rng = np.random.default_rng(0)
    tree["out_proj"] = (0.2 * rng.standard_normal(tree["out_proj"].shape)).astype(np.float32)
    tree["final_norm"]["scale"] = (0.3 * rng.standard_normal(64)).astype(np.float32)
    for name in ("attn_norm", "ffn_norm"):
        leaf = tree["decoder"]["g0"][name]
        leaf["scale"] = (0.3 * rng.standard_normal(leaf["scale"].shape)).astype(np.float32)
    return tree


def test_asd_sample_batched_on_the_smoke_denoiser_matches_jax():
    jdc, tdc = j_smoke(), t_smoke()
    tree = _tree()
    # t_max 10 keeps SL states (which grow like t) below ~50: the chain feeds
    # each step into the next model call, so float32 differences grow along
    # it, and 1e-4 (absolute and relative) holds with room at this scale
    js = j_sch.sl_geometric(K, 0.05, 10.0)
    ts = t_sch.sl_geometric(K, 0.05, 10.0)
    key = jax.random.PRNGKey(5)
    y0 = np.zeros((CHAINS, jdc.seq_len, jdc.d_data), np.float32)

    jr = j_asd.asd_sample_batched(j_make_sl(jax.tree_util.tree_map(jnp.asarray, tree), jdc),
                                  js, jnp.asarray(y0), key, THETA)
    keys = jax.random.split(key, CHAINS)
    sts = [j_asd.init_chain_state(js, jnp.asarray(y0[b]), keys[b], THETA)
           for b in range(CHAINS)]
    u = torch.from_numpy(np.stack([np.array(s.u_buf) for s in sts]))
    xi = torch.from_numpy(np.stack([np.array(s.xi_buf) for s in sts]))

    g0, f0 = grs.launches, flash_mha.launches
    tr = t_asd.asd_sample_batched(t_make_sl(from_jax_params(tree, tdc, device="cpu"), tdc),
                                  ts, torch.from_numpy(y0), THETA, u_buf=u, xi_buf=xi,
                                  device="cpu")
    # on the CPU both wrappers run their plain versions and count nothing
    assert (grs.launches, flash_mha.launches) == (g0, f0)

    for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals"):
        assert getattr(tr, name).tolist() == np.array(getattr(jr, name)).tolist(), name
    np.testing.assert_allclose(tr.sample.numpy(), np.array(jr.sample), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tr.trajectory.numpy(), np.array(jr.trajectory),
                               atol=1e-4, rtol=1e-4)
    # the reject-and-reflect path ran, in both packages
    assert bool((tr.accepts < tr.proposals).any())
    assert bool(jnp.any(jr.accepts < jr.proposals))
    assert int(tr.accepts.sum()) > 0
    assert np.isfinite(tr.sample.numpy()).all()
