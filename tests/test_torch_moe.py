"""The port's MoE (``repro_torch.nn.moe``, every expert on the device)
against the JAX package's ``repro.nn.moe`` in float32, on the CPU:
``moe_apply`` where the capacity drops tokens (the kept (token, expert)
sets equal, outputs and the aux loss within 1e-5), the combine's order in
bf16 (bit for bit against the JAX scatter-add), the reduced
qwen3-moe-30b-a3b through ``lm_fwd``, ``lm_prefill`` and ``lm_decode_step``
(logits within 2e-4, as the dense archs), the MoE denoiser
``qwen3-moe-a3b-smoke`` through ``denoiser_fwd`` and one ASD call on the
same noise, the serve CLI at that model and the model-parallel
combinations it refuses with the JAX CLI's messages, ``ep_axis`` over
replicated experts, the init's fan-in, and the full-width tree and count.  The MoE loss and its
gradients are in tests/test_torch_moe_train.py.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as j_reduced
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import qwen3_moe_a3b_smoke as j_moe_smoke
from repro.core import asd as j_asd
from repro.core import schedules as j_sch
from repro.models import lm as j_lm
from repro.models.diffusion import denoiser_fwd as j_denoiser_fwd
from repro.models.diffusion import denoiser_init
from repro.models.diffusion import make_ddpm_model_fn as j_make_ddpm
from repro.nn import moe as j_moe
from repro.nn.param import unbox
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config, get_denoiser_config
from repro_torch.configs.registry import qwen3_moe_a3b_smoke as t_moe_smoke
from repro_torch.core import asd as t_asd
from repro_torch.core import schedules as t_sch
from repro_torch.distributed.group import ModelGroup
from repro_torch.launch import serve
from repro_torch.models import lm as t_lm
from repro_torch.models.diffusion import denoiser_fwd as t_denoiser_fwd
from repro_torch.models.diffusion import make_ddpm_model_fn as t_make_ddpm
from repro_torch.nn import moe as t_moe
from repro_torch.weights import (_fan_in, from_jax_lm_params, from_jax_params,
                                 init_lm_params, lm_init_params, lm_param_shapes,
                                 param_shapes)
from tests.test_torch_asd import jax_noise

NAME = "qwen3-moe-30b-a3b"
# jax.eval_shape of the JAX package's lm_init at full width, and the share
# of it in the MoE leaves (48 x 128 x (3 x 2048 x 768 + 2048): the expert
# stacks and the router)
PARAMS, EXPERT_PARAMS = 30_532_110_336, 29_003_612_160
B, L, P = 2, 48, 40


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree_util.tree_map(_t, tree)


def _acts(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _draw(shapes, rng, key=None, stacked=False):
    """Leaves of ``shapes`` in key order: norm scales normal * 0.1, the
    embedding table, head and router normal * 0.02, products normal /
    sqrt(fan-in) (all axes but the last and the stacked layers axis)."""
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, k, stacked or k == "decoder") for k, v in shapes.items()}
    a = rng.standard_normal(shapes).astype(np.float32)
    if key == "scale":
        return a * np.float32(0.1)
    if key in ("table", "w", "router"):
        return a * np.float32(0.02)
    return a / np.float32(np.sqrt(np.prod(shapes[int(stacked):-1])))


def _moe_params(cfg, seed, router_std=1.0):
    """One layer's MoE leaves (router, w_gate, w_up, w_down) drawn with
    numpy; a router of std 1 spreads the tokens' choices."""
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {"router": rng.standard_normal((d, E)).astype(np.float32) * np.float32(router_std),
            "w_gate": _acts(seed + 1, (E, d, ff)) / np.float32(np.sqrt(d)),
            "w_up": _acts(seed + 2, (E, d, ff)) / np.float32(np.sqrt(d)),
            "w_down": _acts(seed + 3, (E, ff, d)) / np.float32(np.sqrt(ff))}


def _kept(token_idx, keep):
    """The kept (row, token, expert) triples."""
    token_idx, keep = np.asarray(token_idx), np.asarray(keep)
    return {(b, int(token_idx[b, e, c]), e) for b, e, c in zip(*np.nonzero(keep))}


# ---------------------------------------------------------------- configs


def test_the_configs_are_the_jax_packages():
    for tcfg, jcfg in ((get_config(NAME), j_get_config(NAME)),
                       (reduced(get_config(NAME)), j_reduced(j_get_config(NAME)))):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tdc, jdc = get_denoiser_config("qwen3-moe-a3b-smoke"), j_moe_smoke()
    assert dataclasses.asdict(tdc.backbone) == dataclasses.asdict(jdc.backbone)
    assert (tdc.seq_len, tdc.d_data, tdc.d_cond) == (jdc.seq_len, jdc.d_data, jdc.d_cond)


def test_lm_param_shapes_are_the_jax_init_tree():
    for tcfg, jcfg in ((get_config(NAME), j_get_config(NAME)),
                       (reduced(get_config(NAME)), j_reduced(j_get_config(NAME)))):
        abstract = jax.eval_shape(lambda: unbox(j_lm.lm_init(jax.random.PRNGKey(0), jcfg)))
        assert lm_param_shapes(tcfg) == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                               abstract)
    shapes = lm_param_shapes(get_config(NAME))
    sizes = jax.tree_util.tree_map(lambda s: int(np.prod(s)), shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    assert sum(jax.tree_util.tree_leaves(sizes)) == PARAMS
    moe = sizes["decoder"]["g0"]["moe"]
    assert sum(moe.values()) == EXPERT_PARAMS
    assert list(shapes["decoder"]["g0"]["moe"]) == ["router", "w_gate", "w_up", "w_down"]


def test_init_fan_in_counts_the_expert_axis():
    """The JAX init's lecun-normal counts every axis but the out axis into
    the fan: E x d for the gate and up stacks, E x ff for the down stack.
    The port's fan-in says so on the stacked shapes, and both inits draw
    the stacks at that std (router normal * 0.02)."""
    cfg, jcfg = reduced(get_config(NAME)), j_reduced(j_get_config(NAME))
    n, E, d, ff = cfg.n_repeats, cfg.n_experts, cfg.d_model, cfg.d_ff
    assert _fan_in((n, E, d, ff), True) == E * d
    assert _fan_in((n, E, ff, d), True) == E * ff
    jtree = unbox(j_moe.moe_init(jax.random.PRNGKey(0), jcfg))  # one layer
    tree = lm_init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tmoe = tree["decoder"]["g0"]["moe"]
    for leaf, std in (("w_gate", (E * d) ** -0.5), ("w_up", (E * d) ** -0.5),
                      ("w_down", (E * ff) ** -0.5), ("router", 0.02)):
        # five standard errors of a std estimated from the leaf's draws
        tol = 5 / np.sqrt(2 * jtree[leaf].size)
        assert abs(float(np.std(np.asarray(jtree[leaf]))) / std - 1) < tol, leaf
        assert abs(tmoe[leaf].std().item() / std - 1) < tol, leaf


def test_init_lm_params_draws_compute_leaves_in_the_compute_dtype():
    """``dtype``: the leaves ``lm_compute_params`` casts come out in it, a
    layer at a time, with the same law; the rest stays float32."""
    cfg = reduced(get_config(NAME))
    tree = init_lm_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    g0 = tree["decoder"]["g0"]
    for leaf in (g0["moe"]["w_gate"], g0["moe"]["router"], g0["attn"]["wq"],
                 tree["embed"]["table"], tree["head"]["w"]):
        assert leaf.dtype == torch.bfloat16
    assert g0["ffn_norm"]["scale"].dtype == torch.float32
    assert tree["final_norm"]["scale"].dtype == torch.float32
    E, d = cfg.n_experts, cfg.d_model
    for i in range(cfg.n_repeats):
        std = g0["moe"]["w_gate"][i].float().std().item()
        assert abs(std * (E * d) ** 0.5 - 1) < 0.05
    assert abs(g0["moe"]["router"].float().std().item() / 0.02 - 1) < 0.1


# ---------------------------------------------------------------- moe_apply


@pytest.fixture(scope="module")
def dropping():
    """E 4, top 2, capacity_factor 1.0 at L 64: the capacity (32 a row and
    expert) drops tokens."""
    cfg = dataclasses.replace(reduced(get_config(NAME)), capacity_factor=1.0)
    jcfg = dataclasses.replace(j_reduced(j_get_config(NAME)), capacity_factor=1.0)
    p = _moe_params(cfg, 30)
    x = _acts(31, (2, 64, cfg.d_model))
    return cfg, jcfg, p, x


def test_moe_apply_matches_where_the_capacity_drops_tokens(dropping):
    cfg, jcfg, p, x = dropping
    jg, ji, jk, jft, jfp = j_moe._route(_jnp(p), jnp.asarray(x), jcfg, None)
    tg, ti, tk, tft, tfp, _ = t_moe._route(_tt(p), _t(x), cfg)
    assert tk.shape == (2, 4, 32) and t_moe.capacity_of(cfg, 64) == 32
    kept = _kept(ji, jk)
    assert len(kept) < 2 * 64 * cfg.top_k  # the capacity dropped pairs
    # a positive tie at the capacity's edge would let the two top-k's keep
    # different tokens; say so rather than fail on the kept sets
    w = np.sort(np.asarray(j_moe._route(_jnp(p), jnp.asarray(x), jcfg, 64)[0]), -1)[..., ::-1]
    C = tk.shape[-1]
    edge_ties = int(((w[..., C - 1] == w[..., C]) & (w[..., C] > 0)).sum())
    assert edge_ties == 0, f"{edge_ties} positive ties at the capacity's edge"
    assert _kept(ti, tk) == kept
    # the kept slots' gates; ties at the capacity's edge would show here
    np.testing.assert_allclose(_np(tg * tk), np.asarray(jg * jk), atol=1e-6)
    jo, jaux = j_moe.moe_apply(_jnp(p), jnp.asarray(x), jcfg)
    to, taux = t_moe.moe_apply(_tt(p), _t(x), cfg)
    assert np.abs(np.asarray(jo)).max() > 0.1
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux["moe_aux_loss"].item(), float(jaux["moe_aux_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(t_moe._aux_loss(tft, tfp, cfg)),
                               np.asarray(j_moe._aux_loss(jft, jfp, jcfg)), rtol=1e-6)


def test_combine_order_is_the_jax_scatter_adds(dropping):
    """In bf16 the combine's order shows in the bits (at top 4: with two
    rows a token, either order gives one sum): the port's equals the JAX
    package's scatter-add (ascending expert index, a rounding after each
    add), and the same rows added in descending order differ."""
    cfg, _, _, x = dropping
    cfg = dataclasses.replace(cfg, n_experts=8, top_k=4)
    p = _moe_params(cfg, 33)
    g, idx, keep, _, _, top = t_moe._route(_tt(p), _t(x), cfg)
    Bx, E, C = idx.shape
    y = torch.from_numpy(_acts(32, (Bx, E, C, cfg.d_model))).to(torch.bfloat16)
    gate = (g * keep).to(torch.bfloat16)[..., None]
    jy = jnp.asarray(_np(y), jnp.bfloat16) * jnp.asarray(_np(gate), jnp.bfloat16)
    bidx = np.broadcast_to(np.arange(Bx)[:, None, None], idx.shape)
    jout = jnp.zeros((Bx, 64, cfg.d_model), jnp.bfloat16).at[bidx, np.asarray(idx)].add(jy)
    out = t_moe._combine(y.transpose(0, 1).reshape(E, Bx * C, -1), g, idx, keep, top, 64)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(out), np.asarray(jout.astype(jnp.float32)))
    flipped = t_moe._combine(y.transpose(0, 1).reshape(E, Bx * C, -1), g, idx, keep,
                             top.flip(-1), 64)
    assert torch.equal(flipped, out)  # the combine sorts each token's experts itself
    rev = torch.zeros_like(out)
    parts = (y * gate.to(torch.bfloat16))
    for e in reversed(range(E)):
        for c in range(C):
            rows = idx[:, e, c]
            rev[torch.arange(Bx), rows] = rev[torch.arange(Bx), rows] + parts[:, e, c]
    assert not torch.equal(rev, out)


def test_moe_apply_with_an_ep_axis_runs_replicated_experts_unsharded(dropping):
    """Expert parallelism is taken only where the expert stacks are a
    rank's block: with every expert (and a group of one rank) the call is
    the replicated one, bit for bit."""
    cfg, _, p, x = dropping
    ref, ref_aux = t_moe.moe_apply(_tt(p), _t(x), cfg)
    out, aux = t_moe.moe_apply(_tt(p), _t(x), cfg, ep_axis=ModelGroup(0, 1, "cpu"))
    assert torch.equal(out, ref) and torch.equal(aux["moe_aux_loss"], ref_aux["moe_aux_loss"])


# ---------------------------------------------------------------- the LM


@pytest.fixture(scope="module")
def lm():
    """The reduced qwen3-moe-30b-a3b (E 4, top 2, cf 4.0: C is L, nothing
    drops), params drawn with numpy, and the JAX package's logits: the
    forward over L, the prefill of P and the decode of the rest."""
    jcfg, tcfg = j_reduced(j_get_config(NAME)), reduced(get_config(NAME))
    tree = _draw(lm_param_shapes(tcfg), np.random.default_rng(300))
    tokens = np.random.default_rng(6).integers(0, 256, (B, L))
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
    return tcfg, tree, tokens, (np.asarray(full), np.asarray(pre[:, 0]), np.stack(dec, 1))


def test_lm_fwd_prefill_and_decode_match(lm):
    """The forward, the prefill and the decode steps against JAX's within
    2e-4; the decode against the port's own forward within 1e-3 (the JAX
    package's differ by 3.5e-4 here: its prefill and step attend in
    another order)."""
    tcfg, tree, tokens, (jfull, jpre, jdec) = lm
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    full = t_lm.lm_fwd(params, _t(tokens), tcfg)
    assert tuple(full.shape) == (B, L, 256) and np.abs(jfull).max() > 0.1
    np.testing.assert_allclose(_np(full), jfull, atol=2e-4, rtol=0)
    caches = t_lm.lm_cache_init(params, tcfg, B, L, dtype=torch.float32)
    pre, caches = t_lm.lm_prefill(params, _t(tokens[:, :P]), caches, tcfg)
    np.testing.assert_allclose(_np(pre[:, 0]), jpre, atol=2e-4, rtol=0)
    pos = torch.tensor(P)
    dec = []
    for i in range(P, L):
        lg, caches = t_lm.lm_decode_step(params, _t(tokens[:, i]), caches, pos, tcfg)
        pos.add_(1)
        dec.append(_np(lg[:, 0]))
    dec = np.stack(dec, 1)
    np.testing.assert_allclose(dec, jdec, atol=2e-4, rtol=0)
    np.testing.assert_allclose(dec, _np(full[:, P:]), atol=1e-3, rtol=0)


def test_lm_loss_refuses_moe_and_the_cast_keeps_the_router(lm):
    """``lm_loss`` no longer refuses the MoE: its loss is the NLL plus
    ``router_aux_weight`` times the summed aux (against JAX's in
    test_torch_moe_train.py); the compute cast keeps the router's leaves in
    the compute dtype and the norms float32."""
    tcfg, tree, tokens, _ = lm
    params = from_jax_lm_params(tree, tcfg, device="cpu")
    batch = {"tokens": _t(tokens), "labels": _t(tokens)}
    loss, metrics = t_lm.lm_loss(params, batch, tcfg)
    assert torch.isfinite(loss) and metrics["moe_aux"].item() > 0
    assert torch.allclose(loss, metrics["nll"] + tcfg.router_aux_weight * metrics["moe_aux"])
    cast = t_lm.lm_compute_params(params, dataclasses.replace(tcfg,
                                                             compute_dtype="bfloat16"))
    moe = cast["decoder"]["g0"]["moe"]
    assert {k: v.dtype for k, v in moe.items()} == dict.fromkeys(moe, torch.bfloat16)
    assert cast["decoder"]["g0"]["ffn_norm"]["scale"].dtype == torch.float32


# ---------------------------------------------------------------- denoiser


@pytest.fixture(scope="module")
def denoiser():
    """The smoke denoiser's params drawn with numpy in the JAX init's tree,
    with nonzero ``out_proj`` and norm scales (JAX's init zeroes both,
    which would make every output 0)."""
    jdc, tdc = j_moe_smoke(), t_moe_smoke()
    abstract = jax.eval_shape(lambda: unbox(denoiser_init(jax.random.PRNGKey(2), jdc)))
    shapes = param_shapes(tdc)
    assert shapes == jax.tree_util.tree_map(lambda a: tuple(a.shape), abstract)
    tree = _draw(shapes, np.random.default_rng(40))
    tree["out_proj"] *= np.float32(0.05 * np.sqrt(tdc.backbone.d_model))
    return jdc, tdc, tree


def test_denoiser_fwd_matches(denoiser):
    """20 points: two blocks of 16, the second padded with 12 zero points."""
    jdc, tdc, tree = denoiser
    points = 20
    rng = np.random.default_rng(41)
    t = rng.uniform(0.0, 50.0, (points,)).astype(np.float32)
    y = rng.standard_normal((points, 8, 4)).astype(np.float32)
    jo = np.asarray(j_denoiser_fwd(_jnp(tree), jnp.asarray(t), jnp.asarray(y), jdc))
    params = from_jax_params(tree, tdc, device="cpu")
    to = _np(t_denoiser_fwd(params, _t(t), _t(y), tdc))
    assert to.shape == (points, 8, 4) and np.abs(jo).max() > 0.1
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)


def test_a_denoiser_point_is_the_same_bits_alone_and_in_a_batch(denoiser):
    _, tdc, tree = denoiser
    params = from_jax_params(tree, tdc, device="cpu")
    rng = np.random.default_rng(42)
    t = _t(rng.uniform(0.0, 50.0, (36,)).astype(np.float32))
    y = _t(rng.standard_normal((36, 8, 4)).astype(np.float32))
    fn = t_make_ddpm(params, tdc)
    assert torch.equal(fn(t[:1], y[:1]), fn(t, y)[:1])
    assert torch.equal(fn(t[20:21], y[20:21]), fn(t, y)[20:21])


def test_asd_on_the_moe_denoiser_matches(denoiser):
    """``asd_sample_batched`` in buffer noise mode on the DDPM schedule,
    each chain fed the noise the JAX sampler draws from its key."""
    jdc, tdc, tree = denoiser
    K, theta, n = 16, 4, 3
    key = jax.random.PRNGKey(5)
    y0 = np.random.default_rng(43).standard_normal((n, 8, 4)).astype(np.float32)
    js = j_sch.ddpm(K)
    jr = j_asd.asd_sample_batched(j_make_ddpm(_jnp(tree), jdc), js, jnp.asarray(y0), key,
                                  theta, keep_trajectory=False)
    u, xi = jax_noise(js, y0, key, theta)
    tr = t_asd.asd_sample_batched(t_make_ddpm(from_jax_params(tree, tdc, device="cpu"), tdc),
                                  t_sch.ddpm(K), _t(y0), theta, keep_trajectory=False,
                                  u_buf=_t(u), xi_buf=_t(xi), device="cpu")
    np.testing.assert_allclose(tr.sample.numpy(), np.asarray(jr.sample), atol=1e-4, rtol=1e-4)
    for name in ("rounds", "accepts", "proposals", "model_evals"):
        assert getattr(tr, name).tolist() == np.asarray(getattr(jr, name)).tolist(), name


def test_the_serve_cli_serves_the_moe_denoiser(capsys):
    summary = serve.main(["--device", "cpu", "--model", "qwen3-moe-a3b-smoke", "--K", "10",
                          "--chains", "4"])
    assert summary["finite"] and summary["retired"] == 4
    assert "[continuous] served 4 requests" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--expert-parallel"],
                                  ["--model-shards", "2", "--seq-shards", "2"],
                                  ["--seq-shards", "3"]])
def test_the_serve_cli_still_refuses_model_parallelism(flag, monkeypatch):
    """The combinations the JAX CLI refuses on the MoE denoiser (EP with no
    group, TP with SP, SP over heads that do not divide) exit with its
    message; the ones it serves run in tests/test_torch_serve_cli.py."""
    from repro.launch import serve as j_serve

    base = ["--model", "qwen3-moe-a3b-smoke"]
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu"] + base + flag)
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", "--mesh", "1x1"] + base + flag)
    with pytest.raises(SystemExit) as ref:
        j_serve.main()
    assert isinstance(exc.value.code, str) and exc.value.code == ref.value.code
