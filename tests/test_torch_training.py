"""The port's trainer against the JAX package's, in one process, at small
size (float32): the losses and their gradients, remat, the init law,
AdamW, the train step with accumulation and the NaN guard, a 20-step
trajectory, and the batched samplers with per-chain conditions.

The reference draws its noise from a key; the port is handed the same
draws, reproduced here the way ``sl_denoiser_loss`` and
``ddpm_denoiser_loss`` make them (``kt, kn = jax.random.split(key)``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import asd as j_asd
from repro.core import schedules as j_sch
from repro.core import sequential as j_seq
from repro.data.pipeline import RobotReach as JRobotReach
from repro.models import diffusion as j_diff
from repro.nn.param import unbox
from repro.training import optimizer as j_opt
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import asd as t_asd
from repro_torch.core import schedules as t_sch
from repro_torch.core import sequential as t_seq
from repro_torch.data.pipeline import RobotReach
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.models import decoder as t_decoder
from repro_torch.models import diffusion as t_diff
from repro_torch.training import optimizer as t_opt
from repro_torch.training.train_step import make_train_step
from repro_torch.weights import (denoiser_init_params, from_jax_opt_state, from_jax_params,
                                 param_shapes)

T_MIN, T_MAX = 0.05, 50.0
COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals")


def _policy(pkg_cfg, pkg_dc, remat=False, n_layers=2):
    """The policy stand-in of the JAX benchmarks (``benchmarks/common.py``
    ``MODELS["policy"]``) at 2 layers and d 64: seq 16, d_data 2, d_cond 4,
    log time, float32."""
    bb = pkg_cfg(name="policy-standin-2", family="dense", n_layers=n_layers, d_model=64,
                 n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=1, pos_embed="none",
                 embed_inputs=False, compute_dtype="float32", remat=remat)
    return pkg_dc(backbone=bb, seq_len=16, d_data=2, d_cond=4, time_log=True)


def configs(name, remat=False):
    if name == "smoke":
        jdc, tdc = j_smoke(), t_smoke()
        return jdc, dataclasses.replace(tdc, backbone=dataclasses.replace(
            tdc.backbone, remat=remat))
    return (_policy(JModelConfig, j_diff.DenoiserConfig),
            _policy(TModelConfig, t_diff.DenoiserConfig, remat))


def jax_tree(jdc, seed=0, perturb=False):
    """The JAX init as numpy; ``perturb`` makes out_proj and the norm scales
    nonzero, so that every leaf gets a gradient (the init zeroes them)."""
    tree = jax.tree_util.tree_map(np.array, unbox(j_diff.denoiser_init(
        jax.random.PRNGKey(seed), jdc)))
    if perturb:
        rng = np.random.default_rng(seed + 100)

        def nudge(t, name=None):
            if isinstance(t, dict):
                return {k: nudge(v, k) for k, v in t.items()}
            if name in ("out_proj", "scale"):
                return (0.3 * rng.standard_normal(t.shape)).astype(np.float32)
            return t

        tree = nudge(tree)
    return tree


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_l2(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def sl_draws(key, B, shape):
    kt, kn = jax.random.split(key)
    logt = jax.random.uniform(kt, (B,), minval=jnp.log(T_MIN), maxval=jnp.log(T_MAX))
    return np.array(jnp.exp(logt)), np.array(jax.random.normal(kn, shape))


def ddpm_draws(key, B, K, shape):
    kt, kn = jax.random.split(key)
    return (np.array(jax.random.randint(kt, (B,), 0, K)),
            np.array(jax.random.normal(kn, shape)))


def _x0_cond(dc, B, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, dc.seq_len, dc.d_data)).astype(np.float32)
    cond = rng.uniform(-1, 1, (B, dc.d_cond)).astype(np.float32) if dc.d_cond else None
    return x0, cond


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _grads(params, loss_of):
    leaves = [p for _, p in _flat(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_of(params)
    return loss, dict(zip([k for k, _ in _flat(params)],
                          torch.autograd.grad(loss, leaves, allow_unused=True)))


@pytest.mark.parametrize("perturb", [False, True], ids=["jax-init", "perturbed"])
@pytest.mark.parametrize("kind", ["sl", "ddpm"])
@pytest.mark.parametrize("model", ["smoke", "policy", "policy-remat"])
def test_losses_and_gradients_match_the_reference(model, kind, perturb):
    """Loss within 1e-5 relative; every gradient leaf within 1e-4 relative
    L2 of jax.grad (exactly zero where the reference's is)."""
    jdc, tdc = configs(model.split("-")[0], remat=model.endswith("remat"))
    tree = jax_tree(jdc, 1, perturb)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    B = 3
    x0, cond = _x0_cond(jdc, B, 2)
    jcond = None if cond is None else jnp.asarray(cond)
    key = jax.random.PRNGKey(5)
    if kind == "sl":
        jloss = lambda p: j_diff.sl_denoiser_loss(p, jdc, jnp.asarray(x0), key, T_MIN,
                                                  T_MAX, cond=jcond)
        t, xi = sl_draws(key, B, x0.shape)
        tloss = lambda p: t_diff.sl_denoiser_loss(p, tdc, _t(x0), None, T_MIN, T_MAX,
                                                  cond=_t(cond), t=_t(t), xi=_t(xi))
    else:
        abar = j_sch.ddpm_coeffs(20)[2]
        jloss = lambda p: j_diff.ddpm_denoiser_loss(p, jdc, jnp.asarray(x0), key, abar,
                                                    cond=jcond)
        s, eps = ddpm_draws(key, B, 20, x0.shape)
        tloss = lambda p: t_diff.ddpm_denoiser_loss(p, tdc, _t(x0), _t(abar),
                                                    cond=_t(cond), s=_t(s), eps=_t(eps))
    jl, jg = jax.value_and_grad(jloss)(jparams)
    tl, tg = _grads(from_jax_params(tree, tdc, device="cpu"), tloss)
    assert abs(tl.item() - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = dict(_flat(jax.tree_util.tree_map(np.asarray, jg)))
    assert set(jflat) == set(tg)
    nonzero = 0
    for k, g in jflat.items():
        got = np.zeros_like(g) if tg[k] is None else _np(tg[k])
        if not np.any(g):
            assert not np.any(got), k
            continue
        nonzero += 1
        assert rel_l2(got, g) <= 1e-4, (k, rel_l2(got, g))
    # the JAX init gives a gradient to out_proj alone; perturbed, to every leaf
    # (cond_proj only where the model is conditioned)
    assert nonzero == (len(jflat) if perturb else 1)


def test_remat_gives_the_same_gradients_and_recomputes():
    """cfg.remat wraps each layer in torch.utils.checkpoint under autograd
    only; the gradients are the same bits as without it."""
    _, plain = configs("policy", remat=False)
    _, remat = configs("policy", remat=True)
    tree = jax_tree(configs("policy")[0], 3, perturb=True)
    x0, cond = _x0_cond(plain, 4, 1)
    t = torch.tensor([0.1, 1.0, 10.0, 40.0])
    xi = torch.from_numpy(np.random.default_rng(9).standard_normal(x0.shape)
                          .astype(np.float32))
    calls = []
    real = t_decoder.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    out = {}
    for name, dc in (("plain", plain), ("remat", remat)):
        t_decoder.checkpoint = counting
        try:
            out[name] = _grads(from_jax_params(tree, dc, device="cpu"),
                               lambda p: t_diff.sl_denoiser_loss(
                                   p, dc, _t(x0), cond=_t(cond), t=t, xi=xi))
        finally:
            t_decoder.checkpoint = real
        if name == "plain":
            assert not calls
    assert len(calls) == remat.backbone.n_layers
    assert torch.equal(out["plain"][0], out["remat"][0])
    for k, g in out["plain"][1].items():
        assert torch.equal(g, out["remat"][1][k]), k
    # inference does not checkpoint
    calls.clear()
    t_decoder.checkpoint = counting
    try:
        with torch.no_grad():
            t_diff.denoiser_fwd(from_jax_params(tree, remat, device="cpu"), t,
                                _t(x0), remat, cond=_t(cond))
    finally:
        t_decoder.checkpoint = real
    assert not calls


def test_init_has_the_reference_law():
    """out_proj, the norm scales and the biases zero; every product
    lecun-normal over all but its last axis (and not the stacked axis),
    as the JAX init's standard deviations show."""
    jdc, tdc = configs("policy")
    big = dataclasses.replace(tdc, backbone=dataclasses.replace(tdc.backbone, d_model=256,
                                                                d_ff=512))
    jbig = dataclasses.replace(jdc, backbone=dataclasses.replace(jdc.backbone, d_model=256,
                                                                 d_ff=512))
    params = denoiser_init_params(big, torch.Generator().manual_seed(0), device="cpu")
    ref = dict(_flat(jax.tree_util.tree_map(np.array, unbox(j_diff.denoiser_init(
        jax.random.PRNGKey(0), jbig)))))
    got = dict(_flat(params))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = _np(got[k])
        assert g.shape == r.shape and g.dtype == np.float32
        if not np.any(r):
            assert not np.any(g), k
            continue
        assert abs(g.std() / r.std() - 1) < 0.08, (k, g.std(), r.std())
        assert abs(g.mean()) < 0.1 * g.std(), k
    n = big.backbone.n_layers
    attn = params["decoder"]["g0"]["attn"]
    assert attn["wq"].std().item() == pytest.approx(1 / (256 * 4) ** 0.5, rel=0.05)
    assert attn["wo"].std().item() == pytest.approx(1 / (4 * 64) ** 0.5, rel=0.05)
    assert params["decoder"]["g0"]["attn_norm"]["scale"].shape == (n, 256)
    again = denoiser_init_params(big, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["t_mlp2"], params["t_mlp2"])


def _opt_pair(weight_decay, lr=1e-3):
    return (j_opt.adamw(j_opt.constant_schedule(lr), weight_decay=weight_decay),
            t_opt.adamw(t_opt.constant_schedule(lr), weight_decay=weight_decay))


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.clone()


def test_one_adamw_step_matches_the_reference_with_clipping():
    """Clipping active (global norm ~ 40 against 1), weight decay 0.1, from
    a state one step in: params, mu and nu within 1e-6."""
    jdc, tdc = configs("policy")
    tree = jax_tree(jdc, 2, perturb=True)
    rng = np.random.default_rng(0)
    grads = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree) for _ in range(2)]
    jo, to = _opt_pair(0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jo.init(jp)
    tp = from_jax_params(tree, tdc, device="cpu")
    ts = to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(from_jax_params(g, tdc, device="cpu"), ts, tp)
    assert float(jm["grad_norm"]) > 10
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(
        jm["grad_norm"])
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 2 and ts["step"].dtype == torch.int32
    for name, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        jf = dict(_flat(jax.tree_util.tree_map(np.asarray, jt)))
        for k, v in _flat(tt):
            np.testing.assert_allclose(_np(v), jf[k], atol=1e-6, rtol=0,
                                       err_msg=f"{name} {k}")


def test_weight_decay_reaches_the_stacked_norm_scales():
    """Decay goes to every leaf with ndim >= 2: on the stacked tree that
    includes the (n, d) norm scales but not final_norm's (d,) scale.  With
    zero gradients the step is decay alone: p * (1 - lr * wd)."""
    jdc, tdc = configs("policy")
    tree = jax_tree(jdc, 4, perturb=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, tree)
    jo, to = _opt_pair(0.1, lr=0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jp2, _, _ = jo.update(jax.tree_util.tree_map(jnp.asarray, zeros), jo.init(jp), jp)
    tp = from_jax_params(tree, tdc, device="cpu")
    tp2, _, _ = to.update(from_jax_params(zeros, tdc, device="cpu"), to.init(tp),
                          _clone(tp))
    stacked = tp2["decoder"]["g0"]["attn_norm"]["scale"]
    assert stacked.ndim == 2
    torch.testing.assert_close(stacked, tp["decoder"]["g0"]["attn_norm"]["scale"]
                               * (1 - 0.5 * 0.1), rtol=1e-6, atol=1e-7)
    assert torch.equal(tp2["final_norm"]["scale"], tp["final_norm"]["scale"])
    np.testing.assert_allclose(_np(stacked),
                               np.asarray(jp2["decoder"]["g0"]["attn_norm"]["scale"]),
                               atol=1e-7)
    np.testing.assert_array_equal(_np(tp2["final_norm"]["scale"]),
                                  np.asarray(jp2["final_norm"]["scale"]))


def _loss_fns(jdc, tdc):
    def jloss(p, batch, rng):
        return j_diff.sl_denoiser_loss(p, jdc, batch["x0"], rng, T_MIN, T_MAX,
                                       cond=batch.get("cond")), {}

    def tloss(p, batch, gen):
        return t_diff.sl_denoiser_loss(p, tdc, batch["x0"], gen, T_MIN, T_MAX,
                                       cond=batch.get("cond"), t=batch.get("t"),
                                       xi=batch.get("xi")), {}

    return jloss, tloss


def _injected(batch, key, accum):
    """The batch with the draws the reference makes for each of its
    ``accum`` microbatches (its key split per microbatch)."""
    x0 = batch["x0"]
    B = x0.shape[0]
    keys = [key] if accum == 1 else list(jax.random.split(key, accum))
    m = B // accum
    ts, xis = zip(*(sl_draws(k, m, (m,) + x0.shape[1:]) for k in keys))
    return dict(batch, t=np.concatenate(ts), xi=np.concatenate(xis))


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(accum):
    jdc, tdc = configs("policy")
    tree = jax_tree(jdc, 0)
    jloss, tloss = _loss_fns(jdc, tdc)
    jo, to = _opt_pair(0.1, lr=2e-3)
    jstep = jax.jit(j_make_train_step(jloss, jo, accum))
    tstep = make_train_step(tloss, to, accum)
    acts, obs = RobotReach(horizon=16, batch=8).batch_at(0)
    batch = {"x0": acts, "cond": obs}
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jo.init(jp)
    tp = from_jax_params(tree, tdc, device="cpu")
    ts = to.init(tp)
    for s in range(2):  # step 2 moves every leaf (step 1 only out_proj)
        key = jax.random.PRNGKey(s)
        jp, js, jm = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, batch), key)
        tp, ts, tm = tstep(tp, ts, _tensors(_injected(batch, key, accum)))
        assert tm["finite"] and bool(jm["finite"])
        for name in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[name]) - float(jm[name])) <= 1e-5 * abs(float(jm[name])), \
                (s, name, float(tm[name]), float(jm[name]))
    # Adam's early steps are near sign(g) per element, so an element whose
    # gradient is within rounding of zero may move by up to 2 lr; the trees
    # are held by relative L2 (the gradients' own tolerance), the scalars
    # above at 1e-5
    for part, jt, tt in (("params", jp, tp), ("mu", js["mu"], ts["mu"]),
                         ("nu", js["nu"], ts["nu"])):
        jflat = dict(_flat(jax.tree_util.tree_map(np.asarray, jt)))
        for k, v in _flat(tt):
            assert rel_l2(v, jflat[k]) <= 1e-4, (part, k, rel_l2(v, jflat[k]))
    assert int(ts["step"]) == int(js["step"]) == 2
    assert not any(v.requires_grad for _, v in _flat(tp))


def test_nan_guard_leaves_params_and_state_unchanged():
    jdc, tdc = configs("policy")
    tree = jax_tree(jdc, 0, perturb=True)
    _, tloss = _loss_fns(jdc, tdc)
    jloss, _ = _loss_fns(jdc, tdc)
    jo, to = _opt_pair(0.1)
    tstep = make_train_step(tloss, to)
    acts, obs = RobotReach(horizon=16, batch=4).batch_at(1)
    acts[1, 3, 0] = np.nan
    batch = {"x0": acts, "cond": obs}
    tp = from_jax_params(tree, tdc, device="cpu")
    ts = to.init(tp)
    before_p, before_s = _clone(tp), _clone(ts)
    tp, ts, tm = tstep(tp, ts, _tensors(dict(batch, t=np.ones(4, np.float32),
                                             xi=np.zeros_like(acts))))
    assert tm["finite"] is False and not np.isfinite(float(tm["loss"]))
    assert float(tm["lr"]) == pytest.approx(1e-3)
    for (k, a), (_, b) in zip(_flat(before_p), _flat(tp)):
        assert torch.equal(a, b), k
    for (k, a), (_, b) in zip(_flat(before_s), _flat(ts)):
        assert torch.equal(a, b), k
    # the reference's guard does the same
    jstep = jax.jit(j_make_train_step(jloss, jo))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jp2, js2, jm = jstep(jp, jo.init(jp), jax.tree_util.tree_map(jnp.asarray, batch),
                         jax.random.PRNGKey(0))
    assert not bool(jm["finite"])
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(jp),
                                                    jax.tree_util.tree_leaves(jp2)))


def test_twenty_steps_follow_the_reference():
    """The policy recipe of the JAX benchmarks (AdamW 2e-3, no decay, key
    PRNGKey(s) at step s) for 20 steps: losses within 1e-4 relative at every
    step, and the params close at the end."""
    jdc, tdc = configs("policy")
    tree = jax_tree(jdc, 0)
    jloss, tloss = _loss_fns(jdc, tdc)
    jo, to = _opt_pair(0.0, lr=2e-3)
    jstep = jax.jit(j_make_train_step(jloss, jo))
    tstep = make_train_step(tloss, to)
    data = JRobotReach(horizon=16, batch=16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = jo.init(jp)
    tp = from_jax_params(tree, tdc, device="cpu")
    ts = to.init(tp)
    jl, tl = [], []
    for s in range(20):
        acts, obs = data.batch_at(s)
        batch = {"x0": np.asarray(acts), "cond": np.asarray(obs)}
        key = jax.random.PRNGKey(s)
        jp, js, jm = jstep(jp, js, jax.tree_util.tree_map(jnp.asarray, batch), key)
        tp, ts, tm = tstep(tp, ts, _tensors(_injected(batch, key, 1)))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert tl[-1] < tl[0]
    jflat = dict(_flat(jax.tree_util.tree_map(np.asarray, jp)))
    for k, v in _flat(tp):
        assert rel_l2(v, jflat[k]) <= 1e-4, k


def test_from_jax_opt_state_converts_the_adamw_state():
    jdc, tdc = configs("smoke")
    tree = jax_tree(jdc, 0, perturb=True)
    jo = j_opt.adamw(j_opt.constant_schedule(1e-3))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    g = jax.tree_util.tree_map(jnp.ones_like, jp)
    _, js, _ = jo.update(g, jo.init(jp), jp)
    st = from_jax_opt_state(jax.tree_util.tree_map(np.asarray, js), tdc, device="cpu")
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    assert set(st) == {"mu", "nu", "step"}
    np.testing.assert_array_equal(_np(st["nu"]["decoder"]["g0"]["ffn"]["w_up"]),
                                  np.asarray(js["nu"]["decoder"]["g0"]["ffn"]["w_up"]))


def test_schedules_match_the_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    j = np.asarray(jax.vmap(j_opt.cosine_schedule(3e-3, 5, 30))(jnp.asarray(steps)))
    t = t_opt.cosine_schedule(3e-3, 5, 30)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-12)
    assert float(t_opt.constant_schedule(2e-3)(torch.tensor(7))) == float(
        j_opt.constant_schedule(2e-3)(jnp.asarray(7)))
    tree = {"a": np.ones((3, 2), np.float32) * 2, "b": {"c": np.arange(4, dtype=np.float32)}}
    assert float(t_opt.global_norm({"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}})) \
        == pytest.approx(float(j_opt.global_norm(tree)), rel=1e-7)


def test_flash_mha_stays_differentiable_on_the_cpu():
    """On the CPU the flash core is its plain version and carries
    gradients (on the card it refuses autograd: tests/test_torch_cuda.py)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 2, 8, generator=g, requires_grad=True) for _ in range(3))
    flash_mha(q, k, v, causal=False).square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))


# ------------------------------------------------- conditioned batched sampling


def _cond_setup(B=3, K=10, theta=4):
    jdc, tdc = configs("policy")
    tree = jax_tree(jdc, 6, perturb=True)
    tree["out_proj"] = tree["out_proj"] * 3.0  # enough rejections at K 10
    js, ts = j_sch.sl_geometric(K, T_MIN, T_MAX), t_sch.sl_geometric(K, T_MIN, T_MAX)
    conds = np.random.default_rng(3).uniform(-1, 1, (B, jdc.d_cond)).astype(np.float32)
    y0 = np.zeros((B, jdc.seq_len, jdc.d_data), np.float32)
    return jdc, tdc, tree, js, ts, conds, y0


def assert_samples_close(got, want):
    """Within 1e-5 of the samples' scale: SL samples at t_max 50 reach a few
    hundred, where one float32 ulp is 1.5e-5."""
    got, want = _np(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


def _assert_counters_equal(jr, tr):
    """The parity rule lets an accept bit differ only on a row within float
    rounding of the GRS threshold; no row of these inputs sits that close,
    so every counter must be equal."""
    for name in COUNTERS:
        assert getattr(tr, name).tolist() == np.asarray(getattr(jr, name)).tolist(), name


@pytest.mark.parametrize("eager", [False, True])
def test_asd_sample_batched_with_conds_matches_the_vmapped_reference(eager):
    B, K, theta = 3, 10, 4
    jdc, tdc, tree, js, ts, conds, y0 = _cond_setup(B, K, theta)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    key = jax.random.PRNGKey(8)
    keys = jax.random.split(key, B)

    def one(y, k, c):
        return j_asd.asd_sample(j_diff.make_sl_model_fn(jparams, jdc, c), js, y, k, theta,
                                eager, "buffer")

    jr = jax.jit(jax.vmap(one))(jnp.asarray(y0), keys, jnp.asarray(conds))
    sts = [j_asd.init_chain_state(js, jnp.asarray(y0[b]), keys[b], theta)
           for b in range(B)]
    u = np.stack([np.array(s.u_buf) for s in sts])
    xi = np.stack([np.array(s.xi_buf) for s in sts])
    params = from_jax_params(tree, tdc, device="cpu")
    with torch.no_grad():
        tr = t_asd.asd_sample_batched(t_diff.make_sl_model_fn(params, tdc), ts,
                                      torch.from_numpy(y0), theta, eager_head=eager,
                                      u_buf=_t(u), xi_buf=_t(xi), device="cpu",
                                      conds=_t(conds))
    _assert_counters_equal(jr, tr)
    assert int(tr.accepts.sum()) < int(tr.proposals.sum())  # rejections ran
    assert_samples_close(tr.sample, jr.sample)
    # conditions matter: one chain's row changes its sample
    with torch.no_grad():
        other = t_asd.asd_sample_batched(t_diff.make_sl_model_fn(params, tdc), ts,
                                         torch.from_numpy(y0), theta, eager_head=eager,
                                         u_buf=_t(u), xi_buf=_t(xi), device="cpu",
                                         conds=_t(conds[::-1].copy()))
    assert not torch.allclose(other.sample[0], tr.sample[0])
    # asd_sample with one chain's cond is that chain of the batch
    with torch.no_grad():
        single = t_asd.asd_sample(t_diff.make_sl_model_fn(params, tdc), ts,
                                  torch.from_numpy(y0[1]), theta, eager_head=eager,
                                  u_buf=_t(u[1]), xi_buf=_t(xi[1]), device="cpu",
                                  cond=_t(conds[1]))
    torch.testing.assert_close(single.sample, tr.sample[1], atol=1e-6, rtol=1e-6)
    assert int(single.rounds) == int(tr.rounds[1])


def test_sequential_sample_batched_with_conds_matches_the_vmapped_reference():
    B = 3
    jdc, tdc, tree, js, ts, conds, y0 = _cond_setup(B)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    keys = jax.random.split(jax.random.PRNGKey(4), B)

    def one(y, k, c):
        return j_seq.sequential_sample(j_diff.make_sl_model_fn(jparams, jdc, c), js, y, k)[0]

    jy = jax.jit(jax.vmap(one))(jnp.asarray(y0), keys, jnp.asarray(conds))
    xi = np.stack([np.array(jax.random.normal(keys[b], (js.K,) + y0.shape[1:]))
                   for b in range(B)], axis=1)
    params = from_jax_params(tree, tdc, device="cpu")
    with torch.no_grad():
        ty = t_seq.sequential_sample_batched(t_diff.make_sl_model_fn(params, tdc), ts,
                                             torch.from_numpy(y0), xi=_t(xi), device="cpu",
                                             conds=_t(conds))
    assert_samples_close(ty, jy)
    with pytest.raises(ValueError, match="conds"):
        t_seq.sequential_sample_batched(t_diff.make_sl_model_fn(params, tdc), ts,
                                        torch.from_numpy(y0), xi=_t(xi), device="cpu",
                                        conds=_t(conds[:2]))


def test_param_shapes_of_the_standins():
    _, tdc = configs("policy")
    shapes = param_shapes(tdc)
    assert shapes["cond_proj"] == (4, 64)
    assert shapes["decoder"]["g0"]["attn"]["wq"] == (2, 64, 4, 16)
