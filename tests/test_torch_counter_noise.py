"""Counter noise and the adaptive window controllers against the JAX
package, on the CPU, with no noise handed over: both packages draw from the
same keys (``repro_torch.core.prng`` is JAX's threefry).

Samplers run ``noise_mode="counter"`` with ``keep_trajectory=False``, the
serve CLI's setting, on the GMM oracle and on a 2-layer denoiser given the
same weights through ``weights.py``, for every controller and both
``eager_head`` values: counters equal and samples within the tolerance of
each model (the normal draws agree within ``prng.NORMAL_ULPS``, so an
accept bit could differ only on a row at the GRS threshold; none does
here)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import paper_diffusion_policy_smoke as j_smoke
from repro.core import analytic as j_an
from repro.core import asd as j_asd
from repro.core import controller as j_ctl
from repro.core import schedules as j_sch
from repro.models.diffusion import make_sl_model_fn as j_make_sl
from repro_torch.configs.registry import paper_diffusion_policy_smoke as t_smoke
from repro_torch.core import analytic as t_an
from repro_torch.core import asd as t_asd
from repro_torch.core import controller as t_ctl
from repro_torch.core import prng
from repro_torch.core import schedules as t_sch
from repro_torch.models.diffusion import make_sl_model_fn as t_make_sl
from repro_torch.weights import from_jax_params
from tests.test_torch_packed_round import smoke_tree

COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals")
CONTROLLERS = {
    "static": {}, "static-value3": {"value": 3}, "aimd": {},
    "aimd-gentle": {"increase": 0.5, "backoff": 0.75},
    "accept-rate": {}, "accept-rate-tuned": {"decay": 0.9, "headroom": 1.5, "prior": 2.0},
}


def _controllers(name):
    kind = name.split("-value")[0].split("-gentle")[0].split("-tuned")[0]
    kw = CONTROLLERS[name]
    return j_ctl.make_controller(kind, **kw), t_ctl.make_controller(kind, **kw)


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controller_windows_equal_jax(name):
    """300 rounds of random accept histories over 32 chains: the windows are
    equal integer for integer and the float32 state bit for bit."""
    jc, tc = _controllers(name)
    B, tmax = 32, 8
    rng = np.random.default_rng(len(name))
    jst, jl = jc.init(tmax)
    jst, jl = jnp.broadcast_to(jst, (B,) + jst.shape), jnp.broadcast_to(jl, (B,))
    tst, tl = tc.init(tmax, B, "cpu")
    assert tl.tolist() == np.asarray(jl).tolist()
    jupdate = jax.jit(jax.vmap(lambda c, w, a, n, r: jc.update(c, w, a, n, r, tmax)))
    for _ in range(300):
        n_valid = rng.integers(0, tmax + 1, B)
        lead = np.minimum(rng.integers(0, tmax + 1, B), n_valid)
        rejected = lead < n_valid
        jst, jl = jupdate(jst, jl, jnp.asarray(lead, jnp.int32), jnp.asarray(n_valid, jnp.int32),
                          jnp.asarray(rejected))
        tst, tl = tc.update(tst, tl, torch.from_numpy(lead), torch.from_numpy(n_valid),
                            torch.from_numpy(rejected), tmax)
        assert tl.tolist() == np.asarray(jl).tolist()
        assert np.array_equal(tst.numpy().view(np.int32), np.asarray(jst).view(np.int32))


def test_make_controller_refuses_an_unknown_name():
    assert sorted(t_ctl.CONTROLLERS) == sorted(j_ctl.CONTROLLERS)
    with pytest.raises(ValueError, match="unknown theta controller"):
        t_ctl.make_controller("pid")


@dataclasses.dataclass
class Model:
    j_fn: object
    t_fn: object
    js: object
    ts: object
    event: tuple
    tol: float


def gmm():
    d, K = 2, 16
    return Model(j_an.sl_mean_fn(j_an.default_gmm(d)), t_an.sl_mean_fn(t_an.default_gmm(d)),
                 j_sch.sl_uniform(K, t_max=8.0), t_sch.sl_uniform(K, t_max=8.0), (d,), 1e-5)


def smoke():
    jdc, tdc = j_smoke(), t_smoke()
    tree = smoke_tree(jdc)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    K = 12
    # t_max 10 keeps SL states below ~50, where chained float32 differences
    # stay within 1e-4 (as in tests/test_torch_slice.py)
    return Model(j_make_sl(jparams, jdc), t_make_sl(from_jax_params(tree, tdc, device="cpu"), tdc),
                 j_sch.sl_geometric(K, 0.05, 10.0), t_sch.sl_geometric(K, 0.05, 10.0),
                 (jdc.seq_len, jdc.d_data), 1e-4)


MODELS = {"gmm": gmm, "smoke": smoke}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    return MODELS[request.param]()


def _assert_same(jr, tr, tol):
    for name in COUNTERS:
        assert getattr(tr, name).tolist() == np.asarray(getattr(jr, name)).tolist(), name
    np.testing.assert_allclose(tr.sample.numpy(), np.asarray(jr.sample), rtol=tol, atol=tol)
    np.testing.assert_allclose(tr.trajectory.numpy(), np.asarray(jr.trajectory), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("ctl", ["static", "aimd", "accept-rate"])
@pytest.mark.parametrize("eager", [False, True])
def test_counter_noise_sampler_matches_jax(model, ctl, eager):
    B, theta = 3, 4
    jc, tc = _controllers(ctl)
    y0 = np.random.default_rng(1).standard_normal((B,) + model.event).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jr = j_asd.asd_sample_batched(model.j_fn, model.js, jnp.asarray(y0), key, theta,
                                  eager_head=eager, noise_mode="counter",
                                  keep_trajectory=False, controller=jc)
    tr = t_asd.asd_sample_batched(model.t_fn, model.ts, torch.from_numpy(y0), theta,
                                  eager_head=eager, keep_trajectory=False, controller=tc,
                                  device="cpu", key=np.asarray(key), noise_mode="counter")
    _assert_same(jr, tr, model.tol)
    assert tr.trajectory.shape == (B, theta + 1) + model.event
    # the reject path ran
    assert int(tr.accepts.sum()) < int(tr.proposals.sum())


def test_one_chain_takes_its_key_unsplit():
    """``asd_sample`` uses its key as the chain's own, as the JAX one does."""
    m = gmm()
    key = jax.random.PRNGKey(3)
    jr = j_asd.asd_sample(m.j_fn, m.js, jnp.zeros(m.event), key, 5, eager_head=True,
                          noise_mode="counter", keep_trajectory=False)
    tr = t_asd.asd_sample(m.t_fn, m.ts, torch.zeros(m.event), 5, eager_head=True,
                          keep_trajectory=False, device="cpu", key=np.asarray(key),
                          noise_mode="counter")
    _assert_same(jr, tr, m.tol)


def test_buffer_mode_with_a_key_draws_jax_buffers():
    m = smoke()
    K, theta, B = m.ts.K, 4, 3
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    y0 = np.zeros((B,) + m.event, np.float32)
    jst = jax.vmap(lambda y, k: j_asd.init_chain_state(m.js, y, k, theta, "buffer"))(
        jnp.asarray(y0), keys)
    tst = t_asd.init_chain_state(m.ts, torch.from_numpy(y0), theta, key=np.asarray(keys))
    for name in ("k_u", "k_xi"):
        assert tst.__dict__[name].tolist() == np.asarray(jst.__dict__[name]).astype(
            np.int64).tolist(), name
    assert np.array_equal(tst.u_buf.numpy().view(np.int32), np.asarray(jst.u_buf).view(np.int32))
    assert tst.xi_buf.shape == (B, K + theta + 1) + m.event
    ulps = np.abs(tst.xi_buf.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jst.xi_buf).view(np.int32).astype(np.int64))
    assert ulps.max() <= prng.NORMAL_ULPS
    # and a buffer-mode run from those buffers is the JAX run
    jr = j_asd.asd_sample_batched(m.j_fn, m.js, jnp.asarray(y0), jax.random.PRNGKey(5), theta,
                                  eager_head=True)
    tr = t_asd.asd_sample_batched(m.t_fn, m.ts, torch.from_numpy(y0), theta, eager_head=True,
                                  device="cpu", key=np.asarray(jax.random.PRNGKey(5)))
    _assert_same(jr, tr, m.tol)


def test_asd_init_y0_draws_jax_y0():
    js, ts = j_sch.ddpm(10), t_sch.ddpm(10)
    key = jax.random.PRNGKey(9)
    jy = np.asarray(j_asd.asd_init_y0(js, key, (16, 14)))
    ty = t_asd.asd_init_y0(ts, np.asarray(key), (16, 14))
    assert ty.shape == (16, 14) and ty.device.type == "cpu"
    ulps = np.abs(ty.numpy().view(np.int32).astype(np.int64) - jy.view(np.int32).astype(np.int64))
    assert ulps.max() <= prng.NORMAL_ULPS


def test_counter_mode_holds_keys_not_buffers():
    m = gmm()
    y0 = torch.zeros((2,) + m.event)
    st = t_asd.init_chain_state(m.ts, y0, 4, False, key=prng.split(prng.PRNGKey(0), 2),
                                noise_mode="counter")
    assert st.u_buf is None and st.xi_buf is None and st.k_u.shape == (2, 2)
    with pytest.raises(ValueError, match="pass key"):
        t_asd.init_chain_state(m.ts, y0, 4, noise_mode="counter")
    with pytest.raises(ValueError, match="holds no buffers"):
        t_asd.asd_round(m.t_fn, m.ts, st, 4, keep_trajectory=False)
    with pytest.raises(ValueError, match="unknown noise_mode"):
        t_asd.init_chain_state(m.ts, y0, 4, key=prng.split(prng.PRNGKey(0), 2),
                               noise_mode="philox")
