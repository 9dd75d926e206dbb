"""The port's core (schedules, sequential sampler, GMM oracle, GRS, verifier,
device rule) against the JAX package, fed the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analytic as j_an
from repro.core.grs import grs as j_grs_fn, grs_reject_prob as j_reject_prob
from repro.core import schedules as j_sch
from repro.core import sequential as j_seq
from repro.core import verifier as j_ver
from repro.kernels.grs.ops import grs as j_grs_kernel
from repro_torch.core import analytic as t_an
from repro_torch.core import asd as t_asd
from repro_torch.core import grs as t_grs
from repro_torch.core import schedules as t_sch
from repro_torch.core import sequential as t_seq
from repro_torch.core import verifier as t_ver
from repro_torch.kernels.grs import ops as t_grs_ops
from repro_torch.configs.registry import paper_diffusion_policy_smoke
from repro_torch.weights import from_jax_params, init_denoiser_params


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.mark.parametrize("name,args", [
    ("sl_uniform", (16,)), ("sl_uniform", (33, 0.5, 8.0)),
    ("sl_geometric", (64, 0.05, 50.0)), ("sl_geometric", (10,)),
    ("ddpm", (12,)), ("ddpm", (50, "linear")),
])
def test_schedule_tables_match(name, args):
    js, ts = getattr(j_sch, name)(*args), getattr(t_sch, name)(*args)
    for field in ("t_model", "A", "B", "sigma"):
        np.testing.assert_allclose(_np(getattr(ts, field)), _np(getattr(js, field)),
                                   rtol=1e-7, atol=0)
        assert getattr(ts, field).dtype == torch.float32
    assert (ts.kind, ts.y0_mode, ts.K) == (js.kind, js.y0_mode, js.K)
    jp, tp = js.pad(5), ts.pad(5)
    for field in ("t_model", "A", "B", "sigma"):
        np.testing.assert_array_equal(_np(getattr(tp, field)), _np(getattr(jp, field)))


@pytest.mark.parametrize("kind", ["cosine", "linear"])
def test_ddpm_coeffs_match(kind):
    for a, b in zip(t_sch.ddpm_coeffs(20, kind), j_sch.ddpm_coeffs(20, kind)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-7, atol=0)


@pytest.mark.parametrize("d", [2, 5])
def test_sequential_with_noise_matches_on_gmm(d):
    js, ts = j_sch.sl_uniform(16, t_max=8.0), t_sch.sl_uniform(16, t_max=8.0)
    rng = np.random.default_rng(d)
    xi = rng.standard_normal((16, d)).astype(np.float32)
    y0 = np.zeros((d,), np.float32)
    jy = j_seq.sequential_sample_with_noise(
        j_an.sl_mean_fn(j_an.default_gmm(d)), js, jnp.asarray(y0), jnp.asarray(xi))
    ty = t_seq.sequential_sample_with_noise(
        t_an.sl_mean_fn(t_an.default_gmm(d)), ts, torch.from_numpy(y0),
        torch.from_numpy(xi), device="cpu")
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=0)


def test_sequential_batched_and_trajectory_agree_with_single_chains():
    ts = t_sch.ddpm(12)
    model = t_an.ddpm_x0_fn(t_an.default_gmm(3), t_sch.ddpm_coeffs(12)[2])
    rng = np.random.default_rng(0)
    y0 = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((12, 3, 3)).astype(np.float32))
    yb = t_seq.sequential_sample_batched(model, ts, y0, xi=xi, device="cpu")
    for b in range(3):
        ys = t_seq.sequential_sample_with_noise(model, ts, y0[b], xi[:, b], device="cpu")
        np.testing.assert_allclose(_np(yb[b]), _np(ys), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    y_fin, traj = t_seq.sequential_sample(model, ts, y0[0], generator=g,
                                          return_trajectory=True, device="cpu")
    assert traj.shape == (13, 3)
    torch.testing.assert_close(traj[-1], y_fin)
    torch.testing.assert_close(traj[0], y0[0])


def test_ddpm_oracle_matches():
    abar = j_sch.ddpm_coeffs(12)[2]
    rng = np.random.default_rng(3)
    t = rng.integers(0, 12, (5,)).astype(np.float32)
    y = rng.standard_normal((5, 2)).astype(np.float32)
    jo = j_an.ddpm_x0_fn(j_an.default_gmm(2), abar)(jnp.asarray(t), jnp.asarray(y))
    to = t_an.ddpm_x0_fn(t_an.default_gmm(2), torch.from_numpy(_np(abar)))(
        torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(_np(to), _np(jo), atol=1e-5)


def _grs_inputs(R, D, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(R,)).astype(np.float32)
    xi = rng.standard_normal((R, D)).astype(np.float32)
    mh = rng.standard_normal((R, D)).astype(np.float32)
    m = (mh + 0.4 * rng.standard_normal((R, D)) / np.sqrt(D)).astype(np.float32)
    sig = (np.abs(rng.standard_normal((R,))) * 0.5 + 0.05).astype(np.float32)
    if R > 2:
        sig[0] = 0.0  # sigma == 0 row with v != 0: always reject
        m[1] = mh[1]  # v == 0 row: always accept, no reflection
        sig[2] = 0.0
        m[2] = mh[2]  # sigma == 0 and v == 0: accept
    return u, xi, mh, m, sig


def _log_margin(u, xi, mh, m, sig):
    """|log u - min(log_ratio, 0)| per row, in float64."""
    v = (mh - m).astype(np.float64)
    vv, vx = (v * v).sum(-1), (v * xi).sum(-1)
    s = np.where(sig > 0, sig, 1.0).astype(np.float64)
    lr = -(vx / s + vv / (2 * s * s))
    return np.abs(np.log(np.maximum(u, 1e-20)) - np.minimum(lr, 0.0))


@pytest.mark.parametrize("R,D", [(1, 1), (6, 5), (32, 300), (9, 4097)])
def test_plain_grs_matches_core_and_pallas_interpret(R, D):
    u, xi, mh, m, sig = _grs_inputs(R, D, R * 7 + D)
    tz, ta = t_grs_ops.grs(*(torch.from_numpy(a) for a in (u, xi, mh, m, sig)))
    near = (_log_margin(u, xi, mh, m, sig) < 1e-5) & (sig > 0)
    for jz, ja in (j_grs_fn(*(jnp.asarray(a) for a in (u, xi, mh, m, sig))),
                   j_grs_kernel(*(jnp.asarray(a) for a in (u, xi, mh, m, sig)))):
        np.testing.assert_allclose(_np(tz), _np(jz), atol=1e-5, rtol=0)
        assert np.array_equal(_np(ta)[~near], _np(ja)[~near])
    if R > 2:
        assert not _np(ta)[0] and _np(ta)[1] and _np(ta)[2]
        np.testing.assert_allclose(_np(tz)[0], m[0], atol=1e-6)  # sigma 0: z = m
    assert t_grs_ops.grs.launches == 0  # CPU tensors never reach the kernel


def test_plain_grs_multidim_event_and_reject_prob():
    rng = np.random.default_rng(5)
    u = rng.uniform(size=(3, 4)).astype(np.float32)
    xi, mh = (rng.standard_normal((3, 4, 2, 5)).astype(np.float32) for _ in range(2))
    m = (mh + 0.3 * rng.standard_normal((3, 4, 2, 5))).astype(np.float32)
    sig = (rng.uniform(size=(3, 4)) + 0.2).astype(np.float32)
    jz, ja = j_grs_fn(*(jnp.asarray(a) for a in (u, xi, mh, m, sig)), event_ndim=2)
    tz, ta = t_grs.grs(*(torch.from_numpy(a) for a in (u, xi, mh, m, sig)), event_ndim=2)
    np.testing.assert_allclose(_np(tz), _np(jz), atol=1e-5)
    near = _log_margin(u.reshape(-1), xi.reshape(12, -1), mh.reshape(12, -1),
                       m.reshape(12, -1), sig.reshape(-1)).reshape(3, 4) < 1e-5
    assert np.array_equal(_np(ta)[~near], _np(ja)[~near])
    jp = j_reject_prob(jnp.asarray(mh), jnp.asarray(m), jnp.asarray(sig), 2)
    tp = t_grs.grs_reject_prob(torch.from_numpy(mh), torch.from_numpy(m),
                               torch.from_numpy(sig), 2)
    np.testing.assert_allclose(_np(tp), _np(jp), atol=1e-6)


def test_grs_reject_rate_follows_closed_form():
    """Thm 12: P[reject] = TV, estimated over many independent rows."""
    gen = torch.Generator().manual_seed(0)
    n, d = 20000, 8
    mh = torch.zeros(n, d)
    m = torch.zeros(n, d)
    m[:, 0] = 0.8
    sig = torch.full((n,), 1.0)
    xi = torch.randn(n, d, generator=gen)
    u = torch.rand(n, generator=gen)
    _, acc = t_grs.grs(u, xi, mh, m, sig)
    p = float(t_grs.grs_reject_prob(mh[:1], m[:1], sig[:1])[0])
    assert abs((1 - acc.float().mean().item()) - p) < 4 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("n_valid", [None, 3, 1])
def test_verify_matches(n_valid):
    u, xi, mh, m, sig = _grs_inputs(6, 7, 11)
    m = (mh + 0.02 * (m - mh)).astype(np.float32)  # mostly accepted
    m[3] = mh[3] + 5.0  # a sure rejection at slot 3
    jz, jadv, jacc = j_ver.verify(*(jnp.asarray(a) for a in (u, xi, mh, m, sig)),
                                  n_valid=None if n_valid is None else jnp.asarray(n_valid))
    tz, tadv, tacc = t_ver.verify(*(torch.from_numpy(a) for a in (u, xi, mh, m, sig)),
                                  n_valid=n_valid)
    np.testing.assert_allclose(_np(tz), _np(jz), atol=1e-5)
    assert int(tadv) == int(jadv)
    assert np.array_equal(_np(tacc), _np(jacc))
    acc = torch.tensor([[1, 1, 0, 1], [0, 1, 1, 1], [1, 1, 1, 1]], dtype=torch.bool)
    assert t_ver.leading_true_count(acc, dim=1).tolist() == [2, 0, 4]


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dc = paper_diffusion_policy_smoke()
    sched = t_sch.sl_uniform(4)
    model = t_an.sl_mean_fn(t_an.default_gmm(2))
    y0 = torch.zeros(2)
    params = init_denoiser_params(dc, 0, device="cpu")
    tree = {k: v for k, v in params.items()}
    calls = [
        lambda d: t_asd.asd_sample(model, sched, y0, 2, device=d),
        lambda d: t_asd.asd_sample_batched(model, sched, y0[None], 2, device=d),
        lambda d: t_seq.sequential_sample(model, sched, y0, device=d),
        lambda d: init_denoiser_params(dc, 0, device=d),
        lambda d: from_jax_params(jax.tree_util.tree_map(lambda t: t.numpy(), tree),
                                  dc, device=d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call("cuda")
        call("cpu")
