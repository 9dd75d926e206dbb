"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; where there is none it skips.
Run on the card with:  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
This file imports no JAX: the machine with the card has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import paper_diffusion_policy_smoke
from repro_torch.core import asd as t_asd
from repro_torch.core import schedules as t_sch
from repro_torch.core.grs import grs as grs_plain
from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha
from repro_torch.kernels.grs.ops import grs
from repro_torch.models.diffusion import make_sl_model_fn
from repro_torch.weights import init_denoiser_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grs_inputs(R, D, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(R, generator=g, device=dev)
    xi = torch.randn(R, D, generator=g, device=dev)
    mh = torch.randn(R, D, generator=g, device=dev)
    m = mh + 0.4 * torch.randn(R, D, generator=g, device=dev) / D ** 0.5
    sig = torch.rand(R, generator=g, device=dev) * 0.5 + 0.05
    if R > 2:
        sig[0] = 0.0
        m[1] = mh[1]
        sig[2] = 0.0
        m[2] = mh[2]
    return u, xi, mh, m, sig


def _near_threshold(u, xi, mh, m, sig):
    v = (mh - m).double()
    vv, vx = (v * v).sum(-1), (v * xi.double()).sum(-1)
    s = torch.where(sig > 0, sig, torch.ones_like(sig)).double()
    lr = -(vx / s + vv / (2 * s * s))
    margin = (torch.log(torch.clamp(u.double(), min=1e-20)) - torch.clamp(lr, max=0)).abs()
    return (margin < 1e-5) & (sig > 0)


@pytest.mark.parametrize("R,D", [(1, 1), (6, 5), (9, 4097), (32, 196608)])
def test_grs_kernel_matches_plain(dev, R, D):
    args = _grs_inputs(R, D, R + D, dev)
    before = grs.launches
    zk, ak = grs(*args)
    torch.cuda.synchronize()
    assert grs.launches == before + 1
    zp, ap = grs_plain(*args)
    torch.testing.assert_close(zk, zp, atol=1e-5, rtol=0)
    near = _near_threshold(*args)
    assert torch.equal(ak[~near], ap[~near])
    if R > 2:
        assert not ak[0] and ak[1] and ak[2]


def test_grs_kernel_refuses_what_it_does_not_take(dev):
    u, xi, mh, m, sig = _grs_inputs(4, 8, 0, dev)
    with pytest.raises(ValueError):
        grs(u, xi.double(), mh, m, sig)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,S,H,hd,causal,window,softcap", [
    (2, 1024, 1024, 16, 64, False, 0, 0.0),
    (3, 16, 16, 4, 64, False, 0, 0.0),
    (2, 40, 40, 3, 16, False, 0, 0.0),
    (2, 40, 40, 3, 16, True, 0, 0.0),
    (1, 200, 200, 2, 32, True, 24, 0.0),
    (1, 130, 130, 2, 32, False, 24, 0.0),
    (2, 70, 70, 2, 64, True, 0, 30.0),
    (2, 100, 100, 4, 72, False, 0, 0.0),
    (1, 33, 77, 2, 128, False, 0, 0.0),
])
def test_flash_kernel_matches_plain(dev, dtype, B, L, S, H, hd, causal, window, softcap):
    g = torch.Generator(device=dev).manual_seed(L + S + hd)
    q, k, v = (torch.randn(B, n, H, hd, generator=g, device=dev).to(dtype)
               for n in (L, S, S))
    before = flash_mha.launches
    ok = flash_mha(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_mha.launches == before + 1
    op = attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    # float32: both sum in float32 in other orders; bfloat16: one rounding of
    # the output to bf16 (8 mantissa bits) on each side
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(ok.float(), op.float(), atol=tol, rtol=tol)


def test_flash_kernel_reads_strided_heads_in_place(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(2, 50, 3, 4, 32, generator=g, device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # non-contiguous views
    torch.testing.assert_close(flash_mha(q, k, v, causal=False),
                               attention_plain(q, k, v, causal=False),
                               atol=2e-5, rtol=2e-5)


def test_smoke_slice_on_card_matches_cpu(dev):
    dc = paper_diffusion_policy_smoke()
    params = init_denoiser_params(dc, 0, out_scale=1.0, device="cpu")
    sched = t_sch.sl_geometric(16, 0.05, 50.0)
    K, theta, B = 16, 4, 3
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(B, K + theta + 1, generator=gen)
    xi = torch.randn(B, K + theta + 1, dc.seq_len, dc.d_data, generator=gen)
    y0 = torch.zeros(B, dc.seq_len, dc.d_data)
    cpu = t_asd.asd_sample_batched(make_sl_model_fn(params, dc), sched, y0, theta,
                                   u_buf=u, xi_buf=xi, device="cpu")
    gpu_params = {k: v for k, v in init_denoiser_params(
        dc, 0, out_scale=1.0, device=dev).items()}
    g0, f0 = grs.launches, flash_mha.launches
    card = t_asd.asd_sample_batched(make_sl_model_fn(gpu_params, dc), sched, y0,
                                    theta, u_buf=u, xi_buf=xi, device=dev)
    rounds = int(card.rounds.max())
    assert grs.launches - g0 == rounds
    assert flash_mha.launches - f0 == 2 * rounds * dc.backbone.n_layers
    for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), name
    # float32 products sum in other orders on the card than on the CPU, and
    # the chain feeds each step's output into the next model call, so the
    # last-bit differences grow over the 16 steps (measured 6e-4 at most on
    # an H100 for this seed): samples agree to 2e-3, counters exactly
    torch.testing.assert_close(card.sample.cpu(), cpu.sample, atol=2e-3, rtol=2e-3)
    assert bool((cpu.accepts < cpu.proposals).any())
    assert np.isfinite(card.sample.cpu().numpy()).all()
