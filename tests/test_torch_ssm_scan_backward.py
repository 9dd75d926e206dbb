"""The backward of the port's linear scan (B7) on the CPU: its plain version
``ssm_scan_backward_plain`` against ``jax.vjp`` of the JAX package's oracle
``ssm_scan_ref`` and against autograd through the plain forward loop, and
``linear_scan``'s CPU backward, float32.

The tolerance against JAX is the forward tests' 2e-5: the oracle is an
associative scan, whose vjp sums in another order than the reverse loop.
Against autograd through ``ssm_scan_plain`` the bits are equal: both round
a_{t+1} g_{t+1}, then add G_t, and round g_t h_{t-1}, one step at a time.
The card's kernel is held against the plain version in bits by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssm_scan.ops import (linear_scan, ssm_scan_backward_cuda,
                                              ssm_scan_backward_plain, ssm_scan_cuda,
                                              ssm_scan_plain)

# the ragged shapes of tests/test_torch_ssm_scan.py (L = 1 and D = 1 among
# them), without its Pallas block sizes
SHAPES = [(2, 32, 64), (1, 100, 70), (2, 257, 130), (3, 1, 5), (2, 19, 1)]


@jax.jit
def _oracle_vjp(a, b, G):
    return jax.vjp(ssm_scan_ref, a, b)[1](G)


def _inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 1.0, (B, L, D)).astype(np.float32)
    b = rng.standard_normal((B, L, D)).astype(np.float32)
    G = rng.standard_normal((B, L, D)).astype(np.float32)
    return a, b, G


@pytest.mark.parametrize("B,L,D", SHAPES)
def test_plain_backward_matches_the_vjp_of_the_jax_oracle(B, L, D):
    a, b, G = _inputs(B, L, D, B * L + D)
    want = [np.asarray(x) for x in _oracle_vjp(jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(G))]
    h = ssm_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
    got = ssm_scan_backward_plain(torch.from_numpy(a), h, torch.from_numpy(G))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and tuple(x.shape) == (B, L, D)
        np.testing.assert_allclose(x.numpy(), y, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,L,D", SHAPES)
def test_plain_backward_equals_autograd_through_the_plain_loop(B, L, D):
    a, b, G = (torch.from_numpy(x) for x in _inputs(B, L, D, 5 + B * L + D))
    a.requires_grad_()
    b.requires_grad_()
    h = ssm_scan_plain(a, b)
    want = torch.autograd.grad(h, (a, b), G)
    got = ssm_scan_backward_plain(a.detach(), h.detach(), G)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("B,L,D", SHAPES)
def test_linear_scan_cpu_backward_is_the_plain_version_and_launches_nothing(B, L, D):
    a, b, G = (torch.from_numpy(x) for x in _inputs(B, L, D, 9 + B * L + D))
    a.requires_grad_()
    b.requires_grad_()
    before = linear_scan.launches, linear_scan.backward_launches
    h = linear_scan(a, b)
    da, db = torch.autograd.grad(h, (a, b), G)
    assert (linear_scan.launches, linear_scan.backward_launches) == before
    pa, pb = ssm_scan_backward_plain(a.detach(), h.detach(), G)
    assert torch.equal(da, pa) and torch.equal(db, pb)


def test_linear_scan_backward_takes_a_strided_gradient():
    """A gradient that reaches the backward as a transposed or expanded
    view gives the same da and db as its contiguous copy."""
    a, b, G = (torch.from_numpy(x) for x in _inputs(2, 23, 9, 3))
    a.requires_grad_()
    b.requires_grad_()
    h = linear_scan(a, b)
    strided = G.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    got = torch.autograd.grad(h, (a, b), strided, retain_graph=True)
    want = ssm_scan_backward_plain(a.detach(), h.detach(), G)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # h.sum() hands the backward a gradient of ones with zero strides
    got = torch.autograd.grad(h.sum(), (a, b))
    want = ssm_scan_backward_plain(a.detach(), h.detach(), torch.ones_like(G))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_kernel_wrappers_refuse_cpu_tensors_before_building():
    """The kernels' wrappers take CUDA tensors only; on the CPU they raise
    before any build is tried (the CPU has no nvcc)."""
    t = torch.ones(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_backward_cuda(t, t, t)
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan_cuda(t, t)


def _scan_gradients(out):
    """The upstream gradients that reach each linear_scan backward under
    ``out``'s graph, as the backward node's pre-hooks see them."""
    seen, stack, visited = [], [out.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in visited:
            continue
        visited.add(node)
        if type(node).__name__ == "_LinearScanBackward":
            node.register_prehook(lambda grads: seen.append(grads[0]))
        stack.extend(nxt for nxt, _ in node.next_functions)
    return seen


def test_mamba_mixer_hands_the_scan_a_contiguous_gradient():
    """The C readout's product gives the scan's output a contiguous
    gradient, so the card's backward takes it without a copy."""
    from repro_torch.nn.ssm import mamba_fwd
    from repro_torch.weights import init_lm_params

    cfg = reduced(get_config("hymba-1.5b"))
    params = init_lm_params(cfg, 0, device="cpu")["decoder"]["g0"]["mamba"]
    layer = {k: v[1].requires_grad_() for k, v in params.items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(4))
    out = mamba_fwd(layer, x.requires_grad_(), cfg)
    seen = _scan_gradients(out)
    out.float().square().sum().backward()
    assert len(seen) == 1
    assert seen[0].is_contiguous()
    assert tuple(seen[0].shape) == (2, 24, cfg.d_inner * cfg.ssm_state)
