"""The port's linear scan (kernel B7's plain version on the CPU) against the
JAX package's oracle ``ssm_scan_ref`` and its Pallas kernel in interpret
mode, float32.  The tolerance is the JAX kernel test's 2e-5: the oracle is
an associative scan, which sums in another order than the sequential loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import linear_scan as j_linear_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.kernels.ssm_scan.ops import linear_scan, ssm_scan_plain

# the ragged shapes of tests/test_kernels.py::test_ssm_scan_matches_oracle,
# with its block sizes for the Pallas kernel, plus single-step and
# single-channel edges
SHAPES = [(2, 32, 64, 8, 32), (1, 100, 70, 16, 64), (2, 257, 130, 64, 128),
          (3, 1, 5, 1, 5), (2, 19, 1, 8, 1)]


def _inputs(B, L, D, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 1.0, (B, L, D)).astype(np.float32)
    b = rng.standard_normal((B, L, D)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,L,D,bt,bd", SHAPES)
def test_plain_scan_matches_the_jax_oracle(B, L, D, bt, bd):
    a, b = _inputs(B, L, D, B * L + D)
    h = ssm_scan_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    r = np.asarray(ssm_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(h, r, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,L,D,bt,bd", SHAPES)
def test_linear_scan_matches_the_pallas_kernel(B, L, D, bt, bd):
    a, b = _inputs(B, L, D, 7 + B * L + D)
    before = linear_scan.launches
    h = linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert linear_scan.launches == before  # the plain version launches nothing
    assert h.dtype == torch.float32 and tuple(h.shape) == (B, L, D)
    r = np.asarray(j_linear_scan(jnp.asarray(a), jnp.asarray(b), block_t=bt, block_d=bd,
                                 interpret=True))
    # the Pallas kernel runs the same sequential f32 loop
    np.testing.assert_allclose(h.numpy(), r, atol=2e-5, rtol=2e-5)


def test_linear_scan_on_mamba_like_inputs():
    """decay in (0.8, 0.999) and a small drive, as the mamba mixer scans
    them (tests/test_kernels.py::test_ssm_scan_matches_mamba_inner)."""
    rng = np.random.default_rng(11)
    decay = rng.uniform(0.8, 0.999, (2, 40, 96)).astype(np.float32)
    drive = (0.1 * rng.standard_normal((2, 40, 96))).astype(np.float32)
    h = linear_scan(torch.from_numpy(decay), torch.from_numpy(drive)).numpy()
    np.testing.assert_allclose(h, np.asarray(ssm_scan_ref(jnp.asarray(decay),
                                                          jnp.asarray(drive))), atol=1e-5)


def test_plain_scan_keeps_a_float32_carry_and_returns_a_dtype():
    a = torch.full((1, 300, 2), 1.0, dtype=torch.bfloat16)
    b = torch.full((1, 300, 2), 1.0, dtype=torch.bfloat16)
    h = ssm_scan_plain(a, b)
    assert h.dtype == torch.bfloat16
    # a bfloat16 carry would stop counting at 256; float32 reaches 300
    assert h[0, -1, 0].item() == 300.0


@pytest.mark.parametrize("a_shape,b_shape", [((2, 3), (2, 3)), ((1, 4, 5), (1, 4, 6)),
                                             ((1, 2, 3, 4), (1, 2, 3, 4))])
def test_linear_scan_refuses_mismatched_or_wrong_rank_shapes(a_shape, b_shape):
    with pytest.raises(ValueError):
        linear_scan(torch.ones(a_shape), torch.ones(b_shape))


def test_linear_scan_refuses_a_device_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        linear_scan(torch.ones(1, 2, 3, device="meta"), torch.ones(1, 2, 3, device="meta"))
