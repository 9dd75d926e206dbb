"""The port's roofline (``repro_torch.analysis.roofline``) against the JAX
package's: the same ``Roofline`` terms once the TPU constants are swapped
for the H100's, the same ``as_dict`` keys, ``model_flops`` equal, and the
``CellCost`` -> ``Roofline`` arithmetic of the JAX dry run's lines
386-388 (``t = cost / n_chips / peak``)."""

import pytest

from repro.analysis import roofline as j_rl
from repro_torch.analysis import analytic as t_an
from repro_torch.analysis import roofline as t_rl
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import get_config

# (flops per chip, bytes per chip): compute-bound, memory-bound, equal, zero
TERMS = [(3.2e15, 1.1e11), (2.0e9, 7.5e10), (989.0, 3.35), (0.0, 0.0)]


@pytest.mark.parametrize("flops, nbytes", TERMS)
def test_roofline_terms_are_the_jax_ones_at_the_h100_constants(flops, nbytes):
    t = t_rl.Roofline(flops, nbytes, 0.0, 0.0, {}, {})
    j = j_rl.Roofline(flops, nbytes, 0.0, 0.0, {}, {})
    assert t.t_compute == pytest.approx(j.t_compute * j_rl.PEAK_FLOPS_BF16
                                        / t_rl.PEAK_FLOPS_BF16, rel=1e-15, abs=0)
    assert t.t_memory == pytest.approx(j.t_memory * j_rl.HBM_BW / t_rl.HBM_BW,
                                       rel=1e-15, abs=0)
    assert t.t_collective == j.t_collective == 0.0
    assert t.bound_time() == max(t.t_compute, t.t_memory)
    assert list(t.as_dict()) == list(j.as_dict())
    # the dominant term follows the swapped constants: compare the ratios
    if flops:
        want = "compute" if t.t_compute >= t.t_memory else "memory"
        assert t.dominant == want


def test_the_constants_are_the_h100s():
    assert (t_rl.PEAK_FLOPS_BF16, t_rl.PEAK_FLOPS_F32, t_rl.PEAK_FLOPS_TF32, t_rl.HBM_BW) == \
        (989e12, 67e12, 495e12, 3.35e12)
    assert not hasattr(t_rl, "ICI_BW")
    assert t_rl.peak_flops("bfloat16") == 989e12
    assert t_rl.peak_flops("float32") == 165e12  # 3xTF32 beats the FMAs


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("active", [None, 3_000_000_000])
def test_model_flops_is_the_jax_packages(kind, active):
    for n, tokens in ((1_100_048_384, 4096), (30_532_110_336, 1), (7, 1 << 20)):
        assert t_rl.model_flops(n, tokens, kind, active) == \
            j_rl.model_flops(n, tokens, kind, active)


@pytest.mark.parametrize("n_chips", [256, 512, 1])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_a_cell_cost_gives_the_jax_dry_runs_terms(arch, n_chips):
    cfg = get_config(arch)
    n = cfg.param_count_estimate()
    for shape in ALL_SHAPES:
        cost = t_an.analyze_cell(cfg, shape, n)
        roof = t_rl.analyze(cost, n_chips)
        # src/repro/launch/dryrun.py:386-388 at the port's constants
        assert roof.t_compute == cost.flops / n_chips / t_rl.PEAK_FLOPS_BF16
        assert roof.t_memory == cost.hbm_bytes / n_chips / t_rl.HBM_BW
        assert roof.t_collective == 0.0
        assert roof.as_dict()["coll_counts"] == {}


def test_memory_stats_on_the_cpu_reads_no_peak():
    assert t_rl.memory_stats(1234, "cpu") == {"argument_bytes": 1234, "temp_bytes": None,
                                              "peak_bytes": None}
