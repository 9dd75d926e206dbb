"""The port's superstep program cache against the JAX worker's on the
auto ladders, on the CPU (the helpers of ``test_torch_programs.py``):
auto R and auto budget build the same keys, the fused round keys on
``(R, "data")`` with one program per R, and one program serves two serve
waves."""

import pytest

from tests.test_torch_programs import _assert_same_cache, _engines, _serve_both

_LADDER_R = {1, 2, 4, 8, 16}


@pytest.mark.parametrize("kw", [
    dict(execution="unpacked", rounds_per_sync="auto"),
    dict(execution="packed", round_budget="auto", rounds_per_sync="auto",
         controller="accept-rate"),
], ids=["unpacked-auto-R", "packed-auto-R-auto-budget"])
def test_auto_ladders_build_the_same_programs(kw):
    """K 64: auto R leaves 1 (it opens at K / theta / 8 = 2)."""
    jeng, teng = _engines(64, **kw)
    _serve_both(jeng, teng, 64, range(3))
    _assert_same_cache(jeng, teng)
    rs = {r for r, _ in teng._superstep_fns}
    assert rs <= _LADDER_R and rs != {1}


def test_fused_budget_coordinate_is_data():
    """The fused round keys on (R, "data"): one program per R serves every
    tier of the auto ladder (JAX's tests/test_fused_round.py)."""
    jeng, teng = _engines(64, execution="packed", round_impl="fused", round_budget="auto",
                          rounds_per_sync="auto", controller="accept-rate")
    _serve_both(jeng, teng, 64, range(3))
    _assert_same_cache(jeng, teng)
    assert {b for _, b in teng._superstep_fns} == {"data"}
    assert len(teng._superstep_fns) == len({r for r, _ in teng._superstep_fns})


@pytest.mark.parametrize("kw", [
    dict(execution="unpacked"),
    dict(execution="packed", round_budget=6, controller="accept-rate"),
], ids=["unpacked", "packed"])
def test_one_program_across_two_waves(kw):
    """rounds_per_sync=3: many boundaries, two serve waves and every window
    mix run one program (JAX's tests/test_superstep.py)."""
    K = 12
    jeng, teng = _engines(K, rounds_per_sync=3, **kw)
    _serve_both(jeng, teng, K, range(5))
    _serve_both(jeng, teng, K, range(3), seed0=300)
    _assert_same_cache(jeng, teng)
    assert [k[0] for k in teng._superstep_fns] == [3]
    assert teng._compiled_supersteps == 1
    assert next(iter(teng._superstep_fns.values())).calls == teng.stats.supersteps
