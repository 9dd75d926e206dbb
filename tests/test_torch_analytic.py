"""The port's cells and analytic cost model against the JAX package's:
``InputShape`` and the four shapes, ``param_count_estimate``,
``SUBQUADRATIC``, ``shapes_for`` and ``all_cells``, and every function of
``analysis/analytic.py`` for each of the 10 archs at each of the 4 shapes,
equal exactly (the same arithmetic in the same order)."""

import dataclasses

import pytest

from repro.analysis import analytic as j_an
from repro.configs import archs as j_archs
from repro.configs import base as j_base
from repro.configs import registry as j_registry
from repro_torch.analysis import analytic as t_an
from repro_torch.configs import archs as t_archs
from repro_torch.configs import base as t_base
from repro_torch.configs import registry as t_registry


def _shape(s):
    return dataclasses.asdict(s)


def test_the_cells_are_the_jax_packages():
    assert [_shape(s) for s in t_base.ALL_SHAPES] == [_shape(s) for s in j_base.ALL_SHAPES]
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert _shape(getattr(t_base, name)) == _shape(getattr(j_base, name))
    assert t_archs.SUBQUADRATIC == j_archs.SUBQUADRATIC
    assert list(t_archs.ARCHS) == list(j_archs.ARCHS)
    for name in t_archs.ARCHS:
        assert [_shape(s) for s in t_registry.shapes_for(name)] == \
            [_shape(s) for s in j_registry.shapes_for(name)]
    t_cells, j_cells = t_registry.all_cells(), j_registry.all_cells()
    assert len(t_cells) == 40 and sum(skip for *_, skip in t_cells) == 8
    assert [(n, _shape(s), k) for n, s, k in t_cells] == \
        [(n, _shape(s), k) for n, s, k in j_cells]


@pytest.mark.parametrize("name", list(j_archs.ARCHS))
def test_analytic_is_the_jax_packages(name):
    tcfg, jcfg = t_registry.get_config(name), j_registry.get_config(name)
    n = tcfg.param_count_estimate()
    assert n == jcfg.param_count_estimate() > 0
    assert t_an.params_active(tcfg, n) == j_an.params_active(jcfg, n)
    for desc_t, desc_j in zip(tcfg.group, jcfg.group):
        for L, w in ((4096, desc_t.window), (1, 0), (32768, 1024)):
            assert t_an.block_fwd_flops(tcfg, desc_t, L, w) == \
                j_an.block_fwd_flops(jcfg, desc_j, L, w)
    for ts, js in zip(t_base.ALL_SHAPES, j_base.ALL_SHAPES):
        L, B = ts.seq_len, ts.global_batch
        assert t_an.model_fwd_flops(tcfg, L) == j_an.model_fwd_flops(jcfg, L)
        assert t_an.decode_step_flops(tcfg, L) == j_an.decode_step_flops(jcfg, L)
        assert t_an.kv_cache_bytes(tcfg, B, L) == j_an.kv_cache_bytes(jcfg, B, L)
        assert t_an.mamba_fwd_flops(tcfg, L) == j_an.mamba_fwd_flops(jcfg, L)
        for kw in ({}, dict(accum=1, remat=False)):
            assert t_an.analyze_cell(tcfg, ts, n, **kw).as_dict() == \
                j_an.analyze_cell(jcfg, js, n, **kw).as_dict()
