"""The port's model-parallel layouts against the JAX package's, in process and
with no devices (a ``_FakeMesh``, as the JAX package's tests use):

  * every leaf's logical axes (``param_axes`` / ``lm_param_axes``) against
    ``logical_axes_tree(jax.eval_shape(init))`` for the five paper models and
    a few LM archs (dense, hymba with its 25 heads, MoE, xlstm, cross-attn);
  * ``param_pspecs`` (plain and shape-aware), ``mp_param_pspecs`` (tensor,
    expert, both; model 2, 4 and 16), ``tp_param_pspecs``, ``fsdp_pspecs``,
    ``zero1_pspec`` and ``opt_state_pspecs`` leaf for leaf;
  * the once-only replication warning;
  * ``tp_collective_payloads`` / ``mp_collective_payloads`` at mp 2 and 4,
    sp 1 and 2, and ``sp_compatible``'s answers;
  * ``shard_params`` keeps 1/mp of each sharded leaf in a tensor of its own,
    and the ranks' blocks make the leaf again."""

import logging

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_denoiser_config as j_get_dc
from repro.distributed import sharding as j_sh
from repro.models import diffusion as j_diff
from repro.models.lm import lm_init
from repro.nn import param as j_param
from repro_torch import pytree
from repro_torch.configs.registry import get_config, get_denoiser_config
from repro_torch.distributed import sharding as t_sh
from repro_torch.distributed.group import MeshGroups
from repro_torch.models import diffusion as t_diff
from repro_torch.nn import param as t_param
from repro_torch.weights import init_denoiser_params, lm_param_shapes, param_shapes

PAPER = ("paper-ldm-dit", "paper-pixel-dit", "paper-diffusion-policy",
         "paper-diffusion-policy-smoke", "qwen3-moe-a3b-smoke")
ARCHS = ("tinyllama-1.1b", "hymba-1.5b", "qwen3-moe-30b-a3b", "xlstm-125m",
         "llama-3.2-vision-11b")
MODELS = PAPER + ARCHS


class _FakeMesh:
    """The builders read only ``shape`` and ``axis_names``."""

    def __init__(self, model=2, data=None):
        self.shape = {"model": model} if data is None else {"data": data, "model": model}
        self.axis_names = ("slots", "model") if data is None else ("data", "model")


_BOXED: dict = {}


def _model(name):
    """(JAX boxed abstract tree, port axes, port shapes) of ``name``."""
    if name not in _BOXED:
        key = jax.random.PRNGKey(0)
        if name in PAPER:
            dc = j_get_dc(name)
            boxed = jax.eval_shape(lambda k: j_diff.denoiser_init(k, dc), key)
            t_dc = get_denoiser_config(name)
            axes, shapes = t_param.param_axes(t_dc), param_shapes(t_dc)
        else:
            cfg = j_get_config(name)
            boxed = jax.eval_shape(lambda k: lm_init(k, cfg), key)
            t_cfg = get_config(name)
            axes, shapes = t_param.lm_param_axes(t_cfg), lm_param_shapes(t_cfg)
        _BOXED[name] = (boxed, axes, shapes)
    return _BOXED[name]


def _jax_flat(tree):
    """{path: tuple(leaf)} of a JAX tree of axes tuples or PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (tuple, JP)))[0]
    return {tuple(p.key for p in path): tuple(x) for path, x in flat}


def _port_flat(tree):
    return {path: tuple(x) for path, x in pytree.paths(tree)}


@pytest.mark.parametrize("name", MODELS)
def test_logical_axes_match_jax(name):
    boxed, axes, shapes = _model(name)
    j_axes = _jax_flat(j_param.logical_axes_tree(boxed))
    assert _port_flat(axes) == j_axes
    j_shapes = {tuple(p.key for p in path): tuple(x.shape) for path, x in
                jax.tree_util.tree_flatten_with_path(j_param.unbox(boxed))[0]}
    assert _port_flat(shapes) == j_shapes


@pytest.mark.parametrize("mesh", [None, (16, 16), (2, 2)])
@pytest.mark.parametrize("name", MODELS)
def test_param_pspecs_match_jax(name, mesh):
    boxed, axes, shapes = _model(name)
    fake = None if mesh is None else _FakeMesh(model=mesh[1], data=mesh[0])
    port = t_sh.param_pspecs(axes, shapes, fake)
    assert all(isinstance(s, t_param.PartitionSpec) for s in pytree.leaves(port))
    assert _port_flat(port) == _jax_flat(j_sh.param_pspecs(boxed, fake))


@pytest.mark.parametrize("mode", [(True, False), (False, True), (True, True)],
                         ids=["tensor", "expert", "tensor+expert"])
@pytest.mark.parametrize("model", [2, 4, 16])
@pytest.mark.parametrize("name", MODELS)
def test_mp_param_pspecs_match_jax(name, model, mode):
    boxed, axes, shapes = _model(name)
    tensor, expert = mode
    port = t_sh.mp_param_pspecs(axes, shapes, _FakeMesh(model), tensor=tensor, expert=expert)
    ref = j_sh.mp_param_pspecs(boxed, _FakeMesh(model), tensor=tensor, expert=expert)
    assert _port_flat(port) == _jax_flat(ref)
    if mode == (True, False):
        assert _port_flat(t_sh.tp_param_pspecs(axes, shapes, _FakeMesh(model))) == \
            _jax_flat(j_sh.tp_param_pspecs(boxed, _FakeMesh(model)))


@pytest.mark.parametrize("mesh", [(16, 16), (2, 4)])
@pytest.mark.parametrize("name", MODELS)
def test_fsdp_zero1_and_opt_state_pspecs_match_jax(name, mesh):
    boxed, axes, shapes = _model(name)
    fake = _FakeMesh(model=mesh[1], data=mesh[0])
    port = t_sh.fsdp_pspecs(axes, shapes, fake)
    assert _port_flat(port) == _jax_flat(j_sh.fsdp_pspecs(boxed, fake))
    t_specs = t_sh.param_pspecs(axes, shapes, fake)
    j_specs = j_sh.param_pspecs(boxed, fake)
    for zero1 in (True, False):
        t_opt = t_sh.opt_state_pspecs(t_specs, shapes, fake, zero1=zero1)
        j_opt = j_sh.opt_state_pspecs(j_specs, j_param.unbox(boxed), fake, zero1=zero1)
        assert tuple(t_opt["step"]) == tuple(j_opt["step"]) == ()
        for part in ("mu", "nu"):
            assert _port_flat(t_opt[part]) == _jax_flat(j_opt[part])
    assert _port_flat(t_sh.replicated_pspecs(axes)) == _jax_flat(
        j_sh.replicated_pspecs(boxed))


@pytest.mark.parametrize("spec,shape,mesh", [
    ((), (64, 32), (4, 2)), (("model",), (6, 8), (4, 2)), ((None, "model"), (3, 8), (4, 2)),
    ((), (3, 5), (4, 2)), ((), (8,), (1, 2)),
])
def test_zero1_pspec_matches_jax(spec, shape, mesh):
    fake = _FakeMesh(model=mesh[1], data=mesh[0])
    assert tuple(t_sh.zero1_pspec(t_param.P(*spec), shape, fake)) == tuple(
        j_sh.zero1_pspec(JP(*spec), shape, fake))


def test_batch_pspec_and_logical_to_pspec_match_jax():
    fake = _FakeMesh(model=2, data=4)
    assert tuple(t_sh.batch_pspec(fake, None)) == tuple(j_sh.batch_pspec(fake, None))
    rules = dict(t_sh.LOGICAL_RULES, both=("data", "model"))
    for axes in [None, (), ("embed", "mlp"), ("heads", "mlp", None), ("both", "heads"),
                 ("layers", "experts", "embed", "mlp"), ("vocab", "unknown")]:
        assert tuple(t_param.logical_to_pspec(axes, rules)) == tuple(
            j_param.logical_to_pspec(axes, rules)), axes
    assert t_param.P() == () and t_param.P("model", None) == ("model", None)


def test_a_replicated_leaf_warns_once(monkeypatch, caplog):
    """hymba's 25 heads do not divide a 2-way model axis: its wq, bq and wo
    replicate with one warning each, and a second layout warns no more, as
    in the JAX package."""
    boxed, axes, shapes = _model("hymba-1.5b")
    monkeypatch.setattr(t_sh, "_REPLICATION_WARNED", set())
    monkeypatch.setattr(j_sh, "_REPLICATION_WARNED", set())
    counts = []
    for builder, tree in ((lambda: t_sh.mp_param_pspecs(axes, shapes, _FakeMesh(2)), "port"),
                          (lambda: j_sh.mp_param_pspecs(boxed, _FakeMesh(2)), "jax")):
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            builder()
            first = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
            caplog.clear()
            builder()
            second = [r for r in caplog.records if r.levelno == logging.WARNING]
        assert first and not second, tree
        counts.append(sorted(first))
    assert counts[0] == counts[1]
    assert any("'wq'" in m and "25" in m for m in counts[0])


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("name", PAPER)
def test_collective_payloads_match_jax(name, mp, sp):
    boxed, axes, shapes = _model(name)
    dc, j_dc = get_denoiser_config(name), j_get_dc(name)
    expert = any(d.moe for d in dc.backbone.group)
    t_specs = t_sh.mp_param_pspecs(axes, shapes, _FakeMesh(mp), tensor=sp == 1, expert=expert)
    j_specs = j_sh.mp_param_pspecs(boxed, _FakeMesh(mp), tensor=sp == 1, expert=expert)
    j_params = j_param.unbox(boxed)
    assert t_diff.mp_collective_payloads(shapes, t_specs, dc, mp_size=mp, sp_size=sp) == \
        j_diff.mp_collective_payloads(j_params, j_specs, j_dc, mp_size=mp, sp_size=sp)
    assert t_diff.tp_collective_payloads(shapes, t_specs, dc) == \
        j_diff.tp_collective_payloads(j_params, j_specs, j_dc)


@pytest.mark.parametrize("sp", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("name", PAPER)
def test_sp_compatible_answers_as_jax(name, sp):
    assert t_diff.sp_compatible(get_denoiser_config(name), sp) == \
        j_diff.sp_compatible(j_get_dc(name), sp)


@pytest.mark.parametrize("mode", [(True, False), (False, True)], ids=["tensor", "expert"])
@pytest.mark.parametrize("world", [2, 4])
def test_shard_params_keeps_one_world_th_of_each_sharded_leaf(world, mode):
    dc = get_denoiser_config("qwen3-moe-a3b-smoke")
    params = init_denoiser_params(dc, seed=1, device="cpu")
    specs = t_sh.mp_param_pspecs(t_param.param_axes(dc), param_shapes(dc),
                                 _FakeMesh(world), tensor=mode[0], expert=mode[1])
    shards = [t_sh.shard_params(params, specs, MeshGroups((world,), ("model",), r))
              for r in range(world)]
    n_sharded = 0
    for (path, full), (_, spec) in zip(pytree.paths(params), pytree.paths(specs)):
        locals_ = [t_param_leaf(s, path) for s in shards]
        if "model" not in spec:
            assert all(t is full for t in locals_), path
            continue
        n_sharded += 1
        dim = spec.index("model")
        for t in locals_:
            assert t.is_contiguous() and t.numel() * world == full.numel(), path
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), path
        assert torch.equal(torch.cat(locals_, dim=dim), full), path
    # TP: attention wq and wo (the MoE smoke has no dense FFN); EP: the
    # three expert stacks
    assert n_sharded == (2 if mode[0] else 3)


def t_param_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_shard_params_refuses_a_leaf_that_does_not_divide():
    dc = get_denoiser_config("paper-diffusion-policy-smoke")
    params = init_denoiser_params(dc, seed=0, device="cpu")
    specs = pytree.map(lambda _: t_param.P(), param_shapes(dc))
    specs["in_proj"] = t_param.P("model")  # (d_data 4, d) over 3 ranks
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        t_sh.shard_params(params, specs, MeshGroups((3,), ("model",), 0))


@pytest.mark.parametrize("shards,mp,n", [(2, 2, 4), (3, 2, 8), (1, 4, 4), (2, 3, 5)])
def test_placements_match_jax(shards, mp, n):
    devices = list(range(n))
    assert t_sh.shard_placements(shards * 2, devices) == j_sh.shard_placements(
        shards * 2, devices)
    if shards * mp > n:
        for fn in (t_sh.model_group_placements, j_sh.model_group_placements):
            with pytest.raises(ValueError, match="distinct devices"):
                fn(shards, mp, devices)
    else:
        assert t_sh.model_group_placements(shards, mp, devices) == \
            j_sh.model_group_placements(shards, mp, devices)


def test_collective_probe_needs_a_group():
    assert t_sh.measure_collective_seconds(None, [1024]) == 0.0
    assert t_sh.measure_collective_seconds_by_kind(None, {"psum": [], "all_to_all": [8]}) == {
        "all_to_all": 0.0}
    with pytest.raises(ValueError, match="unknown collective kind"):
        t_sh.measure_collective_seconds(None, [8], kind="all_reduce")
