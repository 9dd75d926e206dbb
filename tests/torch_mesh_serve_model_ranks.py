"""The ranks' side of ``tests/test_torch_mesh_serve_model.py``: what each rank
of a serve mesh with a ``model`` axis computes, in a module that imports no
JAX (the ranks are spawned processes, and import this module by name).

``rank_cases(group, meshes, inputs, fused, cli_argvs)`` runs, on this rank
and on each mesh of ``meshes``, the continuous engine of every config of
``CONFIGS`` (its slots by ``chain_state_shardings``, its weights by a
``ServeLayout``) from the numpy params the test wrote, stepping it boundary
by boundary and keeping a digest of its block of every ``ASDChainState``
field at each; the MoE denoiser's engine where the mesh is in
``MOE_MESHES``; with ``fused`` the fused sampler of each config on the
first mesh (its block of chains, rounds run eagerly); last the serve CLI's
rank function on each of ``cli_argvs``.  ``reference_cases`` runs the same
engines and samplers at 1 x 1, in the test's own process."""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.configs.registry import get_denoiser_config
from repro_torch.core import prng
from repro_torch.core import schedules as t_sch
from repro_torch.core.asd import ASDChainState, asd_sample_batched
from repro_torch.distributed.sharding import ServeLayout, chain_state_shardings
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models.diffusion import make_ddpm_model_fn
from repro_torch.nn.param import param_axes
from repro_torch.serving.engine import ContinuousASDEngine
from repro_torch.serving.worker import Request
from repro_torch.weights import from_jax_params, param_shapes

POLICY, MOE = "paper-diffusion-policy-smoke", "qwen3-moe-a3b-smoke"
# name -> (registry config, backbone overrides).  "dense" is the policy
# smoke narrowed to d_model 256 over 4 heads of 64: its wk and wv (2 x 256
# x 4 x 64 elements) and its time MLP (256 x 256) reach param_pspecs'
# 65,536-element fallback, which cuts them on their largest dim; they are
# no tensor-parallel leaves, so a rank gathers them at every model call
CONFIGS = {
    "policy": (POLICY, {}),
    "dense": (POLICY, dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=512)),
    "moe": (MOE, {}),
}
# the configs each mesh serves (the MoE denoiser on 1x2 only)
ENGINE_CONFIGS = ("policy", "dense")
MOE_MESHES = ("1x2",)
K, THETA, SLOTS, N_REQ, CHAINS = 10, 4, 4, 6, 4
COUNTERS = ("rounds", "head_calls", "model_evals", "accepts", "proposals")


def config(name: str):
    base, over = CONFIGS[name]
    dc = get_denoiser_config(base)
    return dc if not over else dataclasses.replace(
        dc, backbone=dataclasses.replace(dc.backbone, **over))


def params_tree(flat: dict, name: str, dc):
    """The numpy params of config ``name`` from the flat map, as a tree."""
    shapes = param_shapes(dc)
    leaves = [flat[f"{name}/{'/'.join(path)}"] for path, _ in pytree.paths(shapes)]
    return pytree.unflatten(shapes, leaves)


def requests(dc):
    rng = np.random.default_rng(100)
    return [Request(i, key=np.array([0, 100 + i], np.uint32),
                    y0=rng.standard_normal((dc.seq_len, dc.d_data)).astype(np.float32))
            for i in range(N_REQ)]


def fused_y0(dc) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (CHAINS, dc.seq_len, dc.d_data)).astype(np.float32)


def counters(eng) -> dict:
    return {m.rid: tuple(getattr(m, c) for c in COUNTERS) for m in eng.stats.per_request}


def _kw():
    return dict(num_slots=SLOTS, theta=THETA, eager_head=True, noise_mode="counter",
                keep_trajectory=False, device="cpu")


def mesh_engine(dc, params, mesh):
    """(engine, layout) of ``dc`` on this rank of ``mesh``: its block of
    the slots, its blocks of the weights, the model function reading
    ``layout.at_use`` at every call."""
    layout = ServeLayout(param_axes(dc), param_shapes(dc), mesh)
    eng = ContinuousASDEngine(
        lambda p: make_ddpm_model_fn(p, dc, tp_axis=layout.tp_axis, at_use=layout.at_use),
        t_sch.ddpm(K), (dc.seq_len, dc.d_data), state_sharding=chain_state_shardings(mesh),
        model_group=layout.model_group, params=params, param_specs=layout.specs, **_kw())
    return eng, layout


def _digest(eng) -> str:
    """A digest of every ``ASDChainState`` field of this rank's block."""
    h = hashlib.sha256()
    for f in dataclasses.fields(ASDChainState):
        t = getattr(eng._states, f.name)
        if t is not None:
            h.update(f.name.encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def stepped(eng, reqs) -> dict:
    """Submit ``reqs`` and step ``eng`` to the end: its samples, counters
    and the block's digest at each boundary (the first before any)."""
    for r in reqs:
        eng.submit(r)
    digests = [_digest(eng)]
    while eng.step():
        digests.append(_digest(eng))
    digests.append(_digest(eng))
    return dict(samples=eng.drain_results(), counters=counters(eng), digests=digests)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.leaves(tree))


def engine_case(dc, params, mesh) -> dict:
    eng, layout = mesh_engine(dc, params, mesh)
    gathers = layout.gathers
    out = stepped(eng, requests(dc))
    out.update(
        rows=(eng.slot_rows.start, eng.slot_rows.stop), eager=eng._eager,
        resident_bytes=_tree_bytes(eng._params), layout_bytes=layout.local_bytes(params),
        whole_bytes=_tree_bytes(params), gathered_paths=sorted(".".join(p) for p in layout.gathered),
        tp=sorted(".".join(p) for p in layout.tp), calls=layout.gathers - gathers,
        gathered_elements=layout.gathered_elements, rounds=eng.stats.rounds_total,
        local_shapes={".".join(p): tuple(leaf.shape) for p, leaf in pytree.paths(eng._params)},
        specs={".".join(p): tuple(s) for p, s in pytree.paths(layout.specs)})
    return out


def fused(model_fn, dc, y0, eager=False, **keys) -> dict:
    res = asd_sample_batched(model_fn, t_sch.ddpm(K), torch.from_numpy(y0), THETA,
                             eager_head=True, keep_trajectory=False, device="cpu",
                             noise_mode="counter", eager=eager, **keys)
    return {k: getattr(res, k).numpy() for k in ("sample", "rounds", "head_calls")}


def fused_case(dc, params, mesh) -> dict:
    """This rank's block of the fused sampler's chains, its rounds run
    eagerly over the rank's blocks of the weights."""
    layout = ServeLayout(param_axes(dc), param_shapes(dc), mesh)
    fn = make_ddpm_model_fn(layout.shard(params), dc, tp_axis=layout.tp_axis,
                            at_use=layout.at_use)
    rows = chain_state_shardings(mesh).rows(CHAINS)
    with torch.no_grad():
        return fused(fn, dc, fused_y0(dc)[rows], eager=True,
                     keys=prng.split(prng.PRNGKey(1), CHAINS)[rows])


def diverged_case(dc, params, mesh) -> str:
    """The engine of ``dc`` on this rank of ``mesh`` where model rank 1's
    model function adds 1 to its output: the message every rank raises at
    the first boundary (the ranks' counters differ)."""
    layout = ServeLayout(param_axes(dc), param_shapes(dc), mesh)
    bad = mesh.coords["model"] == 1

    def factory(p):
        fn = make_ddpm_model_fn(p, dc, tp_axis=layout.tp_axis, at_use=layout.at_use)
        return (lambda t, y, cond=None: fn(t, y, cond) + 1.0) if bad else fn

    eng = ContinuousASDEngine(
        factory, t_sch.ddpm(K), (dc.seq_len, dc.d_data),
        state_sharding=chain_state_shardings(mesh), model_group=layout.model_group,
        params=params, param_specs=layout.specs, **_kw())
    try:
        eng.serve(requests(dc))
    except RuntimeError as exc:
        return str(exc)
    return "served"


def rank_cases(group, meshes, inputs: str, with_fused: bool = False, cli_argvs=(),
               diverge: bool = False) -> dict:
    torch.set_num_threads(1)  # the ranks share the test's CPU
    data = dict(np.load(inputs))
    params = {name: from_jax_params(params_tree(data, name, config(name)), config(name), "cpu")
              for name in CONFIGS}
    out = {"rank": group.rank, "engines": {}, "fused": {}, "coords": {}}
    for spec in meshes:
        mesh = make_rank_mesh(group, spec)
        out["coords"][spec] = dict(mesh.coords)
        names = ENGINE_CONFIGS + (("moe",) if spec in MOE_MESHES else ())
        for name in names:
            out["engines"][spec, name] = engine_case(config(name), params[name], mesh)
        if with_fused and spec == meshes[0]:
            for name in ENGINE_CONFIGS:
                out["fused"][name] = fused_case(config(name), params[name], mesh)
        if diverge and spec == meshes[0]:
            out["diverged"] = diverged_case(config("policy"), params["policy"], mesh)
    out["cli"] = []
    for argv in cli_argvs:  # last: serve_rank sets the rank's thread count
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            summary = serve.serve_rank(group, argv)
        out["cli"].append((printed.getvalue(), summary))
    return out


def reference_cases(inputs: str) -> dict:
    """The 1 x 1 engines and fused samplers of the same configs, here."""
    data = dict(np.load(inputs))
    out = {"engines": {}, "fused": {}}
    for name in CONFIGS:
        dc = config(name)
        params = from_jax_params(params_tree(data, name, dc), dc, "cpu")
        fn = make_ddpm_model_fn(params, dc)
        eng = ContinuousASDEngine(fn, t_sch.ddpm(K), (dc.seq_len, dc.d_data), **_kw())
        out["engines"][name] = stepped(eng, requests(dc))
        if name in ENGINE_CONFIGS:
            with torch.no_grad():
                out["fused"][name] = fused(fn, dc, fused_y0(dc), key=prng.PRNGKey(1))
    return out
