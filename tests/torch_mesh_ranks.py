"""The ranks' side of ``tests/test_torch_mesh_train.py``: what each rank of a
mesh of ranks computes, in a module that imports no JAX (the ranks are
spawned processes, and import this module by name).

``rank_cases(group, inputs, names, tmp)`` runs the mesh trainer's cases on
this rank, from the numpy inputs the test wrote (the JAX init's params as a
flat ``{"<arch>/<path>": array}`` map, and the steps' batches), and returns
numpy results: each case's step-1 gradient blocks, losses, grad norms,
final param and AdamW blocks, resident bytes, and the planted faults, the
resume across meshes and ``restore_sharded`` of a JAX checkpoint."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.launch import train as t_train
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.nn import attention, moe
from repro_torch.training.loop import LoopConfig, run
from repro_torch.weights import from_jax_lm_params, lm_param_shapes

TINY, MOE = "tinyllama-1.1b", "qwen3-moe-30b-a3b"
STEPS, BATCH, SEQ, LR = 3, 8, 16, 3e-3
# at reduced widths no leaf reaches the layouts' 65,536 elements: both
# packages shard leaves of this many (param_pspecs' model fallback, FSDP)
MIN_SHARD = 512
# name -> (arch, mesh, layout, accum): every mesh in both layouts, each
# layout at accum 1 (2x1, 2x1x1) and 2 (1x2, 2x2), and the MoE on the
# model axis and on the data axis (its aux loss the whole batch's); the
# JAX reference of a case is the JAX build's step on its (arch, mesh,
# accum).  The MoE's batches carry a mask whose count differs between the
# two halves of the rows (the mean is the whole batch's)
CASES = {
    "2x1_param_a1": (TINY, "2x1", "param", 1),
    "2x1_fsdp_a1": (TINY, "2x1", "fsdp", 1),
    "1x2_param_a2": (TINY, "1x2", "param", 2),
    "1x2_fsdp_a2": (TINY, "1x2", "fsdp", 2),
    "2x2_param_a2": (TINY, "2x2", "param", 2),
    "2x2_fsdp_a2": (TINY, "2x2", "fsdp", 2),
    "2x1x1_param_a1": (TINY, "2x1x1", "param", 1),
    "2x1x1_fsdp_a1": (TINY, "2x1x1", "fsdp", 1),
    "moe_1x2_param_a1": (MOE, "1x2", "param", 1),
    "moe_2x1_param_a1": (MOE, "2x1", "param", 1),
}
# the planted faults: case -> fault (each run for its step-1 gradient)
FAULTS = {"2x1_param_a1": "no_data_mean", "1x2_param_a2": "no_f_on_kv",
          "moe_2x1_param_a1": "block_aux"}
# resume: RESUME_FROM's mesh saves at step 2, RESUME_TO's resumes to 4
RESUME_FROM, RESUME_TO, RESUME_STEPS = "2x1", "1x2", 4
# the layouts restore_sharded is held against on the 2x2 mesh
RESTORE_LAYOUTS = ("param", "fsdp")


def reference(name: str) -> str:
    """The key of a case's JAX run: its (arch, mesh, accum)."""
    arch, mesh, _, accum = CASES[name]
    return f"{arch}/{mesh}/a{accum}"


def wait_for(path: str, timeout_s: float = 600.0) -> None:
    """The JAX side writes the params (renamed into place when whole)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout_s:
            raise TimeoutError(f"no {path} after {timeout_s} s")
        time.sleep(0.05)


def world_of(mesh: str) -> int:
    return int(np.prod([int(x) for x in mesh.split("x")]))


def config(arch: str):
    return reduced(get_config(arch))


def params_of(flat: dict, arch: str) -> dict:
    cfg = config(arch)
    shapes = lm_param_shapes(cfg)
    tree = pytree.unflatten(shapes, [flat[f"{arch}/{'/'.join(p)}"]
                                     for p, _ in pytree.paths(shapes)])
    return from_jax_lm_params(tree, cfg, device="cpu")


def batch_at(flat: dict, arch: str, step: int, accum: int = 1) -> dict:
    out = {}
    for k in ("tokens", "labels", "mask"):
        if f"{arch}/batch{step}/{k}" not in flat:
            continue
        x = torch.from_numpy(flat[f"{arch}/batch{step}/{k}"])
        out[k] = x.reshape((accum, x.shape[0] // accum) + x.shape[1:]) if accum > 1 else x
    return out


def _np(tree) -> dict:
    return {"/".join(p): leaf.detach().numpy().copy() for p, leaf in pytree.paths(tree)}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.leaves(tree))


@contextlib.contextmanager
def planted(fault: str | None, step=None):
    """``no_data_mean``: the mesh step sums the data ranks' gradients
    instead of averaging them; ``no_f_on_kv``: attention's K / V skip the
    psum of their gradient before the head slice (its input keeps it);
    ``block_aux``: the MoE's aux loss from each data rank's own block of
    the batch (no mean of the routing fractions over the data ranks)."""
    if fault == "no_data_mean":
        real = step._reduce
        step._reduce = lambda g, i: real(g, i) * step.n_batch
        try:
            yield
        finally:
            del step._reduce
    elif fault == "no_f_on_kv":
        real, calls = attention.psum_bwd, [0]

        def psum_bwd(x, group):  # called for x, then k, then v
            calls[0] += 1
            return real(x, group) if calls[0] % 3 == 1 else x

        attention.psum_bwd = psum_bwd
        try:
            yield
        finally:
            attention.psum_bwd = real
    elif fault == "block_aux":
        real = moe.pmean_fwd
        moe.pmean_fwd = lambda x, group: x
        try:
            yield
        finally:
            moe.pmean_fwd = real
    else:
        yield


def one_case(group, flat: dict, name: str) -> dict:
    arch, spec, layout, accum = CASES[name]
    cfg = config(arch)
    mesh = make_rank_mesh(group, spec)
    step, init, lay = t_train.build(cfg, mesh, accum, LR, STEPS, layout, device="cpu",
                                    pre_split=accum > 1, min_shard_elems=MIN_SHARD)
    params, opt = init(params_of(flat, arch))
    out = {"init": _np(params), "tp": sorted("/".join(p) for p in lay.tp)}
    _, _, grads = step.gradients(params, batch_at(flat, arch, 0, accum))
    out["grads"] = _np(grads)
    if name in FAULTS:
        with planted(FAULTS[name], step):
            out["fault_grads"] = _np(step.gradients(params, batch_at(flat, arch, 0, accum))[2])
    losses, norms = [], []
    for s in range(STEPS):
        params, opt, m = step(params, opt, batch_at(flat, arch, s, accum))
        assert m["finite"]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    shapes = lm_param_shapes(cfg)
    out.update(losses=losses, grad_norms=norms, params=_np(params), mu=_np(opt["mu"]),
               nu=_np(opt["nu"]), param_bytes=_bytes(params),
               mu_nu_bytes=_bytes(opt["mu"]) + _bytes(opt["nu"]),
               layout_param_bytes=lay.resident_bytes(shapes, lay.params),
               layout_mu_nu_bytes=2 * lay.resident_bytes(shapes, lay.opt["mu"]))
    return out


def resume_case(group, flat: dict, tmp: str) -> dict:
    """Two steps on RESUME_FROM into a checkpoint, resumed on RESUME_TO
    to RESUME_STEPS, against the straight RESUME_TO run."""
    cfg = config(TINY)
    ckpt_dir = os.path.join(tmp, "resume")
    out = {}
    for spec, total, directory in ((RESUME_FROM, 2, ckpt_dir),
                                   (RESUME_TO, RESUME_STEPS, ckpt_dir),
                                   (RESUME_TO, RESUME_STEPS, None)):
        mesh = make_rank_mesh(group, spec)
        step, init, lay = t_train.build(cfg, mesh, 1, LR, RESUME_STEPS, device="cpu",
                                        min_shard_elems=MIN_SHARD)
        params, opt = init(params_of(flat, TINY))
        params, opt, last, hist = run(
            step, params, opt, lambda s: batch_at(flat, TINY, s), 1,
            LoopConfig(total_steps=total, ckpt_dir=directory, ckpt_every=100),
            device="cpu", layout=lay)
        key = "straight" if directory is None else spec
        out[key] = dict(last=last, losses=[h["loss"] for h in hist], params=_np(params))
    return out


def restore_case(group, flat: dict, tmp: str) -> dict:
    """This rank's ``restore_sharded`` blocks of the JAX checkpoint the
    test wrote, under each of RESTORE_LAYOUTS on the 2x2 mesh."""
    cfg = config(TINY)
    mesh = make_rank_mesh(group, "2x2")
    out = {}
    for layout in RESTORE_LAYOUTS:
        lay = t_train.mesh_layout(cfg, mesh, layout, MIN_SHARD)
        target = lay.shard(params_of(flat, TINY))
        tree, manifest = t_ckpt.restore_sharded(os.path.join(tmp, "jax_ckpt"),
                                                {"params": target},
                                                {"params": lay.params}, mesh)
        out[layout] = dict(step=manifest["step"], params=_np(tree["params"]))
    return out


def rank_cases(group, batches: str, params, names, tmp: str) -> dict:
    torch.set_num_threads(1)  # the ranks share the test's CPU
    flat = dict(np.load(batches))
    for path in params:
        wait_for(path)
        flat.update(np.load(path))
    out = {"rank": group.rank, "cases": {}}
    for name in names:
        out["cases"][name] = one_case(group, flat, name)
    if group.world == 2:
        out["resume"] = resume_case(group, flat, tmp)
    if group.world == 4:
        out["restore"] = restore_case(group, flat, tmp)
    return out


def cli_case(group, inputs: str, arch: str, spec: str, steps: int, accum: int) -> list:
    """The CLI's ``build`` on mesh ``spec`` from the JAX init's params on
    the MarkovLM batches the test wrote: the losses of ``steps`` steps."""
    torch.set_num_threads(1)
    flat = dict(np.load(inputs))
    mesh = make_rank_mesh(group, spec)
    step, init, lay = t_train.build(config(arch), mesh, accum, LR, steps, device="cpu",
                                    pre_split=accum > 1)
    params, opt = init(params_of(flat, arch))
    _, _, last, hist = run(step, params, opt, lambda s: batch_at(flat, arch, s, accum), 1,
                           LoopConfig(total_steps=steps), device="cpu", layout=lay)
    return [h["loss"] for h in hist]


def compression_case(group, inputs: str) -> dict:
    """``tests/test_torch_compression.py``'s ranks: this rank's leaves of
    the inputs through ``int8_psum_tree`` over the two-rank group, with no
    generator, and through ``make_compressed_pod_allreduce`` on a 2x1x1
    mesh; then with a generator (the same seed on both ranks)."""
    from repro_torch.distributed.compression import (int8_psum_tree,
                                                     make_compressed_pod_allreduce)

    torch.set_num_threads(1)
    flat = dict(np.load(inputs))
    tree = {k.split("/", 1)[1]: torch.from_numpy(v[group.rank])
            for k, v in flat.items() if k.startswith("grads/")}
    mesh = make_rank_mesh(group, "2x1x1")
    gen = torch.Generator().manual_seed(5)
    return {"psum": {k: v.numpy() for k, v in int8_psum_tree(tree, group).items()},
            "pod": {k: v.numpy() for k, v in make_compressed_pod_allreduce(mesh)(tree).items()},
            "stochastic": {k: v.numpy() for k, v in
                           int8_psum_tree(tree, mesh.group("pod"), gen).items()}}
