"""The LM trainer from the command line, the port's counterpart of the JAX
package's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --scale full --steps 20 --batch 8 --ckpt-dir /path/to/ckpts

It trains ``--arch`` (``--scale smoke``: its ``reduced`` config; ``full``:
the published widths) on ``MarkovLM`` token streams with ``lm_loss``
(the naive attention core) and AdamW on a cosine schedule (warmup
max(10, steps / 20)), through ``repro_torch.training.loop.run``: gradient
accumulation over ``--accum`` microbatches, remat where the config sets
it, the NaN guard, checkpoints every max(10, steps / 4) steps in the JAX
layout under ``--ckpt-dir`` and resume from the latest one there.  It
prints ``step s: loss x`` every 5 steps and ``done at step s: loss a -> b``.

The flags, their names and defaults are the JAX CLI's, with two
differences: ``--mesh`` defaults to ``1x1`` (the JAX CLI's ``2x4`` would
put eight ranks on one card), and ``--device`` picks the device (default
the card; ``cpu`` runs the kernels' plain versions).  The params are
``lm_init_params`` from a generator at seed 0, the JAX init's law.  The MoE
archs (dbrx-132b, qwen3-moe-30b-a3b) train with every expert on the
device, their loss carrying the router's aux term.

``--mesh DxM`` (axes data, model) or ``PxDxM`` (pod, data, model) starts
prod(dims) ranks (``repro_torch.distributed.group.run_group``, gloo, every
rank on ``--device``), each running ``train_rank``: the params laid out by
``param_pspecs`` and AdamW's state by ZeRO-1 over ``data``, the batch cut
over (pod, data), the attention and FFN leaves the layout cuts over
``model`` by head or hidden computed tensor-parallel, every other sharded
leaf gathered at use (see ``repro_torch.training.train_step``).  Rank 0
prints the lines.  ``build(..., layout="fsdp")`` lays the params out by
``fsdp_pspecs`` instead (the JAX dry run's ``fsdp`` variant; no flag).
Ranks on distinct cards are refused (ROADMAP.md A13).

``main(argv)`` returns the last step, the loop's history and each step's
host data seconds (rank 0's on a mesh), so a script can drive it in
process.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import torch

from repro_torch import pytree
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_rank_mesh, parse_mesh
from repro_torch.models.lm import lm_loss
from repro_torch.nn.param import lm_param_axes
from repro_torch.training.loop import LoopConfig, run
from repro_torch.training.optimizer import adamw, cosine_schedule
from repro_torch.training.train_step import MeshLayout, make_train_step
from repro_torch.weights import lm_init_params, lm_param_shapes

_SEED = 1  # the loop's per-step generators (the JAX CLI's PRNGKey(1))
LAYOUTS = ("param", "fsdp")


def mesh_layout(cfg, mesh, layout: str = "param", min_shard_elems: int = 65536) -> MeshLayout:
    """This rank's ``MeshLayout`` of ``cfg``'s params on ``mesh`` (a
    ``MeshGroups``): ``param_pspecs`` (``layout="param"``, the JAX
    trainer's) or ``fsdp_pspecs`` (``"fsdp"``), AdamW's state by
    ``train_opt_pspecs`` (ZeRO-1 over ``data``)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    axes, shapes = lm_param_axes(cfg), lm_param_shapes(cfg)
    if layout == "fsdp":
        specs = sharding.fsdp_pspecs(axes, shapes, mesh, min_shard_elems=min_shard_elems)
    else:
        specs = sharding.param_pspecs(axes, shapes, mesh, min_shard_elems=min_shard_elems)
    return MeshLayout(mesh, specs, sharding.train_opt_pspecs(specs, shapes, mesh),
                      sharding.tp_paths(axes, specs))


def build(cfg, mesh, accum: int, lr: float, total_steps: int, layout: str = "param", *,
          device=None, pre_split: bool = False, min_shard_elems: int = 65536):
    """(train_step, init, layout) for ``cfg``, the JAX trainer's ``build``.
    ``mesh``: None (one process) or this rank's ``MeshGroups`` (its device
    is the rank's); ``layout`` then names the params' layout (see
    ``mesh_layout``), and the step is the rank's ``MeshStep``.
    ``init(params=None)`` gives the params (``params``, whole, or drawn
    at seed 0 on ``device``, None meaning "cuda") and their AdamW state,
    on a mesh the rank's blocks of both.  ``pre_split``: the batches
    arrive as (accum, micro, ...)."""
    dev = resolve_device(device if mesh is None else mesh.device)
    opt = adamw(cosine_schedule(lr, warmup=max(10, total_steps // 20), total=total_steps))
    lay = None if mesh is None else mesh_layout(cfg, mesh, layout, min_shard_elems)
    tp_axis = None if lay is None else lay.tp_group
    batch_axis = None if lay is None else lay.batch_group

    def loss_fn(params, batch, generator):
        return lm_loss(params, batch, cfg, tp_axis=tp_axis, batch_axis=batch_axis)

    def init(params=None):
        if params is None:
            params = lm_init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                    device=dev)
        if lay is None:
            return params, opt.init(params)
        shards = lay.shard(params)
        del params

        def zeros():
            return pytree.unflatten(shards, [
                torch.zeros(sharding.local_shape(shape, spec, mesh), dtype=torch.float32,
                            device=dev)
                for _, shape, spec in sharding.zip_specs(lm_param_shapes(cfg),
                                                         lay.opt["mu"])])

        return shards, {"mu": zeros(), "nu": zeros(),
                        "step": torch.zeros((), dtype=torch.int32, device=dev)}

    step = make_train_step(loss_fn, opt, accum=accum, pre_split=pre_split, layout=lay)
    return step, init, lay


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (or PxDxM)")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def _split(batch, accum: int) -> dict:
    """The JAX CLI's microbatches: (accum, B / accum, ...)."""
    return {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:]) for k, v in batch.items()}


def _train(args, mesh=None, device=None) -> dict:
    """The CLI's run on this process: one process, or this rank of
    ``mesh`` (rank 0 prints)."""
    dev = resolve_device(device)
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = reduced(cfg)
    split = args.accum > 1  # the JAX CLI's microbatches, laid out before the step
    train_step, init, layout = build(cfg, mesh, args.accum, args.lr, args.steps,
                                     device=dev, pre_split=split)
    params, opt_state = init()
    speaks = mesh is None or mesh.rank == 0

    data = MarkovLM(vocab=cfg.vocab_size, seq_len=args.seq, batch=args.batch)
    data_s = []

    def batch_fn(step):
        t0 = time.perf_counter()
        batch = data.batch_at(step)
        data_s.append(time.perf_counter() - t0)
        return _split(batch, args.accum) if split else batch

    def log(s, m):
        if speaks:
            print(f"step {s}: loss {m['loss']:.4f}", flush=True)

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir or None,
                          ckpt_every=max(10, args.steps // 4), log_every=5)
    params, opt_state, last, hist = run(train_step, params, opt_state, batch_fn, _SEED,
                                        loop_cfg, log_fn=log, device=dev, layout=layout)
    if speaks and hist:
        print(f"done at step {last}: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}",
              flush=True)
    elif speaks:
        print(f"done at step {last}: no step left to run", flush=True)
    return {"last_step": last, "history": hist, "data_s": data_s}


def train_rank(group, argv) -> dict:
    """One rank of ``--mesh``: ``main``'s run on this rank of the spawn's
    ``group`` (``repro_torch.distributed.group.run_group``), over the mesh
    its ``--mesh`` names; module-level, so a script can run it in a group
    of its own."""
    args = parser().parse_args(list(argv))
    if group.device.type == "cpu":
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // group.world))
    return _train(args, make_rank_mesh(group, args.mesh), group.device)


def main(argv=None) -> dict:
    ap = parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    try:
        dims, _ = parse_mesh(args.mesh)
    except ValueError as exc:
        ap.error(str(exc))
    dev = resolve_device(args.device)
    world = math.prod(dims)
    if world == 1:
        return _train(args, None, dev)
    from repro_torch.distributed.group import run_group

    return run_group(train_rank, world, str(dev), (argv,))[0]


if __name__ == "__main__":
    main()
