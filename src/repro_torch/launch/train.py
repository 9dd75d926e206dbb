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
differences: ``--mesh`` takes only ``1x1`` (its default here), and
``--device`` picks the device (default the card; ``cpu`` runs the kernels'
plain versions).  The params are ``lm_init_params`` from a generator at
seed 0, the JAX init's law.  The MoE archs (dbrx-132b, qwen3-moe-30b-a3b)
train with every expert on the device, their loss carrying the router's
aux term.  A mesh of more devices is refused with exit status 2 and the
ROADMAP.md item that brings it (A13).

``main(argv)`` returns the last step, the loop's history and each step's
host data seconds, so a script can drive it in process.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import MarkovLM
from repro_torch.device import resolve_device
from repro_torch.models.lm import lm_loss
from repro_torch.training.loop import LoopConfig, run
from repro_torch.training.optimizer import adamw, cosine_schedule
from repro_torch.training.train_step import make_train_step
from repro_torch.weights import lm_init_params

_SEED = 1  # the loop's per-step generators (the JAX CLI's PRNGKey(1))


def build(cfg, accum: int, lr: float, total_steps: int, device=None):
    """(train_step, init) for ``cfg``: ``init()`` gives the params drawn
    at seed 0 on ``device`` (None means "cuda") and their AdamW state."""
    dev = resolve_device(device)
    opt = adamw(cosine_schedule(lr, warmup=max(10, total_steps // 20), total=total_steps))

    def loss_fn(params, batch, generator):
        return lm_loss(params, batch, cfg)

    def init():
        params = lm_init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        return params, opt.init(params)

    return make_train_step(loss_fn, opt, accum=accum), init


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL (or PxDxM); only 1x1")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return ap


def _refusal(args):
    """The message for what the port cannot train yet, or None."""
    if args.mesh != "1x1":
        return (f"--mesh {args.mesh}: only 1x1; data and model parallelism over a mesh "
                "are ROADMAP.md A13")
    return None


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    refused = _refusal(args)
    if refused is not None:
        ap.error(refused)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = reduced(cfg)
    train_step, init = build(cfg, args.accum, args.lr, args.steps, dev)
    params, opt_state = init()

    data = MarkovLM(vocab=cfg.vocab_size, seq_len=args.seq, batch=args.batch)
    data_s = []

    def batch_fn(step):
        # the train step splits the batch into --accum microbatches itself
        t0 = time.perf_counter()
        batch = data.batch_at(step)
        data_s.append(time.perf_counter() - t0)
        return batch

    loop_cfg = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir or None,
                          ckpt_every=max(10, args.steps // 4), log_every=5)
    params, opt_state, last, hist = run(
        train_step, params, opt_state, batch_fn, _SEED, loop_cfg,
        log_fn=lambda s, m: print(f"step {s}: loss {m['loss']:.4f}", flush=True),
        device=dev)
    if hist:
        print(f"done at step {last}: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}",
              flush=True)
    else:
        print(f"done at step {last}: no step left to run", flush=True)
    return {"last_step": last, "history": hist, "data_s": data_s}


if __name__ == "__main__":
    main()
