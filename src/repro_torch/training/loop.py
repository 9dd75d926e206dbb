"""Fault-tolerant training loop: the trainer's entry point (the JAX
package's ``repro.training.loop``).

``run`` wraps a train step (``repro_torch.training.train_step``) with

  * resume from the latest checkpoint on start: params, optimizer state and
    the data step;
  * async checkpoints every ``ckpt_every`` steps, keeping the last ``keep``;
  * SIGTERM / SIGINT: finish the step in flight, write a final checkpoint,
    return (restartable);
  * non-finite steps: the step itself is skipped inside the train step; after
    ``max_bad_steps`` in a row the loop rolls back to the last checkpoint.

Step ``s`` draws from ``step_generator(seed, s)``, a generator seeded from
(seed, s) alone, and reads ``batch_fn(s)``, so a resumed run draws what an
unbroken one draws.

On a mesh of ranks (``layout``, a ``train_step.MeshLayout``; every rank
runs ``run`` with its own blocks) a checkpoint gathers the params and
mu / nu whole, rank 0 writes it (in the JAX layout, as a single process
would) while the other ranks wait at a barrier, and resuming and rolling
back go through ``checkpoint.restore_sharded``, so a run may resume on
another mesh than the one that saved.  A SIGTERM on any rank stops every
rank at the same step.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.checkpoint import manager as ckpt
from repro_torch.device import resolve_device


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    keep: int = 3
    log_every: int = 10
    max_bad_steps: int = 10


class Preemption:
    """Latches SIGTERM / SIGINT; the loop checks it once a step."""

    def __init__(self):
        self.flag = False
        self._old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self.flag = True

    def restore(self):
        for sig, h in self._old.items():
            signal.signal(sig, h)


def step_generator(seed: int, step: int, device=None) -> torch.Generator:
    """The generator of training step ``step``: seeded from (seed, step)
    through numpy's SeedSequence, on ``device`` (None means "cuda")."""
    state = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=resolve_device(device)).manual_seed(int(state))


class _Checkpoints:
    """Saves and restores of ``{"params", "opt"}``: in one process, or on
    a mesh of ranks (``layout``)."""

    def __init__(self, directory, layout=None):
        self.dir, self.layout = directory, layout
        self.writer = layout is None or layout.mesh.rank == 0
        self.world = None if layout is None else layout.mesh.group(layout.mesh.axis_names)

    def restore(self, step, params, opt_state):
        target = {"params": params, "opt": opt_state}
        if self.layout is None:
            tree, manifest = ckpt.restore(self.dir, step, target)
        else:
            tree, manifest = ckpt.restore_sharded(self.dir, target, self.layout.specs(),
                                                  self.layout.mesh, step)
        return tree["params"], tree["opt"], manifest["step"]

    def save(self, step, params, opt_state, extra, wait=True):
        """Write the checkpoint of ``step``: on a mesh gathered whole,
        written by rank 0 at once while the others wait; else on a thread
        unless ``wait`` (returns the thread or None)."""
        if self.layout is not None:
            params, opt_state = self.layout.gather(params, opt_state)
        tree = {"params": params, "opt": opt_state}
        thread = None
        if self.writer:
            if wait or self.layout is not None:
                ckpt.save(self.dir, step, tree, extra=extra)
            else:
                thread = ckpt.save_async(self.dir, step, tree, extra=extra)
        if self.world is not None:
            self.world.barrier()
        return thread

    def retain(self, keep):
        if self.writer:
            ckpt.retain(self.dir, keep)


def run(train_step: Callable, params, opt_state, batch_fn: Callable[[int], dict],
        seed: int, loop_cfg: LoopConfig,
        log_fn: Callable[[int, dict], None] | None = None, device=None, layout=None):
    """Train from ``params`` and ``opt_state`` (or from the latest checkpoint
    in ``loop_cfg.ckpt_dir``) up to ``loop_cfg.total_steps``.  ``batch_fn(s)``
    gives step s's batch (numpy arrays or tensors; moved to ``device``,
    None means "cuda").  ``layout``: this rank's ``MeshLayout`` where
    ``train_step`` is a mesh step and ``params`` / ``opt_state`` are the
    rank's blocks.  Returns (params, opt_state, last step, history of
    {"step", "loss", "time"})."""
    dev = resolve_device(device)
    start_step = 0
    ckpts = _Checkpoints(loop_cfg.ckpt_dir, layout) if loop_cfg.ckpt_dir else None
    world = None if layout is None else layout.mesh.group(layout.mesh.axis_names)
    if world is not None and world.world == 1:
        world = None
    if ckpts is not None:
        last = ckpt.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            params, opt_state, start_step = ckpts.restore(last, params, opt_state)

    preempt = Preemption()
    history = []
    bad = 0
    pending_save = None
    step = start_step
    try:
        while step < loop_cfg.total_steps:
            t0 = time.perf_counter()
            batch = pytree.map(lambda x: torch.as_tensor(x).to(dev), batch_fn(step))
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step_generator(seed, step, dev))
            metrics = {k: v.item() if isinstance(v, torch.Tensor) else v
                       for k, v in metrics.items()}
            dt = time.perf_counter() - t0

            if not metrics.get("finite", True):
                bad += 1
                if bad >= loop_cfg.max_bad_steps and ckpts is not None:
                    if pending_save is not None:
                        pending_save.join()
                        pending_save = None
                    params, opt_state, step = ckpts.restore(None, params, opt_state)
                    bad = 0
                    continue
            else:
                bad = 0

            step += 1
            if log_fn and step % loop_cfg.log_every == 0:
                log_fn(step, dict(metrics, step_time=dt))
            history.append({"step": step, "loss": float(metrics.get("loss", 0)),
                            "time": dt})

            if ckpts is not None and step % loop_cfg.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpts.save(step, params, opt_state, {"data_step": step},
                                          wait=False)
                ckpts.retain(loop_cfg.keep)

            stop = preempt.flag
            if world is not None:  # every rank stops at the same step
                stop = world.psum(torch.tensor([float(stop)]))[0].item() > 0
            if stop:
                break
    finally:
        if pending_save is not None:
            pending_save.join()
        if ckpts is not None and step > start_step:
            ckpts.save(step, params, opt_state,
                       {"data_step": step, "preempted": preempt.flag})
        preempt.restore()
    return params, opt_state, step, history
