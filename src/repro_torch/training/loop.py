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


def run(train_step: Callable, params, opt_state, batch_fn: Callable[[int], dict],
        seed: int, loop_cfg: LoopConfig,
        log_fn: Callable[[int, dict], None] | None = None, device=None):
    """Train from ``params`` and ``opt_state`` (or from the latest checkpoint
    in ``loop_cfg.ckpt_dir``) up to ``loop_cfg.total_steps``.  ``batch_fn(s)``
    gives step s's batch (numpy arrays or tensors; moved to ``device``,
    None means "cuda").  Returns (params, opt_state, last step, history of
    {"step", "loss", "time"})."""
    dev = resolve_device(device)
    start_step = 0
    if loop_cfg.ckpt_dir:
        last = ckpt.latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            tree, manifest = ckpt.restore(loop_cfg.ckpt_dir, last,
                                          {"params": params, "opt": opt_state})
            start_step = manifest["step"]
            params, opt_state = tree["params"], tree["opt"]

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
                if bad >= loop_cfg.max_bad_steps and loop_cfg.ckpt_dir:
                    if pending_save is not None:
                        pending_save.join()
                        pending_save = None
                    tree, manifest = ckpt.restore(loop_cfg.ckpt_dir, None,
                                                  {"params": params, "opt": opt_state})
                    params, opt_state = tree["params"], tree["opt"]
                    step = manifest["step"]
                    bad = 0
                    continue
            else:
                bad = 0

            step += 1
            if log_fn and step % loop_cfg.log_every == 0:
                log_fn(step, dict(metrics, step_time=dt))
            history.append({"step": step, "loss": float(metrics.get("loss", 0)),
                            "time": dt})

            if loop_cfg.ckpt_dir and step % loop_cfg.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save_async(
                    loop_cfg.ckpt_dir, step, {"params": params, "opt": opt_state},
                    extra={"data_step": step})
                ckpt.retain(loop_cfg.ckpt_dir, loop_cfg.keep)

            if preempt.flag:
                break
    finally:
        if pending_save is not None:
            pending_save.join()
        if loop_cfg.ckpt_dir and step > start_step:
            ckpt.save(loop_cfg.ckpt_dir, step, {"params": params, "opt": opt_state},
                      extra={"data_step": step, "preempted": preempt.flag})
        preempt.restore()
    return params, opt_state, step, history
