"""Programs: the port's counterpart of the JAX package's compiled loops and
boundaries (``jax.jit``, ``lax.while_loop``, ``lax.scan``).

A ``SuperstepProgram`` wraps a body that reads a fixed set of tensors and
writes what it changes back into them in place (the counterpart of
``donate_argnums``).  Its users:

  * the serving worker's supersteps, one per ``(R, budget)`` key, and its
    admissions, one per power-of-two width (``serving/worker.py``);
  * the sampler's round, replayed until every chain is done
    (``core/asd.py``, ``SamplerLoop``);
  * the K-step baseline's step, replayed K times (``core/sequential.py``).

A field a body hands back as the very tensor it read (the keys, ``u_buf``,
``xi_buf``) is not copied onto itself.

On the CPU a call runs the body, and so does every call of a program made
with ``eager=True``: a worker with a model group builds its programs so,
since a host-staged collective cannot be captured
(``repro_torch.distributed.group``).  The kernel wrappers count their
launches as they launch, so an eager program counts the same launches per
round as a captured one.  On the card otherwise:

  * the first call is the cold dispatch: it runs the body for real, then
    captures the same body with ``torch.cuda.graph``.  A capture executes
    nothing, so the state advances exactly once;
  * every later call is one ``replay()`` of that graph;
  * a worker's programs share one memory pool, so the memory they keep
    grows with the largest superstep, not with the number of keys;
  * a capture that fails raises: there is no eager fallback.

No garbage is collected during a capture: a graph that the cycle
collector destroys there (a dropped worker's, say) makes CUDA calls that
the capturing stream refuses, which voids the capture.  So a capture holds
the collector off until it ends.  It does not collect first: a full
collection costs hundreds of ms in a process that holds many objects, and
a sampler call captures anew each time.  The sampler's bodies close over
no object that holds their program, so a finished call's graph and pool
are freed by reference counting, not left to the collector.

A graph binds the addresses it was captured on: every tensor the body
reads (slot or chain state, condition rows, allocator weights, the budget
tier, a step index, weights and schedule) must be written in place and
never rebound, and every tensor it makes comes from the pool.  Nothing inside may copy from
the host: the capture refuses it.

The kernel wrappers count their launches in Python.  A capture runs their
Python code (the counters go up) but launches nothing, and a replay does
not run it at all, so a program takes the captured launches back off and
adds them once for each replay: launches per round are the same with and
without graphs.

A body may not draw from a ``torch.Generator``: a replay would reuse the
draws of the capture.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch


def _counters() -> list:
    """Every kernel wrapper's launch counter as (holder dict, key)."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.grs.ops import grs
    from repro_torch.kernels.pack.ops import gather_rows, scatter_rows
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.superstep.ops import fused_gather, fused_verify_commit

    fns = (grs, flash.flash_mha, flash.flash_wgmma, flash.flash_f32, gather_rows,
           scatter_rows, fused_gather, fused_verify_commit, linear_scan)
    return ([(fn.__dict__, "launches") for fn in fns]
            + [(flash.flash_f32.launches_by_design, d) for d in flash.F32_DESIGNS])


class SuperstepProgram:
    """One body run as a program (a superstep, an admission, a round, a
    step).

    ``body()`` runs it eagerly and leaves its result in the tensors it
    writes.  ``pool`` is the graph memory pool (a
    ``torch.cuda.graph_pool_handle()``) the capture allocates from, which a
    worker's programs share; None gives the capture a pool of its own (and
    the CPU has none).  ``eager``: run the body at every call, never
    capture.  ``__call__`` returns True when the call was the program's
    cold dispatch (its first: on the card, the one that captured)."""

    def __init__(self, body: Callable[[], None], device: torch.device, pool=None,
                 eager: bool = False):
        self.body = body
        self.device = torch.device(device)
        self.pool = pool
        self.eager = eager
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self.captures = 0
        self.capture_ms: Optional[float] = None  # host wall time of the capture
        # what one replay adds to each launch counter, in _counters() order
        self.launches: Optional[list] = None

    def __call__(self) -> bool:
        self.calls += 1
        if self.device.type != "cuda" or self.eager:
            self.body()
            return self.calls == 1
        if self.graph is None:
            self.body()
            self._capture()
            return True
        self.graph.replay()
        for (holder, key), n in zip(_counters(), self.launches):
            holder[key] += n
        return False

    def _capture(self) -> None:
        counters = _counters()
        before = [holder[key] for holder, key in counters]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.body()
        except BaseException:
            for (holder, key), n in zip(counters, before):
                holder[key] = n
            raise
        finally:
            if collecting:
                gc.enable()
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.captures += 1
        self.launches = [holder[key] - n for (holder, key), n in zip(counters, before)]
        for (holder, key), n in zip(counters, self.launches):
            holder[key] -= n  # the capture launched nothing
        self.graph = graph
