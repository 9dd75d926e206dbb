"""The model group: the port's counterpart of a ``"model"`` mesh axis inside
the JAX package's ``shard_map``.

Where the JAX package runs one program over a device group and names the
group's axis in its collectives (``jax.lax.psum(x, "model")``), the port
runs one process per rank and hands its model-parallel code a
``ModelGroup``: the rank, the world size, the device and a
``torch.distributed`` process group, with the collectives the serving
forward uses, in ``jax.lax``'s tiled forms:

  axis_index()                       this rank (``jax.lax.axis_index``)
  psum(x), pmean(x)                  sum / mean over the ranks
  all_to_all(x, split_axis, concat_axis)
                                     split ``split_axis`` into world blocks,
                                     send block j to rank j, concatenate the
                                     received blocks along ``concat_axis`` in
                                     sender order
  all_gather(x, axis)                every rank's x, concatenated along
                                     ``axis`` in rank order
  broadcast_floats(values)           rank 0's host numbers on every rank

``psum`` is an all-gather followed by a sum in rank order
(((x0 + x1) + x2) ...), in x's dtype on x's device: every rank ends with
the same bits, two runs give the same bits, whatever order the transport
reduces in.

The transport is gloo over explicit host copies (pinned on the card): a
collective copies its tensor's bytes to the host, runs the gloo collective
there, and copies the result back to the device.  This serves ranks on the
CPU and ranks that share one card (NCCL refuses two ranks on one device).
Ranks on distinct cards raise: NCCL between cards, and collectives captured
inside the superstep's CUDA graph, need a machine with several cards
(ROADMAP.md A13).  A host-staged collective cannot be captured, so a
worker with a model group runs its programs eagerly.

``run_group(fn, world, device, args)`` starts ``world`` ranks with
``torch.multiprocessing.spawn`` over a ``FileStore`` in a temporary
directory (no port is taken), calls ``fn(group, *args)`` on each and
returns every rank's result, in rank order.  A rank that raises, or a
collective that fails or times out, fails the call.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import traceback

import torch
import torch.distributed as dist

# a rank waits this long in a collective for the others before it fails
DEFAULT_TIMEOUT_S = 600.0


class ModelGroup:
    """One rank's view of a model group.  ``pg`` is the ``torch.distributed``
    process group of the ranks (gloo).  Construction is a collective: every
    rank checks that all ranks run on the same device type, and on the
    card on one card."""

    def __init__(self, rank: int, world: int, device, pg=None):
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.pg = pg
        self._pinned = self.device.type == "cuda"
        if self.world > 1:
            self._check_placement()

    def __repr__(self) -> str:
        return f"ModelGroup(rank={self.rank}, world={self.world}, device={self.device})"

    def _check_placement(self) -> None:
        index = self.device.index if self.device.index is not None else (
            torch.cuda.current_device() if self.device.type == "cuda" else -1)
        mine = torch.tensor([int(self.device.type == "cuda"), index], dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(every, mine, group=self.pg)
        places = {tuple(t.tolist()) for t in every}
        if len(places) > 1:
            raise ValueError(
                f"model group ranks on distinct devices {sorted(places)} (cuda flag, "
                "card index): a group's ranks share one card or the CPU here; NCCL "
                "between cards and collectives captured in the superstep graph are "
                "ROADMAP.md A13")

    def axis_index(self) -> int:
        return self.rank

    # -- transport -----------------------------------------------------------

    def _host_bytes(self, x: torch.Tensor) -> torch.Tensor:
        """x's bytes as a flat uint8 host tensor (pinned on the card), after
        the work that wrote x on its stream."""
        flat = x.contiguous().view(-1).view(torch.uint8)
        if x.device.type != "cuda":
            return flat
        host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return host

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's x in rank order, on x's device."""
        send = self._host_bytes(x)
        recv = torch.empty((self.world,) + tuple(send.shape), dtype=torch.uint8,
                           pin_memory=self._pinned and x.device.type == "cuda")
        dist.all_gather(list(recv.unbind(0)), send, group=self.pg)
        out = recv.to(x.device).view(x.dtype)
        return out.view((self.world,) + tuple(x.shape))

    # -- collectives ---------------------------------------------------------

    def all_gather(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Every rank's x concatenated along ``axis`` in rank order (tiled)."""
        if self.world == 1:
            return x
        return torch.cat(list(self._gathered(x).unbind(0)), dim=axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, added in rank order in x's dtype: the
        same bits on every rank."""
        if self.world == 1:
            return x
        parts = self._gathered(x)
        out = parts[0].clone()
        for part in parts[1:]:
            out += part
        return out

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.world if self.world > 1 else x

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int) -> torch.Tensor:
        """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
        block j of ``split_axis`` goes to rank j; the blocks received are
        concatenated along ``concat_axis`` in sender order."""
        if self.world == 1:
            return x
        n = x.shape[split_axis]
        if n % self.world:
            raise ValueError(f"all_to_all: axis {split_axis} of size {n} does not split "
                             f"over {self.world} ranks")
        blocks = torch.stack(x.split(n // self.world, dim=split_axis))  # (world, ...)
        send = self._host_bytes(blocks)
        recv = torch.empty(send.shape, dtype=torch.uint8, pin_memory=send.is_pinned())
        dist.all_to_all_single(recv, send, group=self.pg)
        got = recv.to(x.device).view(blocks.dtype).view(blocks.shape)
        return torch.cat(list(got.unbind(0)), dim=concat_axis)

    def broadcast_floats(self, values) -> list:
        """Rank 0's ``values`` (host floats, exact for integers below
        2**53) on every rank: rank 0's host decisions, which the other
        ranks follow so that they stay in lockstep."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        if self.world > 1:
            dist.broadcast(t, src=0, group=self.pg)
        return t.tolist()


def _rank_main(rank: int, fn, world: int, devices: list, tmp: str, args: tuple,
               timeout_s: float) -> None:
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                               else dev.index)
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(ModelGroup(rank, world, dev, dist.group.WORLD), *args)
            torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_group(fn, world: int, device=None, args: tuple = (),
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks and return their
    results in rank order.  ``device``: one device for every rank (None
    means "cuda"), or a list of one per rank; ``fn`` and ``args`` must
    pickle (a module-level function).  A rank's exception, or a collective
    that waits past ``timeout_s``, raises here."""
    devices = ([str(torch.device(d)) for d in device] if isinstance(device, (list, tuple))
               else [str(torch.device("cuda" if device is None else device))] * world)
    if len(devices) != world:
        raise ValueError(f"run_group: {len(devices)} devices for {world} ranks")
    if any(torch.device(d).type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    with tempfile.TemporaryDirectory(prefix="model-group-") as tmp:
        try:
            torch.multiprocessing.spawn(_rank_main, nprocs=world, join=True,
                                        args=(fn, world, devices, tmp, tuple(args), timeout_s))
        except Exception as exc:
            # every rank's traceback, not only the first to exit (a peer of
            # the rank at fault fails too, in its next collective)
            errs = [f"rank {r}:\n{open(p).read()}" for r in range(world)
                    if os.path.exists(p := os.path.join(tmp, f"rank{r}.err"))]
            raise RuntimeError("model group failed:\n" + "\n".join(errs or [str(exc)])) from exc
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world)]
