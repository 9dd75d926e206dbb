"""The model group: the port's counterpart of a ``"model"`` mesh axis inside
the JAX package's ``shard_map``.

Where the JAX package runs one program over a device group and names the
group's axis in its collectives (``jax.lax.psum(x, "model")``), the port
runs one process per rank and hands its model-parallel code a
``ModelGroup``: the rank, the world size, the device and a
``torch.distributed`` process group, with the collectives the serving
forward uses, in ``jax.lax``'s tiled forms:

  axis_index()                       this rank (``jax.lax.axis_index``)
  psum(x), pmean(x), pmax(x)         sum / mean / max over the ranks
  all_to_all(x, split_axis, concat_axis)
                                     split ``split_axis`` into world blocks,
                                     send block j to rank j, concatenate the
                                     received blocks along ``concat_axis`` in
                                     sender order
  all_gather(x, axis)                every rank's x, concatenated along
                                     ``axis`` in rank order
  reduce_scatter(x, axis)            block ``rank`` of ``axis`` of psum(x)
                                     (``jax.lax.psum_scatter``, tiled)
  broadcast_floats(values)           rank 0's host numbers on every rank
  gather_rows_to_lead(x, counts)     every rank's rows on rank 0, in rank
                                     order, sent point to point by the
                                     ranks that hold some

``psum`` is an all-gather followed by a sum in rank order
(((x0 + x1) + x2) ...), in x's dtype on x's device: every rank ends with
the same bits, two runs give the same bits, whatever order the transport
reduces in.  ``reduce_scatter`` keeps that rule: an all-to-all (gloo has
no reduce-scatter) sends block j of x to rank j, which adds the blocks it
receives in rank order, so its result is block ``rank`` of ``psum(x)`` in
bits, for 1/world of psum's bytes.

The Megatron pair lets autograd see the tensor-parallel collectives:
``psum_fwd(x, group)`` (*g*: psum forward, identity backward) goes after a
row-parallel product, and ``psum_bwd(x, group)`` (*f*: identity forward,
psum backward) where a replicated activation enters a rank's local
slice.  Without autograd *g* is ``psum`` itself, so the serving forward
keeps its bits. ``pmean_fwd(x, group)`` (pmean forward, identity
backward) averages a whole-batch statistic over the data-parallel ranks
inside a loss whose gradients the mesh step averages.

A mesh of ranks (the JAX package's ``Mesh(devices.reshape(dims),
names)``) is ``MeshGroups``: rank r sits at ``numpy.unravel_index(r,
dims)``, and ``mesh_groups`` builds, over one spawn, a ``ModelGroup`` for
every line of every set of axes (``torch.distributed.new_group``), the
ranks of a line in row-major order over its axes.  ``collective_seconds``
is the wall time this process spent inside the collectives.

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

import contextlib
import datetime
import itertools
import math
import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# a rank waits this long in a collective for the others before it fails
DEFAULT_TIMEOUT_S = 600.0

# wall seconds of this process inside the collectives
_TIMER = {"seconds": 0.0}


def collective_seconds() -> float:
    """Wall seconds this process has spent inside the groups' collectives
    (the host copies, the transport and the sums), since the last reset."""
    return _TIMER["seconds"]


def reset_collective_seconds() -> None:
    _TIMER["seconds"] = 0.0


@contextlib.contextmanager
def _timed(x=None):
    """Adds the block's wall time to the timer; on the card it first waits
    for the work queued before the collective, so that work is not
    counted."""
    if x is not None and x.device.type == "cuda":
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMER["seconds"] += time.perf_counter() - t0


class ModelGroup:
    """One rank's view of a model group.  ``pg`` is the ``torch.distributed``
    process group of the ranks (gloo).  Construction is a collective: every
    rank checks that all ranks run on the same device type, and on the
    card on one card."""

    def __init__(self, rank: int, world: int, device, pg=None, ranks=None):
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.pg = pg
        # the spawn's rank of each rank of this group, in group order (a
        # point-to-point call names its peer by it)
        self.ranks = tuple(range(self.world) if ranks is None else ranks)
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
        with _timed(x):
            return torch.cat(list(self._gathered(x).unbind(0)), dim=axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, added in rank order in x's dtype: the
        same bits on every rank."""
        if self.world == 1:
            return x
        with _timed(x):
            return _rank_order_sum(self._gathered(x))

    def reduce_scatter(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """Block ``rank`` (of ``world`` contiguous blocks) of ``axis`` of
        ``psum(x)``, in the same bits: rank j receives every rank's block j
        (one all-to-all) and adds them in rank order."""
        if self.world == 1:
            return x
        n = x.shape[axis]
        if n % self.world:
            raise ValueError(f"reduce_scatter: axis {axis} of size {n} does not split "
                             f"over {self.world} ranks")
        with _timed(x):
            return _rank_order_sum(self._exchanged(x, axis))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of every rank's x (``jax.lax.pmax``)."""
        if self.world == 1:
            return x
        with _timed(x):
            return self._gathered(x).amax(0)

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
        with _timed(x):
            return torch.cat(list(self._exchanged(x, split_axis).unbind(0)), dim=concat_axis)

    def _exchanged(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """(world, *block): block j of x's ``axis`` goes to rank j; row i of
        the result is the block rank i sent here."""
        n = x.shape[axis]
        blocks = torch.stack(x.split(n // self.world, dim=axis))  # (world, ...)
        send = self._host_bytes(blocks)
        recv = torch.empty(send.shape, dtype=torch.uint8, pin_memory=send.is_pinned())
        dist.all_to_all_single(recv, send, group=self.pg)
        return recv.to(x.device).view(blocks.dtype).view(blocks.shape)

    def broadcast_floats(self, values) -> list:
        """Rank 0's ``values`` (host floats, exact for integers below
        2**53) on every rank: rank 0's host decisions, which the other
        ranks follow so that they stay in lockstep."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        if self.world > 1:
            with _timed():
                dist.broadcast(t, src=0, group=self.pg)
        return t.tolist()

    def gather_rows_to_lead(self, x: torch.Tensor, counts) -> torch.Tensor | None:
        """Rank 0 gets every rank's rows: rank r holds ``counts[r]`` rows
        in ``x`` (the same trailing shape and dtype on every rank), and
        rank 0 returns all of them on the host, concatenated in rank order;
        the other ranks return None.  A rank with rows sends them to rank
        0 once, point to point; a rank without sends nothing."""
        if self.world == 1:
            return x.cpu()
        with _timed(x):
            rows = x.detach().to("cpu").contiguous()
            if self.rank != 0:
                if counts[self.rank]:
                    dist.send(rows, dst=self.ranks[0], group=self.pg)
                return None
            parts = [rows]
            for r in range(1, self.world):
                if counts[r]:
                    part = torch.empty((counts[r],) + tuple(rows.shape[1:]), dtype=rows.dtype)
                    dist.recv(part, src=self.ranks[r], group=self.pg)
                    parts.append(part)
            return torch.cat(parts)

    def barrier(self) -> None:
        if self.world > 1:
            with _timed():
                dist.barrier(group=self.pg)


def _rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts (world, ...) added in rank order, in their dtype."""
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out


# -- the Megatron pair: collectives autograd can see ------------------------

class _PsumFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.psum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PsumBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.psum(grad.contiguous()), None


def psum_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """*g*: psum over ``group`` forward, identity backward (after a
    row-parallel product: every rank's partial sum gets the whole
    gradient of the total)."""
    return x if group is None or group.world == 1 else _PsumFwd.apply(x, group)


def psum_bwd(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: identity forward, psum over ``group`` backward (where a
    replicated activation enters a rank's local slice: each rank's
    gradient is partial, their sum whole)."""
    return x if group is None or group.world == 1 else _PsumBwd.apply(x, group)


class _PmeanFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.pmean(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pmean_fwd(x: torch.Tensor, group) -> torch.Tensor:
    """pmean over the data-parallel ranks of ``group`` forward, identity
    backward: a statistic of the whole batch from each rank's equal block
    (the MoE router's fractions).  The mesh step averages the ranks'
    gradients, so each rank's block carries the whole upstream gradient
    here and the average gives the mean's own 1 / world."""
    return x if group is None or group.world == 1 else _PmeanFwd.apply(x, group)


# -- a mesh of ranks -----------------------------------------------------------

def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class MeshGroups:
    """One rank's view of a mesh of ranks, the counterpart of a JAX ``Mesh``
    over devices: ``shape`` and ``axis_names`` (what the layout builders
    of ``repro_torch.distributed.sharding`` read), this rank and its
    coordinates (``numpy.unravel_index(rank, shape)``, as device r sits in
    ``Mesh(devices.reshape(shape), names)``), and ``group(axes)``: the
    ``ModelGroup`` of the ranks that differ from this one only along
    ``axes`` (a name or a tuple of names in mesh order), in row-major
    order over them.  A set of axes of one rank in all is a ``ModelGroup``
    of world 1.  Without ``groups`` it holds coordinates only (for a
    layout's slices of a rank that takes part in no collective)."""

    def __init__(self, shape, axis_names, rank: int, device="cpu", groups=None):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes {self.axis_names}")
        self.rank = int(rank)
        self.device = torch.device(device)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, self.shape))))
        self._groups = dict(groups or {})

    def __repr__(self) -> str:
        return (f"MeshGroups(shape={self.shape}, axes={self.axis_names}, rank={self.rank}, "
                f"coords={self.coords})")

    @property
    def world(self) -> int:
        return math.prod(self.shape)

    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axes) -> int:
        return math.prod(self.sizes()[a] for a in _axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in the order given)."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.sizes()[a] + self.coords[a]
        return idx

    def group(self, axes) -> ModelGroup:
        axes = tuple(a for a in self.axis_names if a in _axes(axes))
        if self.size(axes) == 1:
            return ModelGroup(0, 1, self.device)
        if axes not in self._groups:
            raise ValueError(f"{self!r} has no group over {axes}")
        return self._groups[axes]


def mesh_groups(world: ModelGroup, shape, axis_names) -> MeshGroups:
    """This rank's ``MeshGroups`` over ``world`` (the spawn's group, of
    prod(shape) ranks): a collective every rank calls with the same mesh.
    Every line of every set of axes of more than one rank gets its process
    group (``torch.distributed.new_group``, created by every rank in one
    order), so any set of axes can reduce or gather."""
    shape, names = tuple(int(n) for n in shape), tuple(axis_names)
    if math.prod(shape) != world.world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks, the group has "
                         f"{world.world}")
    mine = MeshGroups(shape, names, world.rank, world.device)
    coords = [np.unravel_index(r, shape) for r in range(world.world)]
    groups = {}
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), n):
            if math.prod(shape[a] for a in axes) == 1:
                continue
            key = tuple(names[a] for a in axes)
            if len(axes) == len(names):
                groups[key] = world
                continue
            rest = [a for a in range(len(names)) if a not in axes]
            lines = {}
            for r, c in enumerate(coords):
                lines.setdefault(tuple(int(c[a]) for a in rest), []).append(r)
            for line in sorted(lines):
                ranks = lines[line]
                pg = dist.new_group(ranks=ranks, backend="gloo")
                if world.rank in ranks:
                    groups[key] = ModelGroup(ranks.index(world.rank), len(ranks),
                                             world.device, pg,
                                             [world.ranks[r] for r in ranks])
    mine._groups = groups
    return mine


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
