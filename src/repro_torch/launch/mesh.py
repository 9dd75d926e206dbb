"""Production meshes: the port's copy of the JAX package's
``launch/mesh.py``.

A ``Mesh`` here is a description (shape, axis names, the devices in
row-major order), not a communicator.  A mesh of *ranks* is
``make_rank_mesh``: the counterpart of ``make_debug_mesh`` for the ranks
of one spawn (``repro_torch.distributed.group.run_group``), a
``MeshGroups`` with a process group for every line of its axes, built
from the JAX trainer's ``--mesh`` (``DATAxMODEL`` or ``PxDxM``).  Its
ranks share one card or the CPU; NCCL between cards is ROADMAP.md A13.
Nothing is touched when the module is imported.  One card cannot hold a
production mesh, so ``make_production_mesh`` refuses there; the dry run
reads the mesh's shape and chip count from ``production_mesh_shape``
without building it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple
    axis_names: tuple
    devices: tuple  # torch.device, row-major over ``shape``

    @property
    def size(self) -> int:
        return len(self.devices)


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the single-pod (16, 16) or the two-pod (2, 16,
    16) production mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _devices(device=None) -> list:
    """The devices of ``device``'s type: every CUDA card, or the one CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape, axes = production_mesh_shape(multi_pod)
    n = math.prod(shape)
    devices = _devices(device)
    if len(devices) < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {len(devices)} — a production "
            "mesh spans many cards; model parallelism over one is ROADMAP.md A13")
    return Mesh(shape, axes, tuple(devices[:n]))


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> Mesh:
    n = math.prod(shape)
    devices = _devices(device)
    if len(devices) < n:
        raise AssertionError((len(devices), n))
    return Mesh(tuple(shape), tuple(axes), tuple(devices[:n]))


def parse_mesh(spec: str) -> tuple[tuple, tuple]:
    """(shape, axis names) of ``--mesh``: ``DxM`` over ("data", "model"),
    ``PxDxM`` over ("pod", "data", "model"), as the JAX trainer reads it."""
    try:
        dims = tuple(int(x) for x in spec.split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh {spec!r}: DATAxMODEL or PODxDATAxMODEL, positive sizes")
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return dims, names


def make_rank_mesh(group, spec="1x1"):
    """This rank's ``MeshGroups`` of ``--mesh`` ``spec`` (or a (shape,
    names) pair) over ``group``, the spawn's ``ModelGroup`` of prod(shape)
    ranks: a collective every rank calls with the same mesh."""
    from repro_torch.distributed.group import mesh_groups

    shape, names = parse_mesh(spec) if isinstance(spec, str) else spec
    return mesh_groups(group, shape, names)
