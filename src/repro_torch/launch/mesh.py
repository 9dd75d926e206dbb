"""Production meshes: the port's copy of the JAX package's
``launch/mesh.py``.

A mesh here is a description (shape, axis names, the devices in row-major
order), not a communicator: process groups over a mesh of cards are
ROADMAP.md A13 (the serving model group, ``repro_torch.distributed.group``,
shares one card).  Nothing is touched when
the module is imported.  One card cannot hold a production mesh, so
``make_production_mesh`` refuses there; the dry run reads the mesh's shape
and chip count from ``production_mesh_shape`` without building it.
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
