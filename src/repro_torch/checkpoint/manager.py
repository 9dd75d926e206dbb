"""Checkpoints: atomic and resumable, in the JAX package's layout
(``repro.checkpoint.manager``), so a checkpoint either package writes
restores in the other.

Layout (one directory per step):

    <dir>/step_000000123/
        manifest.msgpack   {step, keys, shapes, dtypes, extra}
        arrays.npz         one entry per leaf, named by its key

A tree is a nested dict of tensors (or numpy arrays).  Its leaves are
taken in sorted key order, and each is named by the JAX package's
``jax.tree_util.keystr`` of its path, e.g. ``['params']['decoder']['g0']
['attn']['wq']`` or ``['opt']['step']``.

  * atomic: written to ``<dir>/tmp_<step>`` then ``os.replace``d, so a crash
    mid-save never corrupts the latest checkpoint;
  * resumable data state: the manifest carries ``extra`` (the data step);
  * retention: ``retain`` keeps the last N checkpoints.

``save_async`` copies the leaves to the host before it returns and writes
on a thread, under the same keys as ``save`` (the JAX package's
``save_async`` wraps each key a second time, so its ``restore`` with a
target cannot read what it wrote; the port writes ``save``'s keys).

``restore_sharded`` is the elastic restore onto a mesh of ranks: every
rank reads the file and keeps its own block of each leaf under the
*current* layout, which need not be the one the checkpoint was saved
from (the JAX package's ``device_put`` onto the current shardings).
"""

from __future__ import annotations

import os
import shutil
import threading

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.checkpoint import _msgpack


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree):
    keys, vals = [], []
    for path, leaf in pytree.paths(tree):
        keys.append(keystr(path))
        vals.append(_host(leaf))
    return keys, vals


def _write(directory: str, step: int, keys, vals, extra) -> str:
    tmp = os.path.join(directory, f"tmp_{step:09d}")
    final = os.path.join(directory, f"step_{step:09d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **dict(zip(keys, vals)))
    manifest = {
        "step": step,
        "keys": keys,
        "shapes": [list(v.shape) for v in vals],
        "dtypes": [str(v.dtype) for v in vals],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` as the checkpoint of ``step``; returns its directory."""
    keys, vals = _flatten(tree)
    return _write(directory, step, keys, vals, extra)


def save_async(directory: str, step: int, tree, extra: dict | None = None):
    """Copy the leaves to the host now, write them on a thread (training
    goes on); returns the thread, to ``join``."""
    keys, vals = _flatten(tree)
    t = threading.Thread(target=_write, args=(directory, step, keys, vals, extra),
                         daemon=True)
    t.start()
    return t


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int | None = None, target=None):
    """(tree or flat dict, manifest).  With ``target`` (a tree of the
    expected structure) the leaves come back as tensors in that structure,
    each on its target leaf's device in the dtype it was saved in;
    otherwise a flat {key: numpy array} dict.  ``step`` None means the
    latest."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in manifest["keys"]}
    if target is None:
        return flat, manifest

    def leaf(keys, t):
        key = keystr(keys)
        if key not in flat:
            raise KeyError(f"checkpoint {path} has no leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                             f"expected {tuple(t.shape)}")
        dev = t.device if isinstance(t, torch.Tensor) else "cpu"
        return torch.from_numpy(np.array(arr, order="C")).to(dev)

    return pytree.unflatten(target, [leaf(*p) for p in pytree.paths(target)]), manifest


def restore_sharded(directory: str, target, specs, mesh, step: int | None = None):
    """(tree, manifest): this rank's block of every leaf of the checkpoint
    under ``specs`` (a tree of ``PartitionSpec`` of ``target``'s keys) on
    ``mesh`` (a ``repro_torch.distributed.group.MeshGroups``; coordinates
    are all it reads).  ``target`` gives the structure and each block's
    device; a target leaf with a shape must have the block's.  ``step``
    None means the latest."""
    from repro_torch.distributed.sharding import block_slices, zip_specs

    flat, manifest = restore(directory, step)
    leaves = []
    for keys, t, spec in zip_specs(target, specs):
        key = keystr(keys)
        if key not in flat:
            raise KeyError(f"checkpoint step {manifest['step']} in {directory} has no "
                           f"leaf {key}")
        arr = flat[key]
        block = arr[block_slices(arr.shape, spec, mesh)]
        if hasattr(t, "shape") and tuple(block.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {key}: a block of {block.shape} under "
                             f"{spec}, expected {tuple(t.shape)}")
        dev = t.device if isinstance(t, torch.Tensor) else "cpu"
        leaves.append(torch.from_numpy(np.array(block, order="C")).to(dev))
    return pytree.unflatten(target, leaves), manifest


def retain(directory: str, keep: int = 3) -> None:
    """Delete all but the last ``keep`` checkpoints."""
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"), ignore_errors=True)
