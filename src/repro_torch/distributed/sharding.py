"""Logical-axis -> mesh-axis rules and layout builders, the counterpart of
the JAX package's ``repro/distributed/sharding.py``.

Megatron-style tensor parallelism over the ``model`` axis:
  column-parallel: wq ("heads" -> model), w_gate / w_up ("mlp" -> model)
  row-parallel:    wo, w_down (same axes; the forward psums after them)
  expert-parallel: MoE expert stacks ("experts" -> model)
The batch dims shard over ("pod", "data"); ZeRO-1 shards the optimizer
state's largest replicated axis over ``data``.

A layout is a tree of ``PartitionSpec`` (``repro_torch.nn.param``) beside
the params.  The JAX package builds its trees from boxed params; here a
builder takes the logical-axes tree (``param_axes`` / ``lm_param_axes``)
and the tree of shapes (``weights.param_shapes``, or the params
themselves).  A ``mesh`` is anything with ``axis_names`` and a ``shape``
that is either a mapping of axis name to size (JAX's) or a tuple in axis
order (``repro_torch.launch.mesh.Mesh``); the builders read no device.

The serving path uses ``mp_param_pspecs`` with a mesh whose ``model`` axis
is a model group's world size: ``shard_params`` then slices each leaf on
its ``"model"`` entries for one rank, and the model group
(``repro_torch.distributed.group``) runs the forward's collectives;
``measure_collective_seconds`` times them over that group.  The layouts
for training (``param_pspecs``, ``fsdp_pspecs``, ``zero1_pspec``,
``opt_state_pspecs``, ``replicated_pspecs``) are ported as layouts only.
``get_shard_map``, ``slots_mesh``, ``serving_mesh``, ``shard_pspecs``,
``chain_state_shardings``, ``shardings_from_pspecs`` and
``abstract_params`` are JAX mesh plumbing (``shard_map``, ``NamedSharding``,
``eval_shape``) with no counterpart: the port's sharded front end stacks
its shards itself, and a rank holds its own slice.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Mapping

import torch

from repro_torch import pytree
from repro_torch.nn.param import P, PartitionSpec, logical_to_pspec

log = logging.getLogger("repro_torch.serving.sharding")

LOGICAL_RULES: dict = {
    "embed": None,
    "embed2": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": None,  # raw-KV projections stay replicated (n_kv < model axis)
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "layers": None,  # the stacked layers axis
}

BATCH_AXES = ("pod", "data")

# Manual-TP whitelist: the (layers-stripped) logical signatures the serving
# forward's tensor parallelism computes on (attention wq / wo / bq head
# slicing, FFN w_gate / w_up / w_down hidden slicing, and their psums).
# Everything else stays replicated: nothing inserts a collective for an
# arbitrary sharded dim.
TP_VERIFY_SIGS = frozenset({
    ("embed", "heads", "head_dim"),   # wq (column-parallel)
    ("heads", "head_dim", "embed"),   # wo (row-parallel; forward psums after)
    ("heads", "head_dim"),            # bq
    ("embed", "mlp"),                 # w_gate / w_up (column-parallel)
    ("mlp", "embed"),                 # w_down (row-parallel; forward psums)
})

# Expert-parallel whitelist: the MoE expert stacks the EP dispatch computes
# on (``repro_torch.nn.moe``: local-expert products, all_to_all token
# exchange, psum combine).  Each rank owns E/mp expert FFNs; the router
# stays replicated.
EP_VERIFY_SIGS = frozenset({
    ("experts", "embed", "mlp"),      # w_gate / w_up expert stacks
    ("experts", "mlp", "embed"),      # w_down expert stack
})


def _axis_sizes(mesh) -> dict:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {a: int(n) for a, n in shape.items()}
    return {a: int(s) for a, s in zip(mesh.axis_names, shape)}


def leaf_shape(leaf) -> tuple:
    """A leaf of a shapes tree (a tuple) or of a params tree (a tensor)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def zip_specs(tree, specs):
    """(path, leaf, spec) of every leaf of two trees of the same keys."""
    for (path, leaf), (_, spec) in zip(pytree.paths(tree), pytree.paths(specs)):
        yield path, leaf, spec


def _entry_axes(m) -> tuple:
    return (m,) if isinstance(m, str) else tuple(m)


def _names_model(entry) -> bool:
    return entry is not None and "model" in _entry_axes(entry)


def mentions_model(spec) -> bool:
    """Whether ``spec`` shards some dim over the ``"model"`` axis."""
    return any(_names_model(e) for e in spec or ())


def batch_pspec(mesh, *trailing) -> PartitionSpec:
    axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    return P(axes, *trailing)


def param_pspecs(axes_tree, shapes=None, mesh=None, rules: Mapping | None = None,
                 min_shard_elems: int = 65536):
    """Logical axes -> PartitionSpec tree.

    With ``mesh`` (and ``shapes``) the specs are shape-aware: a sharded dim
    must divide its mesh axes evenly (heads in {4, 8, 24, 25, 40} do not
    divide a 16-way model axis), so non-dividing assignments are dropped
    and, for a leaf of at least ``min_shard_elems`` left without a model
    shard, the largest evenly-dividing dim is sharded instead (hymba's
    25-head wq shards d_model row-parallel)."""
    rules = rules or LOGICAL_RULES
    if mesh is None:
        return pytree.map(lambda axes: logical_to_pspec(axes, rules), axes_tree)
    sizes = _axis_sizes(mesh)

    def fit(axes, shape):
        spec = logical_to_pspec(axes, rules)
        entries = list(spec) + [None] * (len(shape) - len(spec))

        def axsize(m):
            return math.prod(sizes[a] for a in _entry_axes(m))

        used = set()
        for i, m in enumerate(entries):
            if m is None:
                continue
            if shape[i] % axsize(m) != 0 or any(a in used for a in _entry_axes(m)):
                entries[i] = None
            else:
                used.update(_entry_axes(m))
        total = math.prod(shape) if shape else 0
        if "model" in sizes and "model" not in used and total >= min_shard_elems:
            size = sizes["model"]
            cands = [i for i, (ax, dim) in enumerate(zip(axes, shape))
                     if entries[i] is None and ax != "layers"
                     and dim % size == 0 and dim >= size]
            if cands:
                entries[max(cands, key=lambda i: shape[i])] = "model"
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _zip_map(fit, axes_tree, shapes)


def _zip_map(fn, axes_tree, shapes):
    """``fn(axes, shape)`` over the leaves of two trees of the same keys."""
    flat = [fn(axes, leaf_shape(shape)) for _, shape, axes in zip_specs(shapes, axes_tree)]
    return pytree.unflatten(axes_tree, flat)


def model_group_placements(num_shards: int, model_parallel: int, devices) -> list[list]:
    """Per-worker device groups: shard i owns ``devices[i*mp:(i+1)*mp]``,
    the row-major grouping of the JAX package's ``serving_mesh`` rows.
    Needs ``num_shards * model_parallel`` distinct devices."""
    n = num_shards * model_parallel
    devs = list(dict.fromkeys(devices))
    if len(devs) < n:
        raise ValueError(f"model_group_placements needs {n} distinct devices, have "
                         f"{len(devs)}")
    return [devs[i * model_parallel:(i + 1) * model_parallel] for i in range(num_shards)]


def shard_placements(num_shards: int, devices) -> list:
    """Per-worker device list: shard i on ``devices[i % len(devices)]``
    (with fewer devices than shards the assignment wraps and shards
    co-locate; with one device every shard lands there)."""
    devs = list(devices)
    return [devs[i % len(devs)] for i in range(num_shards)]


# one-time replication warnings: a misconfigured mp must be visible
_REPLICATION_WARNED: set = set()


def _warn_replicated(leaf_name: str, core_sig: tuple, axis_name: str, dim: int,
                     size: int) -> None:
    key = (leaf_name, core_sig, dim, size)
    if key in _REPLICATION_WARNED:
        return
    _REPLICATION_WARNED.add(key)
    log.warning(
        "model-parallel layout: leaf %r (logical %s) replicates on every "
        "device — its %r dim (%d) does not divide the %d-way model axis; "
        "the verify serves it unsharded (no memory win for this leaf)",
        leaf_name, "/".join(core_sig), axis_name, dim, size)


def mp_param_pspecs(axes_tree, shapes, mesh, *, tensor: bool = True,
                    expert: bool = False):
    """Model-parallel serving layout over the ``model`` axis: only the axes
    the serving forward exchanges for are sharded,

      tensor  the head / hidden axes of ``TP_VERIFY_SIGS`` (attention and
              the dense FFN slice locally and psum);
      expert  the leading ``experts`` axis of ``EP_VERIFY_SIGS`` (each rank
              owns E/mp expert stacks).

    A whitelisted leaf whose axis does not divide the model-axis size is
    replicated, with a one-time WARNING on ``repro_torch.serving.sharding``
    naming the leaf and the axis size."""
    size = _axis_sizes(mesh)["model"]
    names = [path[-1] for path, _ in pytree.paths(axes_tree)]
    it = iter(names)

    def fit(axes, shape):
        name = next(it)
        core = tuple(a for a in axes if a != "layers")
        is_tp = tensor and core in TP_VERIFY_SIGS
        is_ep = expert and core in EP_VERIFY_SIGS
        if size <= 1 or not (is_tp or is_ep):
            return P()
        shard_axes = ("experts",) if is_ep else ("heads", "mlp")
        entries = ["model" if a in shard_axes and dim % size == 0 and dim >= size else None
                   for a, dim in zip(axes, shape)]
        if "model" not in entries:
            bad_ax, bad_dim = next(((a, d) for a, d in zip(axes, shape) if a in shard_axes),
                                   ("?", 0))
            _warn_replicated(name, core, bad_ax, int(bad_dim), size)
            return P()
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _zip_map(fit, axes_tree, shapes)


def tp_param_pspecs(axes_tree, shapes, mesh):
    """The tensor-parallel-only layout (experts replicated):
    ``mp_param_pspecs(tensor=True, expert=False)``."""
    return mp_param_pspecs(axes_tree, shapes, mesh, tensor=True, expert=False)


def shard_params(params, specs, rank: int, world: int):
    """Rank ``rank``'s share of ``params`` under ``specs`` (a tree of
    ``PartitionSpec`` over a ``model`` axis of ``world``): each leaf whose
    spec names ``"model"`` on a dim is cut there into ``world`` contiguous
    blocks and block ``rank`` kept as a contiguous tensor of its own, so
    the rank holds 1/world of the leaf; a replicated leaf is the caller's
    tensor itself.  An entry that is a tuple of axes counts only its
    ``"model"`` part (the serving layouts name no other)."""
    flat = []
    for path, leaf, spec in zip_specs(params, specs):
        out = leaf
        for dim, entry in enumerate(spec):
            if not _names_model(entry):
                continue
            n = leaf.shape[dim]
            if n % world:
                raise ValueError(f"shard_params: {'.'.join(path)} dim {dim} ({n}) does "
                                 f"not divide over {world} ranks")
            out = out.narrow(dim, rank * (n // world), n // world)
        flat.append(out if out is leaf else out.clone(memory_format=torch.contiguous_format))
    return pytree.unflatten(params, flat)


def measure_collective_seconds(group, payload_bytes, repeats: int = 3,
                               kind: str = "psum") -> float:
    """Wall seconds of ONE round's model-parallel collectives over
    ``group`` (a ``repro_torch.distributed.group.ModelGroup``): one
    collective per payload, float32 buffers on the group's device, best of
    ``repeats`` after a warm-up call.  Every rank of the group must call
    it.  This calibrates ``EngineStats.collective_s``: the verify's
    collectives run inside the superstep, so the engine attributes
    ``probe x rounds`` per dispatch.

    ``kind``: ``"psum"`` (the TP all-reduces, the EP and SP combines) or
    ``"all_to_all"`` (the EP token exchange and the Ulysses trades), on a
    (world, n/world) buffer that keeps its shape while every element
    crosses the group.  The two are calibrated separately: an all-reduce
    moves more bytes than an all-to-all of the same buffer."""
    if kind not in ("psum", "all_to_all"):
        raise ValueError(f"unknown collective kind {kind!r}")
    payloads = [max(int(b) // 4, 1) for b in payload_bytes]
    if not payloads or group is None or group.world <= 1:
        return 0.0
    world, dev = group.world, group.device
    if kind == "psum":
        xs = [torch.zeros((n,), device=dev) for n in payloads]

        def run():
            for x in xs:
                group.psum(x)
    else:
        xs = [torch.zeros((world, max(n // world, 1)), device=dev) for n in payloads]

        def run():
            for x in xs:
                group.all_to_all(x, 0, 0)

    def timed():
        t0 = time.perf_counter()
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    timed()  # warm
    return min(timed() for _ in range(max(repeats, 1)))


def measure_collective_seconds_by_kind(group, payloads_by_kind, repeats: int = 3) -> dict:
    """``{"psum": [bytes...], "all_to_all": [...]}`` -> ``{"psum": seconds,
    "all_to_all": seconds}`` (kinds with an empty schedule omitted)."""
    out = {}
    for kind, payloads in dict(payloads_by_kind).items():
        payloads = [int(b) for b in payloads if int(b) > 0]
        if payloads:
            out[kind] = measure_collective_seconds(group, payloads, repeats=repeats,
                                                   kind=kind)
    return out


def zero1_pspec(spec, shape, mesh) -> PartitionSpec:
    """Add ``data`` sharding on the first large axis a param leaves
    replicated: ZeRO-1 for the AdamW mu / nu tensors.  Falls back to the
    original spec when no axis divides evenly."""
    sizes = _axis_sizes(mesh)
    if "data" not in sizes:
        return spec
    dsize = sizes["data"]
    shape = leaf_shape(shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsize == 0 and dim >= dsize:
            entries[i] = "data"
            return P(*entries)
    return spec


def fsdp_pspecs(axes_tree, shapes, mesh, min_shard_elems: int = 65536):
    """ZeRO-3 / FSDP layout: every large param shards its largest
    evenly-dividing dim over the flattened ("data", "model") pair (or over
    ``model`` alone where nothing divides the pair)."""
    sizes = _axis_sizes(mesh)
    axes = tuple(a for a in ("data", "model") if a in sizes)
    world = math.prod(sizes[a] for a in axes)

    def fit(logical, shape):
        if math.prod(shape) < min_shard_elems:
            return P()
        cands = [i for i, (ax, dim) in enumerate(zip(logical, shape))
                 if ax != "layers" and dim % world == 0 and dim >= world]
        entry = axes
        if not cands:
            m = sizes["model"]
            cands = [i for i, (ax, dim) in enumerate(zip(logical, shape))
                     if ax != "layers" and dim % m == 0 and dim >= m]
            if not cands:
                return P()
            entry = "model"
        entries = [None] * len(shape)
        entries[max(cands, key=lambda i: shape[i])] = entry
        return P(*entries)

    return _zip_map(fit, axes_tree, shapes)


def replicated_pspecs(axes_tree):
    """DP-serve layout: every weight replicated."""
    return pytree.map(lambda _: P(), axes_tree)


def opt_state_pspecs(param_pspec_tree, param_shapes, mesh, zero1: bool = True) -> dict:
    """mu / nu mirror the params (ZeRO-1 sharded where ``zero1``); step is
    replicated."""
    if zero1:
        mu = _zip_map(lambda spec, shape: zero1_pspec(spec, shape, mesh),
                      param_pspec_tree, param_shapes)
    else:
        mu = param_pspec_tree
    return {"mu": mu, "nu": mu, "step": P()}
