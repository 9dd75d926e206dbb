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
``measure_collective_seconds`` times them over that group.  The mesh
trainer (``repro_torch.training.train_step``) lays params out by
``param_pspecs`` or ``fsdp_pspecs`` and AdamW's state by
``train_opt_pspecs`` over a ``MeshGroups``: ``shard_params`` cuts on every
axis a spec names (``pod``, ``data``, ``model``, or a tuple of them on one
dim), ``gather_params`` is its inverse, and ``tp_paths`` says which
leaves the blocks compute tensor-parallel on.
The serve CLI's ``--mesh`` lays the continuous engine's slot batch out by
``chain_state_shardings(mesh)``: a ``ChainStateSharding`` that says which
contiguous block of the leading slot axis this rank holds, the rows
``NamedSharding(mesh, batch_pspec(mesh))`` gives its device (every model
rank of a block holds the same rows), and its weights by a ``ServeLayout``
(``param_pspecs`` over the mesh, the JAX CLI's ``_build``): a rank keeps
its blocks, and the model function reads ``gather_at_use`` of them, the
step the mesh trainer takes before its forward too.
``get_shard_map``, ``slots_mesh``, ``serving_mesh``, ``shard_pspecs``,
``shardings_from_pspecs`` and ``abstract_params`` are JAX mesh plumbing
(``shard_map``, ``NamedSharding``, ``eval_shape``) with no counterpart:
the port's sharded front end stacks its shards itself, and a rank holds
its own slice.
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


class ChainStateSharding:
    """The slot batch's layout over a mesh of ranks (a ``MeshGroups``), the
    port's ``NamedSharding(mesh, batch_pspec(mesh))``: the leading slot axis
    of every ``ASDChainState`` field is cut over the batch axes ("pod",
    "data") into ``ranks`` contiguous blocks, pod-major, and this rank holds
    block ``index`` = ``mesh.index(("pod", "data"))``; the ``model`` axis
    does not cut it, so every model rank of a block holds the same rows.
    ``group`` is the ``ModelGroup`` of the batch axes, whose rank is
    ``index``; ``model_group`` that of the ``model`` axis (of world 1 where
    the axis is 1), over which a ``ServeLayout`` cuts the weights."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
        self.ranks = mesh.size(self.axes)
        self.index = mesh.index(self.axes)
        self.group = mesh.group(self.axes)
        self.model_group = mesh.group(("model",))
        assert self.group.rank == self.index and self.group.world == self.ranks

    def __repr__(self) -> str:
        return f"ChainStateSharding(axes={self.axes}, ranks={self.ranks}, index={self.index})"

    def rows(self, n: int) -> slice:
        """This rank's block of a slot axis of ``n`` rows; ``n`` must split
        evenly, as ``NamedSharding`` requires."""
        if n % self.ranks:
            raise ValueError(
                f"a slot axis of {n} rows does not split over the {self.ranks} ranks of "
                f"the batch axes {self.axes}: its size must be divisible by {self.ranks}")
        m = n // self.ranks
        return slice(self.index * m, (self.index + 1) * m)


def chain_state_shardings(mesh) -> ChainStateSharding:
    """The continuous engine's slot-batch layout over ``mesh`` (a
    ``MeshGroups``): the worker's ``state_sharding``."""
    return ChainStateSharding(mesh)


class ServeLayout:
    """The weights' layout on one rank of a serve mesh, the JAX CLI's
    ``param_pspecs(boxed, mesh)`` (``src/repro/launch/serve.py::_build``):
    ``specs`` (``param_pspecs`` of the logical axes and shapes over
    ``mesh``, a ``MeshGroups``; they name ``model`` alone, so every model
    rank of a batch block holds the same blocks as its peers of the other
    blocks), ``tp`` (``tp_paths``: the leaves the blocks compute
    tensor-parallel on, over ``model_group``), ``gathered`` (the paths of
    every other leaf the layout cuts) and the mesh.  ``shard`` keeps this
    rank's blocks; ``at_use`` is what the forward reads, each leaf whole
    (a ``gathered`` leaf all-gathered over the ``model`` group, at every
    call) or this rank's tensor-parallel block.  ``gathers`` counts the
    calls of ``at_use``, ``gathered_elements`` and ``gathered_bytes`` what
    they gathered."""

    def __init__(self, axes_tree, shapes, mesh):
        self.mesh = mesh
        self.specs = param_pspecs(axes_tree, shapes, mesh)
        self.tp = tp_paths(axes_tree, self.specs)
        self.model_group = mesh.group(("model",))
        self.gathered = frozenset() if self.model_group.world == 1 else frozenset(
            path for path, spec in pytree.paths(self.specs)
            if mentions_model(spec) and path not in self.tp)
        self.gathers = self.gathered_elements = self.gathered_bytes = 0

    @property
    def tp_axis(self):
        """The model group where the blocks compute tensor-parallel, else
        None."""
        return self.model_group if self.tp and self.model_group.world > 1 else None

    def shard(self, params):
        return shard_params(params, self.specs, self.mesh)

    def at_use(self, blocks):
        out = gather_at_use(blocks, self.specs, self.tp, self.mesh)
        self.gathers += 1
        for path, leaf in pytree.paths(out):
            if path in self.gathered:
                self.gathered_elements += leaf.numel()
                self.gathered_bytes += leaf.numel() * leaf.element_size()
        return out

    def local_bytes(self, params) -> int:
        """The bytes of this rank's blocks of the whole ``params``."""
        return local_bytes(params, self.specs, self.mesh)


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


def entry_mesh_axes(mesh, entry) -> tuple:
    """The mesh axes of a spec entry that the mesh has (an axis it lacks
    has one rank), in the entry's order, which must be the mesh's."""
    axes = tuple(a for a in _entry_axes(entry) if a in mesh.axis_names)
    order = [mesh.axis_names.index(a) for a in axes]
    if order != sorted(order):
        raise ValueError(f"spec entry {entry!r}: its axes are not in the mesh's order "
                         f"{mesh.axis_names}")
    return axes


def shard_params(params, specs, mesh):
    """This rank's share of ``params`` under ``specs`` (a tree of
    ``PartitionSpec``) on ``mesh``, a ``repro_torch.distributed.group.
    MeshGroups`` (the serving model group's is ``MeshGroups((world,),
    ("model",), rank)``, coordinates only).  Each dim whose entry names
    mesh axes is cut into as many contiguous blocks as those axes have
    ranks together, and the rank keeps the block of its row-major index
    over them (a tuple entry such as ``("data", "model")`` is data-major,
    as ``NamedSharding`` lays it out), as a contiguous tensor of its own; a
    replicated leaf is the caller's tensor itself.  An axis the mesh does
    not have counts as one rank."""
    flat = []
    for path, leaf, spec in zip_specs(params, specs):
        try:
            index = block_slices(tuple(leaf.shape), spec, mesh)
        except ValueError as exc:
            raise ValueError(f"shard_params: {'.'.join(path)} {exc}") from None
        whole = all(sl == slice(None) for sl in index)
        flat.append(leaf if whole else
                    leaf[index].clone(memory_format=torch.contiguous_format))
    return pytree.unflatten(params, flat)


def block_slices(shape, spec, mesh) -> tuple:
    """The slices of a leaf of ``shape`` that ``shard_params`` keeps on
    this rank of ``mesh`` (for tensors and for a checkpoint's numpy
    leaves)."""
    sizes = mesh.sizes()
    out = [slice(None)] * len(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry_mesh_axes(mesh, entry)
        n, k = shape[dim], math.prod(sizes[a] for a in axes)
        if k == 1:
            continue
        if n % k:
            raise ValueError(f"dim {dim} ({n}) does not divide over {k} ranks")
        i = mesh.index(axes)
        out[dim] = slice(i * (n // k), (i + 1) * (n // k))
    return tuple(out)


def gather_params(shards, specs, mesh):
    """The inverse of ``shard_params``: every leaf whole on every rank,
    all-gathered over the axes of each sharded dim (a collective every
    rank of ``mesh``, a ``MeshGroups``, calls in the same order)."""
    return pytree.unflatten(shards, [gather_leaf(leaf, spec, mesh)
                                     for _, leaf, spec in zip_specs(shards, specs)])


def gather_leaf(leaf, spec, mesh, skip=()):
    """One leaf of ``gather_params``; dims in ``skip`` stay as they are."""
    for dim, entry in enumerate(spec):
        if entry is None or dim in skip:
            continue
        axes = entry_mesh_axes(mesh, entry)
        if mesh.size(axes) > 1:
            leaf = mesh.group(axes).all_gather(leaf, dim)
    return leaf


def tp_dims(specs, tp) -> list:
    """The dim each leaf of ``specs`` (in leaf order) is cut over
    ``"model"`` where its path is in ``tp`` (a tensor-parallel leaf), else
    None."""
    return [next(i for i, e in enumerate(spec) if e == "model") if path in tp else None
            for path, spec in pytree.paths(specs)]


def gather_at_use(params, specs, tp, mesh):
    """The leaves a forward reads from a rank's blocks ``params`` under
    ``specs`` on ``mesh``: every leaf whole (``gather_leaf``), except that
    a leaf of ``tp`` (``tp_paths``) keeps this rank's block of the dim it
    is cut on over ``"model"``, where the blocks compute tensor-parallel.
    A collective every rank of ``mesh`` calls in the same order; the mesh
    trainer takes it once a step, the server at every model call."""
    flat = [gather_leaf(leaf, spec, mesh, skip=() if d is None else (d,))
            for leaf, spec, d in zip(pytree.leaves(params), pytree.leaves(specs),
                                     tp_dims(specs, tp))]
    return pytree.unflatten(params, flat)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's block of a leaf of ``shape`` under ``spec``."""
    sizes = _axis_sizes(mesh)
    out = list(leaf_shape(shape))
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= math.prod(sizes.get(a, 1) for a in _entry_axes(entry))
    return tuple(out)


def local_bytes(tree, specs, mesh, itemsize: int | None = None) -> int:
    """The bytes of a rank's blocks of ``tree`` (tensors, or shapes with
    ``itemsize``) under ``specs`` on ``mesh``."""
    return sum(math.prod(local_shape(leaf, spec, mesh))
               * (leaf.element_size() if itemsize is None else itemsize)
               for _, leaf, spec in zip_specs(tree, specs))


def spec_axes(spec) -> set:
    """Every mesh axis ``spec`` names."""
    return {a for e in spec or () if e is not None for a in _entry_axes(e)}


# the leaves the blocks compute tensor-parallel on, by sub-tree: a block's
# attention (wq, bq column-parallel by heads, wo row-parallel) and its dense
# FFN (w_gate, w_up column-parallel by hidden, w_down row-parallel)
_TP_SUBTREES = {"attn": ("wq", "wo", "bq"), "ffn": ("w_gate", "w_up", "w_down")}


def tp_paths(axes_tree, specs) -> frozenset:
    """The paths of the leaves a mesh step computes tensor-parallel on:
    the ``TP_VERIFY_SIGS`` leaves of a block's ``attn`` and ``ffn``
    sub-trees whose spec shards their head or hidden dim over ``"model"``
    alone and nothing else, where every such leaf of the sub-tree does
    (the blocks slice and psum a whole sub-tree or none of it).  Every
    other sharded leaf is gathered at use."""
    def eligible(axes, spec):
        core = tuple(a for a in axes if a != "layers")
        if core not in TP_VERIFY_SIGS:
            return False
        named = [(i, e) for i, e in enumerate(spec) if e is not None]
        return len(named) == 1 and named[0][1] == "model" and \
            axes[named[0][0]] in ("heads", "mlp")

    by_parent = {}
    for path, axes, spec in zip_specs(axes_tree, specs):
        if len(path) >= 2 and path[-2] in _TP_SUBTREES and path[-1] in _TP_SUBTREES[path[-2]]:
            by_parent.setdefault(path[:-1], []).append((path, eligible(axes, spec)))
    out = set()
    for leaves in by_parent.values():
        if all(ok for _, ok in leaves):
            out.update(path for path, _ in leaves)
    return frozenset(out)


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


def train_opt_pspecs(param_pspec_tree, param_shapes, mesh) -> dict:
    """The mesh trainer's AdamW layout: ``opt_state_pspecs(zero1=True)``,
    except that a leaf whose own spec already shards over ``data`` (an
    FSDP leaf) keeps that spec, where ``zero1_pspec`` would name ``data``
    a second time (a layout no mesh can hold).  For ``param_pspecs``,
    which names no ``data``, the two are the same."""
    def one(spec, shape):
        return spec if "data" in spec_axes(spec) else zero1_pspec(spec, shape, mesh)

    mu = _zip_map(one, param_pspec_tree, param_shapes)
    return {"mu": mu, "nu": mu, "step": P()}


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
