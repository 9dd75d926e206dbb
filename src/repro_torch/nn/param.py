"""Logical sharding axes of the port's params, the counterpart of the JAX
package's ``repro/nn/param.py``.

The JAX package boxes every leaf at init with a tuple of *logical* axis
names (``("embed", "heads", "head_dim")``) and derives mesh layouts from
them.  The port's params are plain tensors in nested dicts, so there is no
``Boxed`` leaf: ``param_axes(dc)`` and ``lm_param_axes(cfg)`` give the tree
of logical axes beside ``weights.param_shapes(dc)`` and
``weights.lm_param_shapes(cfg)``, the same keys, from the same block
descriptions, each stacked leaf with the leading ``"layers"`` axis the JAX
package's ``stack_layers`` adds.

``logical_to_pspec`` maps a tuple of logical axes to a ``PartitionSpec``
through a rules mapping (MaxText style); ``distributed.sharding`` builds
whole layouts from it.  ``PartitionSpec`` is the port's own: a tuple of mesh-axis
names, tuples of them, or ``None``, compared as a tuple; its entries are
canonical as JAX's are, and ``logical_to_pspec`` trims trailing ``None``s
as JAX's does.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.weights import lm_param_shapes, param_shapes

Axes = tuple  # entries: str | None


def _canonical(entry):
    """An entry as JAX's ``PartitionSpec`` stores it: an empty tuple of axes
    is None, a tuple of one axis that axis."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """A mesh layout of one leaf: entry i names the mesh axis (or tuple of
    axes, or None: replicated) that dim i is split over, canonical as in
    JAX (``P(("data",)) == ("data",)``).  ``P()`` is replicated;
    ``P("model", None) == ("model", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# the logical axes of each leaf of a block's sub-tree, by (sub-tree, leaf)
_ATTN = {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed"),
         "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
         "bv": ("kv_heads", "head_dim"), "gate": ()}
_FFN = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}
_MOE = {"router": ("embed", None), "w_gate": ("experts", "embed", "mlp"),
        "w_up": ("experts", "embed", "mlp"), "w_down": ("experts", "mlp", "embed")}
_MAMBA = {"in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
          "x_proj": ("mlp", None), "dt_proj": (None, "mlp"), "dt_bias": ("mlp",),
          "A_log": ("mlp", None), "D": ("mlp",), "out_proj": ("mlp", "embed")}
_MLSTM = {"up_proj": ("embed", "mlp"), "conv_w": (None, "mlp"), "conv_b": ("mlp",),
          "wq": ("mlp", "heads", "head_dim"), "wk": ("mlp", "heads", "head_dim"),
          "wv": ("mlp", "heads", "head_dim"), "w_i": ("mlp", "heads"),
          "w_f": ("mlp", "heads"), "b_i": ("heads",), "b_f": ("heads",),
          "out_norm": ("mlp",), "down_proj": ("mlp", "embed")}
_SLSTM = {"w_gates": ("embed", None, "heads", "head_dim"),
          "r_gates": (None, "heads", "head_dim", None),
          "b_gates": (None, "heads", "head_dim"), "out_norm": ("embed",),
          "up_proj": ("embed", "mlp"), "gate_proj": ("embed", "mlp"),
          "down_proj": ("mlp", "embed")}
_SUBTREES = {"attn": _ATTN, "ffn": _FFN, "moe": _MOE, "mamba": _MAMBA}
# the denoiser's and the LM's leaves outside the decoder
_TOP = {("in_proj",): (None, "embed"), ("t_mlp1",): (None, "embed"),
        ("t_mlp2",): ("embed", "embed2"), ("out_proj",): ("embed", None),
        ("cond_proj",): (None, "embed"), ("final_norm", "scale"): ("embed",),
        ("embed", "table"): ("vocab", "embed"), ("head", "w"): ("embed", "vocab")}


def _leaf_axes(cfg: ModelConfig, path: tuple) -> Axes:
    """The logical axes of the leaf at ``path`` (its keys from the root)."""
    if path[0] != "decoder":
        return _TOP[path]
    desc = cfg.group[int(path[1][1:])]  # "g<i>"
    sub, name = path[2], path[-1]
    if name == "scale" and sub != "cell":  # attn_norm, ffn_norm, mix_norm, norm
        core = ("embed",)
    elif sub == "cell":
        core = (_MLSTM if desc.kind == "mlstm" else _SLSTM)[path[3]]
    else:
        core = _SUBTREES[sub][name]
    return ("layers",) + core


def _axes_tree(cfg: ModelConfig, shapes) -> dict:
    return pytree.unflatten(shapes, [_leaf_axes(cfg, path)
                                     for path, _ in pytree.paths(shapes)])


def param_axes(dc) -> dict:
    """The logical axes of every leaf of ``weights.param_shapes(dc)``: the
    JAX package's ``logical_axes_tree`` of its ``denoiser_init``."""
    return _axes_tree(dc.backbone, param_shapes(dc))


def lm_param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of ``weights.lm_param_shapes(cfg)``:
    the JAX package's ``logical_axes_tree`` of its ``lm_init``."""
    return _axes_tree(cfg, lm_param_shapes(cfg))


def logical_to_pspec(axes: Axes | None, rules: Mapping[str, Any]) -> PartitionSpec:
    """Map a tuple of logical axes to a ``PartitionSpec`` using ``rules``
    (logical name -> mesh axis name, tuple of mesh axes, or None).  Unknown
    names are replicated, a mesh axis appears at most once, and trailing
    ``None`` entries are trimmed."""
    if axes is None:
        return P()
    out, used = [], set()
    for ax in axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        if mesh_ax is not None:
            flat = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
            if any(m in used for m in flat):
                mesh_ax = None
            else:
                used.update(flat)
        out.append(mesh_ax)
    while out and out[-1] is None:
        out.pop()
    return P(*out)
