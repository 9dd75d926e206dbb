"""The dry run: every (architecture x input-shape) cell and every paper ASD
cell, each with its analytic roofline on a production mesh at the NVIDIA
H100's peaks and one measured batch-1 step on the card.  The port's
counterpart of the JAX package's ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --cells all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi \\
        --cells tinyllama-1.1b:train_4k,paper-pixel-dit:asd:memopt
    PYTHONPATH=src python -m repro_torch.analysis.report      # the tables

The JAX module compiles each cell for 512 forced host devices and reads
XLA's cost analysis; it never runs a step.  Here each record carries:

  * the JAX record's analytic part (``params_total``, ``params_active``,
    ``tokens``, ``analytic``, ``model_flops``, ``useful_flops_ratio``) and
    its ``roofline``: the global cell's per-chip terms on the production
    mesh (256 or 512 chips, read from ``launch/mesh.py`` without building
    the mesh) at the H100 constants of ``analysis/roofline.py``, train
    cells at ``TRAIN_ACCUM`` and the config's remat.  The collective term
    is 0 until ROADMAP.md A13;
  * ``measured``: one batch-1 step of the cell's own work on one card,
    or ``too_large`` where the reckoning (``reckon``: weights, optimizer
    state, caches, ASD buffers and the activation estimate written down
    there) passes ``FIT_SHARE`` of the card's memory, decided before
    anything is allocated.  Its ``bound_ms`` is the analytic cost of that
    batch-1 work at the H100 peaks, ``fraction`` that bound over the
    measured ms.

The measured work, matching the JAX builders: train, one AdamW step of
``lm_loss`` (the naive core, remat as the config says) at (1, seq_len),
accum 1, from ``launch/train.py``'s ``build``; prefill, ``lm_prefill`` of
(1, seq_len) into caches of seq_len; decode, one ``lm_decode_step`` at
position seq_len - 1 against a cache of seq_len filled with random values,
captured as a CUDA graph and replayed; ASD, one warm round of the
sampler's loop (``SamplerLoop``, the round ``asd_sample_batched``
replays) at 64 chains (the policy 512 and K 100), theta 8, the eager
head, K 1000, with the variant's noise mode, trajectory and controller:
the median of rounds 2-4.  Every step is the median of at least 3 warm
runs timed with CUDA events.

A record goes to ``<out>/<mesh>/<arch>__<shape>[__variant].json``; a
record already ``ok`` is skipped, so the sweep resumes.  The measured step
does not depend on the mesh: it is kept apart in ``<out>/measured/``, and
the other mesh's run of a cell takes it from there instead of measuring
the cell again.  A cell that
raises is recorded as an error and the sweep goes on.  The sharding
variants (``fsdp``, ``dp``, ``sp``, ``pad48sp``, ``dp256``,
``dp256memopt``, ``fsdpa1``) are refused when ``--cells`` is read: they
are ROADMAP.md A13.  ``--device cpu`` runs the plain versions, for the
tests.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import time
import traceback

import torch

from repro_torch import pytree
from repro_torch.analysis import analytic as an
from repro_torch.analysis import roofline as rl
from repro_torch.configs.base import ALL_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import (ARCHS, PAPER_MODELS, all_cells, get_config,
                                          get_denoiser_config)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.diffusion import DenoiserConfig
from repro_torch.models.lm import casts_to_compute
from repro_torch.weights import lm_param_shapes, param_shapes

# accumulation factor of the global train cells' analytic term (the JAX
# dry run's; the measured step runs accum 1)
TRAIN_ACCUM = 8

# hillclimb variants (the JAX dry run's table): name -> build options
VARIANTS = {
    "": {},
    "fsdp": dict(profile="fsdp"),
    "dp": dict(profile="dp"),
    "pad48": dict(cfg_replace=dict(n_heads=48)),
    "sp": dict(profile="sp"),
    "pad48sp": dict(cfg_replace=dict(n_heads=48), profile="sp"),
    "dp256": dict(profile="dp", n_chains=256),
    "memopt": dict(noise_mode="counter", keep_trajectory=False),
    "dp256memopt": dict(profile="dp", n_chains=256, noise_mode="counter",
                        keep_trajectory=False),
    "aimd": dict(controller="aimd"),
    "acceptrate": dict(controller="accept-rate"),
    "accum2": dict(accum=2),
    "accum32": dict(accum=32),
    "fsdpa1": dict(profile="fsdp", accum=1),
}
_ASD_OPTIONS = ("noise_mode", "keep_trajectory", "controller")

# a cell is measured where its reckoning is at most this share of the card
FIT_SHARE = 0.9
# torch.cuda.mem_get_info's total on an NVIDIA H100 80GB HBM3: what a dry
# run on the CPU reckons against, so that it picks the card's cells
H100_BYTES = 85_017_493_504
ASD_THETA = 8
ASD_CHAINS = 64
ASD_K = 1000
WARM_RUNS = 3
SEED = 0


def refusal(variant: str) -> str | None:
    """Why ``variant`` cannot run on one card, or None."""
    profile = VARIANTS.get(variant, {}).get("profile")
    if profile is None:
        return None
    return (f"variant {variant!r} is the {profile!r} sharding profile: sharding over a "
            "mesh of cards is ROADMAP.md A13")


def parse_cells(spec: str) -> list[tuple[str, str, str]]:
    """``--cells``: "all" (every unskipped (arch, shape) cell, then the
    paper cells), "paper", or a comma list of arch:shape[:variant].
    Raises ValueError for an unknown arch, shape or variant, and for a
    sharding variant (naming ROADMAP.md A13)."""
    if spec in ("all", "paper"):
        cells = [] if spec == "paper" else [
            (arch, shape.name, "") for arch, shape, skipped in all_cells() if not skipped]
        return cells + [(pm, "asd", "") for pm in PAPER_MODELS]
    cells = []
    for cell in spec.split(","):
        parts = cell.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"cell {cell!r}: expected arch:shape[:variant]")
        arch, shape, variant = parts[0], parts[1], parts[2] if len(parts) == 3 else ""
        if arch not in ARCHS and arch not in PAPER_MODELS:
            raise ValueError(f"cell {cell!r}: unknown arch {arch!r}")
        if arch not in PAPER_MODELS and shape not in [s.name for s in ALL_SHAPES]:
            raise ValueError(f"cell {cell!r}: unknown shape {shape!r}")
        if variant not in VARIANTS:
            raise ValueError(f"cell {cell!r}: unknown variant {variant!r}; have "
                             f"{sorted(VARIANTS)}")
        refused = refusal(variant)
        if refused is not None:
            raise ValueError(f"cell {cell!r}: {refused}")
        cells.append((arch, shape, variant))
    return cells


# ------------------------------------------------------------------ cells


@dataclasses.dataclass
class Cell:
    """One cell as it runs: the config (an LM's, or a paper denoiser's
    backbone), its shape or its ASD settings."""

    arch: str
    shape_name: str
    variant: str
    kind: str  # train | prefill | decode | asd
    cfg: ModelConfig
    shape: InputShape | None = None
    dc: DenoiserConfig | None = None
    accum: int | None = None
    n_chains: int = ASD_CHAINS
    K: int = ASD_K
    noise_mode: str = "buffer"
    keep_trajectory: bool = True
    controller: str = "static"


def resolve_cell(arch: str, shape_name: str, variant: str = "", config=None,
                 seq_len: int | None = None, n_chains: int | None = None,
                 K: int | None = None) -> Cell:
    """The cell ``arch`` x ``shape_name`` under ``variant``.  ``config`` (a
    ``ModelConfig`` for an LM, a ``DenoiserConfig`` for a paper model),
    ``seq_len``, ``n_chains`` and ``K`` replace the published ones (tests
    run reduced cells)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    refused = refusal(variant)
    if refused is not None:
        raise ValueError(refused)
    opts = dict(VARIANTS[variant])
    cfg_replace = opts.pop("cfg_replace", None)
    if arch in PAPER_MODELS:
        if "accum" in opts:
            raise ValueError(f"variant {variant!r} sets a train cell's accumulation; "
                             f"{arch} is an ASD cell")
        dc = config or get_denoiser_config(arch)
        chains, k = opts.pop("n_chains", ASD_CHAINS), ASD_K
        if arch == "paper-diffusion-policy":
            k, chains = 100, max(chains, 512)
        return Cell(arch, shape_name, variant, "asd", dc.backbone, dc=dc,
                    n_chains=n_chains or chains, K=K or k, **opts)
    if any(o in opts for o in _ASD_OPTIONS):
        raise ValueError(f"variant {variant!r} is an ASD sampler option; {arch} is an LM")
    cfg = config or get_config(arch)
    if cfg_replace:
        cfg = dataclasses.replace(cfg, **cfg_replace)
    shape = next((s for s in ALL_SHAPES if s.name == shape_name), None)
    if shape is None:
        raise ValueError(f"unknown shape {shape_name!r}")
    if seq_len:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    return Cell(arch, shape_name, variant, shape.kind, cfg, shape=shape,
                accum=opts.get("accum"))


def _meta_tree(shapes):
    """The tree of ``shapes`` as tensors on the meta device (nothing
    allocated)."""
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def meta_params(cell: Cell):
    """The port's parameter tree of the cell, on the meta device."""
    return _meta_tree(param_shapes(cell.dc) if cell.kind == "asd" else
                      lm_param_shapes(cell.cfg))


def _keystr(path: tuple) -> str:
    """A leaf's path in ``jax.tree_util.keystr``'s form: the port's tree
    has the JAX package's dict keys, so "['decoder']['g0']['moe']['w_up']"
    names the same leaf in both."""
    return "".join(f"[{k!r}]" for k in path)


def param_counts(cfg: ModelConfig, tree) -> tuple[int, int]:
    """(total, active) parameter counts; active discounts unrouted experts
    leaf by leaf, as the JAX dry run's ``_param_counts``: a leaf whose path
    names ``moe`` and not ``router`` counts n * top_k // n_experts."""
    total = active = 0
    for path, leaf in pytree.paths(tree):
        key = _keystr(path)
        n = leaf.numel()
        total += n
        if "moe" in key and "router" not in key and cfg.n_experts:
            active += n * cfg.top_k // cfg.n_experts
        else:
            active += n
    return total, active


def asd_round_cost(cfg: ModelConfig, seq_len: int, n_chains: int,
                   total_params: int) -> an.CellCost:
    """One verification round of the ASD loop: 1 + theta (8) denoiser
    forwards a chain (the JAX dry run's inline cost)."""
    fwd = an.model_fwd_flops(cfg, seq_len)
    return an.CellCost(
        flops=n_chains * 9 * fwd,
        hbm_bytes=total_params * 2 * 2 + n_chains * 9 * seq_len * cfg.n_layers * cfg.d_model * 2 * 2,
        model_flops=2.0 * total_params * n_chains * 9 * seq_len,
        notes=f"one ASD round (theta=8 +1 head), {n_chains} chains",
    )


def _cell_cost(cell: Cell, total: int, batch1: bool) -> an.CellCost:
    """The analytic cost of the global cell (``batch1`` False: the shape's
    global batch, ``TRAIN_ACCUM`` or the variant's accum) or of the
    measured batch-1 work (accum 1)."""
    if cell.kind == "asd":
        return asd_round_cost(cell.cfg, cell.dc.seq_len, cell.n_chains, total)
    if batch1:
        return an.analyze_cell(cell.cfg, dataclasses.replace(cell.shape, global_batch=1),
                               total, accum=1, remat=cell.cfg.remat)
    return an.analyze_cell(cell.cfg, cell.shape, total, accum=cell.accum or TRAIN_ACCUM,
                           remat=cell.cfg.remat)


def analytic_record(cell: Cell, mesh_name: str) -> dict:
    """The JAX record's analytic fields for the global cell on the
    production mesh ``mesh_name`` ("single" or "multi")."""
    shape, axes = production_mesh_shape(multi_pod=mesh_name == "multi")
    n_chips = math.prod(shape)
    total, active = param_counts(cell.cfg, meta_params(cell))
    if cell.kind == "asd":
        tokens = cell.n_chains * cell.dc.seq_len
    else:
        B, L = cell.shape.global_batch, cell.shape.seq_len
        tokens = B * L if cell.kind != "decode" else B
    cost = _cell_cost(cell, total, batch1=False)
    roof = rl.analyze(cost, n_chips)
    terms = {"compute": roof.t_compute, "memory": roof.t_memory,
             "collective": roof.t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return dict(
        devices=n_chips,
        mesh_shape=list(shape),
        mesh_axes=list(axes),
        params_total=total,
        params_active=active,
        tokens=tokens,
        analytic=cost.as_dict(),
        model_flops=cost.model_flops,
        useful_flops_ratio=(cost.model_flops / cost.flops) if cost.flops else None,
        roofline={
            "t_compute_s": terms["compute"],
            "t_memory_s": terms["memory"],
            "t_collective_s": terms["collective"],
            "dominant": dominant,
            "bound_s": bound,
            "roofline_fraction": terms["compute"] / bound if bound else None,
        },
    )


# -------------------------------------------------------------- reckoning


def _elem(dtype_name: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()


def _compute_leaf_numel(tree, cell: Cell) -> int:
    """Elements of the leaves the cell's step uses in the compute dtype."""
    if cell.kind == "asd":
        from repro_torch.models.diffusion import _COMPUTE_LEAVES

        return sum(t.numel() for p, t in pytree.paths(tree) if p[-1] in _COMPUTE_LEAVES)
    return sum(t.numel() for p, t in pytree.paths(tree) if casts_to_compute(p))


def _ffn_bytes(cfg: ModelConfig, T: int, c: int) -> int:
    """The live set of one FFN call over T tokens at its peak (x, the gate
    and up products, the float32 gate and its silu: ``nn/ffn.py``), or of
    the MoE layer's (``_moe_bytes``)."""
    if not cfg.d_ff:
        return 0
    return T * cfg.d_model * c + T * cfg.d_ff * (2 * c + 8)


def _moe_bytes(cfg: ModelConfig, T: int, c: int) -> int:
    """The live set of ``nn/moe.py::moe_apply`` over one row of T tokens
    at its peak, phase by phase: the gather (its index_select and the
    masked copy, (E, C, d) each), the expert SwiGLU (xg, the (E, C, ff)
    gate and up products, the float32 gate and its silu; at its end xg,
    g, u, h and y), the combine (y, y times the gates, y's rows with the
    zero row, the (T, k, d) parts and the (E, T) int64 slot map)."""
    from repro_torch.nn.moe import capacity_of

    E, k, d, ff = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff
    C = capacity_of(cfg, T)
    xg, h, h32 = E * C * d * c, E * C * ff * c, E * C * ff * 4
    route = T * E * 4 * 4
    return route + max(2 * xg, xg + 2 * h + 2 * h32, 2 * xg + 3 * h,
                       3 * xg + T * k * d * c + E * T * 8)


def _mixer_bytes(cfg: ModelConfig, desc, T: int, c: int) -> int:
    """The mixers' working sets over T tokens: the mamba mixer's (B, L,
    din) float32 activations and one chunk's (1024, N * din) decay, drive,
    h and readout; the xLSTM cells' float32 state-sized terms."""
    din = cfg.d_inner
    if desc.kind == "hymba":
        return T * din * 4 * 8 + min(T, 1024) * din * cfg.ssm_state * 4 * 4
    if desc.kind == "mlstm":
        return T * 2 * cfg.d_model * 4 * 8 + min(T, 1024) ** 2 * cfg.n_heads * 4 * 3
    if desc.kind == "slstm":
        return T * cfg.d_model * 4 * 12
    return 0


def _layer_bytes(cfg: ModelConfig, T: int, c: int) -> int:
    """One layer's forward live set over T tokens without a saved score
    matrix (B2, or a decode step): the residual stream and the largest of
    the attention projections, the mixer and the FFN or MoE."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    resid = 6 * T * d * c
    attn = T * (2 * H + 4 * KV) * hd * c
    mixer = max((_mixer_bytes(cfg, desc, T, c) for desc in cfg.group), default=0)
    moe = any(desc.moe for desc in cfg.group)
    ffn = _moe_bytes(cfg, T, c) if moe else _ffn_bytes(cfg, T, c)
    return resid + max(attn, mixer, ffn)


def reckon(cell: Cell) -> dict:
    """The bytes the cell's measured step needs on the card, by part, and
    their ``total``; nothing is allocated.

    Weights at the compute dtype where the step uses them so (4 bytes
    others), or for a train step 16 bytes a parameter (float32 params,
    gradients and both moments) plus the bf16 casts.  Caches at batch 1
    (``kv_cache_bytes``; made a layer at a time and then stacked, so twice
    that while they are made).  ASD: the float32 weights and their compute
    copies, u_buf, xi_buf and the trajectory (buffer mode), the draw of
    xi_buf (~10 float32 temporaries an element: threefry's words and their
    copies, the float64 uniform, erf_inv's terms), the chains' rows.

    The activation estimate: one layer's live set (``_layer_bytes``) over
    the step's tokens; for training three of them (the forward a
    checkpointed layer recomputes, its saved tensors and its gradients)
    plus every layer's checkpointed input, the naive core's (H, L, L)
    scores (bf16 products, their float32 copy and softmax, the same again
    backward: 20 bytes a score), the logits, their float32 copies and
    their gradients, and AdamW's group of at most 1 GiB beside the largest
    leaf twice; for
    an ASD round the verification call's layer (theta points a chain) and
    eight chain-row temporaries a point (the rollout and GRS).  The cold
    round's capture allocates from a pool of its own once the eager
    round's blocks are free, so it adds no peak.  Parts that do not live
    together (the caches while they are stacked and the prefill's layer;
    the xi_buf draw and the rounds) count their larger."""
    tree = meta_params(cell)
    cfg = cell.cfg
    c = _elem(cfg.compute_dtype)
    total = sum(t.numel() for t in pytree.leaves(tree))
    n_compute = _compute_leaf_numel(tree, cell)
    parts = {}
    if cell.kind == "asd":
        dc, nch = cell.dc, cell.n_chains
        theta = min(ASD_THETA, cell.K)
        n = cell.K + theta + 1
        ev = dc.seq_len * dc.d_data * 4
        parts["weights"] = total * 4 + n_compute * c
        parts["chains"] = nch * ev * ((n if cell.keep_trajectory else theta + 1) + 2)
        if cell.noise_mode == "buffer":
            parts["noise_buffers"] = nch * n * (ev + 4)
            parts["noise_draw"] = 10 * nch * n * ev
        T = nch * theta * dc.seq_len
        parts["round"] = _layer_bytes(cfg, T, c) + 8 * nch * theta * ev
        parts["total"] = parts["weights"] + parts["chains"] + parts.get("noise_buffers", 0) + \
            max(parts.get("noise_draw", 0), parts["round"])
        return parts
    L = cell.shape.seq_len
    vision = cfg.n_vision_tokens * cfg.d_model * c
    if cell.kind == "train":
        largest = max(t.numel() for t in pytree.leaves(tree)) * 4
        parts["params_grads_adam"] = 16 * total
        parts["compute_casts"] = n_compute * c
        scores = max((cfg.n_heads * L * L * 20 for d in cfg.group
                      if d.kind in ("attn", "hymba", "xattn")), default=0)
        parts["activations"] = (3 * _layer_bytes(cfg, L, c) + cfg.n_layers * L * cfg.d_model * c
                                + scores + L * cfg.vocab_size * (c + 18) + vision)
        parts["optimizer_temporaries"] = (1 << 30) + 2 * largest
        parts["total"] = sum(parts.values())
        return parts
    parts["weights"] = n_compute * c + (total - n_compute) * 4
    parts["caches"] = int(an.kv_cache_bytes(cfg, 1, L))
    T = L if cell.kind == "prefill" else 1
    parts["activations"] = _layer_bytes(cfg, T, c) + cfg.vocab_size * 4 * 2 + 2 * vision
    parts["total"] = parts["weights"] + parts["caches"] + max(parts["caches"],
                                                              parts["activations"])
    return parts


def capacity_bytes(device) -> int:
    """The memory a cell is reckoned against: the card's total
    (``torch.cuda.mem_get_info``), or on the CPU the H100's."""
    dev = torch.device(device)
    return torch.cuda.mem_get_info(dev)[1] if dev.type == "cuda" else H100_BYTES


# ---------------------------------------------------------------- measure


def _launch_counts() -> dict:
    """Every kernel wrapper's launches so far, by kernel (B7's forward and
    backward apart)."""
    from repro_torch.kernels.flash_attention.ops import flash_f32, flash_wgmma
    from repro_torch.kernels.grs.ops import grs
    from repro_torch.kernels.pack.ops import gather_rows, scatter_rows
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.superstep.ops import fused_gather, fused_verify_commit

    return {"grs": grs.launches, "flash_attention": flash_wgmma.launches,
            "flash_attention_f32": flash_f32.launches, "gather_rows": gather_rows.launches,
            "scatter_rows": scatter_rows.launches, "fused_gather": fused_gather.launches,
            "fused_verify_commit": fused_verify_commit.launches,
            "ssm_scan": linear_scan.launches - linear_scan.backward_launches,
            "ssm_scan_backward": linear_scan.backward_launches}


def _timed(fn, dev, runs: int) -> list:
    """Milliseconds of each of ``runs`` calls of ``fn``: CUDA events around
    each call on the card (the host clock on the CPU)."""
    out = []
    for _ in range(runs):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _lm_inputs(cfg: ModelConfig, n: int, dev, gen):
    """(token ids (1, n), or frames (1, n, d_model) in the compute dtype;
    the vision stub's (1, Nv, d_model) in the compute dtype, or None)."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.embed_inputs:
        inputs = torch.randint(0, cfg.vocab_size, (1, n), generator=gen, device=dev)
    else:
        inputs = torch.randn(1, n, cfg.d_model, generator=gen, device=dev).to(cdt)
    vision = None
    if cfg.family == "vlm":
        vision = torch.randn(1, cfg.n_vision_tokens, cfg.d_model, generator=gen,
                             device=dev).to(cdt)
    return inputs, vision


def _measure_train(cell: Cell, dev) -> dict:
    from repro_torch.launch.train import build

    cfg, L = cell.cfg, cell.shape.seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    train_step, init, _ = build(cfg, None, accum=1, lr=3e-4, total_steps=100_000,
                                device=dev)
    state = list(init())
    tokens, vision = _lm_inputs(cfg, L, dev, gen)
    batch = {"tokens": tokens, "labels": torch.randint(0, cfg.vocab_size, (1, L),
                                                       generator=gen, device=dev)}
    if vision is not None:
        batch["vision"] = vision
    metrics = {}

    def step():
        state[0], state[1], m = train_step(state[0], state[1], batch)
        metrics.update(m)

    return dict(fn=step, tokens=L, finite=lambda: bool(metrics["finite"]),
                step="train step",
                what=f"one AdamW step of lm_loss (naive attention core, remat {cfg.remat}) at "
                     f"(1, {L}), accum 1 (launch/train.py build)")


def _measure_prefill(cell: Cell, dev) -> dict:
    from repro_torch.models.lm import lm_cache_init, lm_prefill
    from repro_torch.weights import init_lm_params

    cfg, L = cell.cfg, cell.shape.seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = init_lm_params(cfg, SEED, device=dev, dtype=getattr(torch, cfg.compute_dtype))
    tokens, vision = _lm_inputs(cfg, L, dev, gen)
    caches = lm_cache_init(params, cfg, 1, L)
    out = {}

    def step():
        with torch.no_grad():
            out["logits"], _ = lm_prefill(params, tokens, caches, cfg, vision=vision)

    return dict(fn=step, tokens=L, finite=lambda: bool(torch.isfinite(out["logits"]).all()),
                step="prefill", what=f"lm_prefill of (1, {L}) into caches of {L}")


def _measure_decode(cell: Cell, dev) -> dict:
    from repro_torch.models.lm import lm_cache_init, lm_decode_step
    from repro_torch.programs import SuperstepProgram
    from repro_torch.weights import init_lm_params

    cfg, S = cell.cfg, cell.shape.seq_len
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = init_lm_params(cfg, SEED, device=dev, dtype=getattr(torch, cfg.compute_dtype))
    caches = lm_cache_init(params, cfg, 1, S)
    for leaf in pytree.leaves(caches):
        if leaf.is_floating_point():
            leaf.uniform_(0.0, 1.0, generator=gen)  # the step's cost is not the values'
    inputs, _ = _lm_inputs(cfg, 1, dev, gen)
    token = inputs[:, 0] if cfg.embed_inputs else inputs
    pos = torch.tensor(S - 1, device=dev)
    out = {}

    def body():
        with torch.no_grad():
            out["logits"], _ = lm_decode_step(params, token, caches, pos, cfg)

    prog = SuperstepProgram(body, dev)
    prog()  # the cold dispatch: on the card it runs the step and captures it
    how = ("captured as a CUDA graph and replayed" if dev.type == "cuda" else
           "run eagerly (the CPU has no graphs)")
    return dict(fn=prog, runs=5, tokens=1, program=prog,
                finite=lambda: bool(torch.isfinite(out["logits"]).all()),
                step="decode step" + (" (graph)" if dev.type == "cuda" else ""),
                what=f"one lm_decode_step at position {S - 1} against a cache of {S} filled "
                     f"with random values, {how}")


def _measure_asd(cell: Cell, dev) -> dict:
    from repro_torch.core import prng
    from repro_torch.core.asd import SamplerLoop, init_chain_state
    from repro_torch.core.controller import make_controller
    from repro_torch.core.schedules import ddpm
    from repro_torch.models.diffusion import make_ddpm_model_fn
    from repro_torch.weights import init_denoiser_params

    dc, nch = cell.dc, cell.n_chains
    sched = ddpm(cell.K).to(dev)
    model_fn = make_ddpm_model_fn(init_denoiser_params(dc, SEED, device=dev), dc)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    y0 = torch.randn(nch, dc.seq_len, dc.d_data, generator=gen, device=dev)
    keys = prng.split(prng.PRNGKey(SEED, device=dev), nch)
    ctrl = make_controller(cell.controller)
    st = init_chain_state(sched, y0, ASD_THETA, cell.keep_trajectory, ctrl, key=keys,
                          noise_mode=cell.noise_mode)
    loop = SamplerLoop(model_fn, sched, st, ASD_THETA, eager_head=True,
                       keep_trajectory=cell.keep_trajectory, controller=ctrl,
                       noise_mode=cell.noise_mode)
    del st
    loop.program()  # round 1: the cold dispatch (on the card, the capture)
    tokens = nch * (ASD_THETA + 1) * dc.seq_len
    return dict(fn=loop.program, tokens=tokens, warm=0, program=loop.program,
                finite=lambda: bool(torch.isfinite(loop.state.y).all()),
                step="ASD round", what=f"one warm ASD round (SamplerLoop's round, replayed as "
                     f"asd_sample_batched replays it; rounds 2-{WARM_RUNS + 1}): {nch} chains, "
                     f"theta {ASD_THETA}, eager head, K {cell.K}, {cell.noise_mode} noise, "
                     f"trajectory {'kept' if cell.keep_trajectory else 'not kept'}, "
                     f"controller {cell.controller}")


_MEASURES = {"train": _measure_train, "prefill": _measure_prefill,
             "decode": _measure_decode, "asd": _measure_asd}


def device_label(dev) -> str:
    """The card's name and power limit as nvidia-smi prints them (the torch
    name where nvidia-smi is missing), or "cpu"."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={dev.index or 0}"],
                             capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def measure(cell: Cell, dev) -> dict:
    """The cell's ``measured`` record: its batch-1 step run once cold and
    ``WARM_RUNS`` times warm (the median), or ``too_large`` before anything
    is allocated where the reckoning passes ``FIT_SHARE`` of the device's
    memory (``capacity_bytes``)."""
    parts = reckon(cell)
    capacity = capacity_bytes(dev)
    limit = FIT_SHARE * capacity
    rec = dict(batch=cell.n_chains if cell.kind == "asd" else 1,
               reckoned_gb=parts["total"] / 1e9,
               reckoned_parts_gb={k: v / 1e9 for k, v in parts.items() if k != "total"},
               capacity_gb=capacity / 1e9, limit_gb=limit / 1e9, device=device_label(dev))
    if parts["total"] > limit:
        rec.update(status="too_large", what="nothing: the reckoning passes the limit")
        return rec
    total, _ = param_counts(cell.cfg, meta_params(cell))
    cost = _cell_cost(cell, total, batch1=True)
    peak = rl.peak_flops(cell.cfg.compute_dtype)
    t_ops, t_bytes = cost.flops / peak, cost.hbm_bytes / rl.HBM_BW
    rec.update(bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               bound_flops=cost.flops, bound_bytes=cost.hbm_bytes)
    _free(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    job = None
    try:
        job = _MEASURES[cell.kind](cell, dev)
        for _ in range(job.get("warm", 1)):
            job["fn"]()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        args = (torch.cuda.memory_allocated(dev) - base) if dev.type == "cuda" else None
        before = _launch_counts()
        runs = job.get("runs", WARM_RUNS)
        times = _timed(job["fn"], dev, runs)
        after = _launch_counts()
        finite = job["finite"]()
        mem = rl.memory_stats(args, dev, base)
        ms = statistics.median(times)
        rec.update(status="ok", step=job["step"], what=job["what"], runs_ms=times, ms=ms,
                   tokens=job["tokens"], tokens_per_s=job["tokens"] / ms * 1e3,
                   peak_gb=None if mem["peak_bytes"] is None else mem["peak_bytes"] / 1e9,
                   memory=mem, finite=finite, fraction=rec["bound_ms"] / ms,
                   launches_per_run={k: (after[k] - before[k]) / runs for k in after})
        program = job.get("program")
        if program is not None and dev.type == "cuda":
            rec["capture_ms"] = program.capture_ms
    finally:
        del job
        _free(dev)
    return rec


# ------------------------------------------------------------------- cells


def _out_path(out_dir: str, arch: str, shape_name: str, variant: str) -> str:
    suffix = f"__{variant}" if variant else ""
    return os.path.join(out_dir, f"{arch}__{shape_name}{suffix}.json")


def _measured(cell: Cell, dev, mesh_name: str, path: str | None) -> dict:
    """``measure(cell, dev)``, or the record kept at ``path`` where one taken
    on the same device is there (another mesh's run of the cell); a new
    record is kept there."""
    if path and os.path.exists(path):
        with open(path) as f:
            kept = json.load(f)
        if kept.get("device") == device_label(dev):
            return kept
    m = dict(measure(cell, dev), measured_in=mesh_name)
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(m, f, indent=1, default=str)
    return m


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str, variant: str = "",
             *, device=None, config=None, seq_len: int | None = None,
             n_chains: int | None = None, K: int | None = None,
             measured_dir: str | None = None) -> dict:
    """One cell's record, written to ``out_dir``: its analytic roofline on
    the production mesh ``mesh_name`` and its measured batch-1 step on
    ``device`` (None means "cuda").  A record there already ``ok`` is
    returned as it is.  ``config``, ``seq_len``, ``n_chains`` and ``K``
    replace the published cell's (``resolve_cell``).  With
    ``measured_dir``, the measured step is kept there and a cell measured
    there before on the same device is not measured again (``_measured``).
    A sharding variant raises ValueError (ROADMAP.md A13); any other failure
    is recorded as an ``error``."""
    refused = refusal(variant)
    if refused is not None:
        raise ValueError(refused)
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    out_path = _out_path(out_dir, arch, shape_name, variant)
    label = f"{arch} x {shape_name}{f':{variant}' if variant else ''} ({mesh_name})"
    if os.path.exists(out_path):
        with open(out_path) as f:
            prev = json.load(f)
        if prev.get("status") == "ok":
            print(f"[skip] {label} done", flush=True)
            return prev
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "variant": variant,
           "status": "error", "ts": time.time()}
    try:
        cell = resolve_cell(arch, shape_name, variant, config, seq_len, n_chains, K)
        rec.update(analytic_record(cell, mesh_name))
        if cell.accum:
            rec["note"] = (f"accum {cell.accum} changes the global cell's analytic term "
                           "only; the measured step is the batch-1 step at accum 1")
        kept = measured_dir and _out_path(measured_dir, arch, shape_name, variant)
        rec["measured"] = m = _measured(cell, dev, mesh_name, kept)
        if "memory" in m:
            rec["memory"] = m["memory"]
        rec["status"] = "ok"
        print(f"[ok] {label} dominant={rec['roofline']['dominant']} "
              f"measured={m['status']} (on the {m['measured_in']} mesh's run)"
              + (f" ms={m['ms']:.3f} bound_ms={m['bound_ms']:.3f} "
                 f"fraction={m['fraction']:.3f}" if m["status"] == "ok" else
                 f" reckoned={m['reckoned_gb']:.1f}GB"), flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=20)
        if "measured" not in rec and "params_total" in rec:
            rec["measured"] = {"status": "error", "error": rec["error"]}
        print(f"[FAIL] {label}: {rec['error']}", flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--cells", default="all",
                    help='"all", "paper", or comma list of arch:shape[:variant]')
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        todo = parse_cells(args.cells)
    except ValueError as e:
        ap.error(str(e))
    out_dir = os.path.join(args.out, args.mesh)
    os.makedirs(out_dir, exist_ok=True)
    if args.cells == "all":
        for arch, shape, skipped in all_cells():
            path = _out_path(out_dir, arch, shape.name, "")
            if skipped and not os.path.exists(path):
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape.name, "mesh": args.mesh,
                               "status": "skipped",
                               "reason": "long_500k requires sub-quadratic attention "
                                         "(DESIGN.md §Arch-applicability)"}, f, indent=1)
    n_ok = 0
    for arch, shape, variant in todo:
        rec = run_cell(arch, shape, args.mesh, out_dir, variant, device=args.device,
                       measured_dir=os.path.join(args.out, "measured"))
        n_ok += rec.get("status") == "ok"
    print(f"done: {n_ok}/{len(todo)} cells ok -> {out_dir}", flush=True)
    return 0 if n_ok == len(todo) else 1


if __name__ == "__main__":
    raise SystemExit(main())
