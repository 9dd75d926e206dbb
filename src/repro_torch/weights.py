"""Denoiser and LM weights in the JAX package's tree layout, as torch
tensors.

The denoiser tree (leaves float32):

    in_proj (d_data, d)          t_mlp1 (time_dim, d)      t_mlp2 (d, d)
    decoder.g0.attn_norm.scale (n, d)
    decoder.g0.attn.{wq, wk, wv} (n, d, heads, hd)    .wo (n, heads, hd, d)
    decoder.g0.ffn_norm.scale (n, d)
    decoder.g0.ffn.{w_gate, w_up} (n, d, d_ff)        .w_down (n, d_ff, d)
    final_norm.scale (d,)        out_proj (d, d_data)     [cond_proj (d_cond, d)]

with n the layer count (the stacked ``layers`` axis).  The LM tree
(``lm_param_shapes``; hymba blocks) is

    decoder.g0.mix_norm.scale (n, d)    decoder.g0.attn as above
    decoder.g0.mamba.{in_proj (n, d, 2 din), conv_w (n, ck, din), conv_b,
        x_proj (n, din, dt_rank + 2 N), dt_proj (n, dt_rank, din), dt_bias,
        A_log (n, din, N), D, out_proj (n, din, d)}
    decoder.g0.ffn_norm, decoder.g0.ffn as above (``w_up`` and ``w_down``
        only for the GELU FFN)
    embed.table (vocab, d)    head.w (d, vocab)    final_norm.scale (d,)

and for the other archs the ``attn`` block's leaves (``attn_norm``,
``attn`` with ``bq``, ``bk``, ``bv`` (heads or kv, hd) where the config
has QKV biases, the FFN), the ``xattn`` block's (the same, plus
``attn.gate`` (n,)), the ``mlstm`` and ``slstm`` blocks' (``norm`` and a
``cell``, see ``_xlstm_cell_shapes``), one ``g<i>`` a group member; no
``embed`` for frame inputs, no ``head`` where the embeddings are tied.  An
attn block with a MoE FFN has ``ffn_norm`` and ``moe.{router (n, d, E),
w_gate, w_up (n, E, d, ff), w_down (n, E, ff, d)}`` in place of ``ffn``.

``from_jax_params`` and ``from_jax_lm_params`` convert the JAX package's
unboxed params (as numpy arrays) and need no JAX, and ``from_jax_opt_state``
its AdamW state.  ``denoiser_init_params`` draws a denoiser with the JAX
init's law, the one to train from; ``init_denoiser_params`` (from a numpy
seed, with nonzero ``out_proj`` and norm scales, for testing) and
``init_lm_params`` (from a torch generator on the device) make random trees.
``lm_init_params`` draws an LM with the JAX init's law, the one to train
from.  ``from_jax_chain_state`` converts a slot batch of the JAX package's chain
states, so both packages can start from the same states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.asd import ASDChainState
from repro_torch.device import resolve_device
from repro_torch.models.diffusion import DenoiserConfig
from repro_torch.models.lm import casts_to_compute


def _block_shapes(cfg: ModelConfig, desc) -> dict:
    """Leaf shapes of one group member, stacked over the n repeats."""
    d, h, kv, hd, n = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.resolved_head_dim, cfg.n_repeats)
    if desc.moe and desc.kind != "attn":
        raise NotImplementedError(f"block {desc}: the port has MoE FFNs in attn blocks only")
    if desc.kind in ("mlstm", "slstm"):
        return {"norm": {"scale": (n, d)}, "cell": _xlstm_cell_shapes(cfg, desc.kind)}
    if desc.kind not in ("attn", "xattn", "hymba"):
        raise NotImplementedError(f"block {desc} is not ported")
    attn = {"wq": (n, d, h, hd), "wk": (n, d, kv, hd), "wv": (n, d, kv, hd),
            "wo": (n, h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(n, h, hd), bk=(n, kv, hd), bv=(n, kv, hd))
    if desc.kind == "xattn":
        attn["gate"] = (n,)  # one scalar a layer
    if desc.kind in ("attn", "xattn"):
        block = {"attn_norm": {"scale": (n, d)}, "attn": attn}
    else:
        din, N, ck, dt_rank = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, max(1, d // 16)
        block = {"mix_norm": {"scale": (n, d)}, "attn": attn, "mamba": {
            "in_proj": (n, d, 2 * din), "conv_w": (n, ck, din), "conv_b": (n, din),
            "x_proj": (n, din, dt_rank + 2 * N), "dt_proj": (n, dt_rank, din),
            "dt_bias": (n, din), "A_log": (n, din, N), "D": (n, din),
            "out_proj": (n, din, d)}}
    if cfg.d_ff and desc.moe:
        # the JAX package's moe_init order
        E, ff = cfg.n_experts, cfg.d_ff
        block["ffn_norm"] = {"scale": (n, d)}
        block["moe"] = {"router": (n, d, E), "w_gate": (n, E, d, ff),
                        "w_up": (n, E, d, ff), "w_down": (n, E, ff, d)}
    elif cfg.d_ff:
        if cfg.ffn_kind not in ("swiglu", "gelu"):
            raise NotImplementedError(f"ffn {cfg.ffn_kind!r} is not ported")
        # the key order is the order random inits draw the leaves in
        gate = {"w_gate": (n, d, cfg.d_ff)} if cfg.ffn_kind == "swiglu" else {}
        block["ffn_norm"] = {"scale": (n, d)}
        block["ffn"] = {**gate, "w_up": (n, d, cfg.d_ff), "w_down": (n, cfg.d_ff, d)}
    return block


def _xlstm_cell_shapes(cfg: ModelConfig, kind: str) -> dict:
    """The mLSTM cell (up-projection to 2 x din, din = 2 d, conv, heads of
    din / H) or the sLSTM cell (heads of d / H, a GELU-gated FFN of
    int(4 d / 3)), stacked over the n repeats; no block FFN."""
    d, h, n, ck = cfg.d_model, cfg.n_heads, cfg.n_repeats, cfg.ssm_conv
    if kind == "mlstm":
        din = 2 * d
        dh = din // h
        return {"up_proj": (n, d, 2 * din), "conv_w": (n, ck, din), "conv_b": (n, din),
                "wq": (n, din, h, dh), "wk": (n, din, h, dh), "wv": (n, din, h, dh),
                "w_i": (n, din, h), "w_f": (n, din, h), "b_i": (n, h), "b_f": (n, h),
                "out_norm": {"scale": (n, din)}, "down_proj": (n, din, d)}
    dh, dff = d // h, max(1, int(d * 4 / 3))
    return {"w_gates": (n, d, 4, h, dh), "r_gates": (n, 4, h, dh, dh),
            "b_gates": (n, 4, h, dh), "out_norm": {"scale": (n, d)},
            "up_proj": (n, d, dff), "gate_proj": (n, d, dff), "down_proj": (n, dff, d)}


def _decoder_shapes(cfg: ModelConfig) -> dict:
    return {f"g{gi}": _block_shapes(cfg, desc) for gi, desc in enumerate(cfg.group)}


def param_shapes(dc: DenoiserConfig) -> dict:
    """The tree of leaf shapes for ``dc`` (dense attn blocks only)."""
    cfg = dc.backbone
    d = cfg.d_model
    if any(desc.kind != "attn" for desc in cfg.group):
        raise NotImplementedError(f"{cfg.name}: the denoiser takes attn blocks only")
    shapes = {
        "in_proj": (dc.d_data, d),
        "t_mlp1": (dc.time_dim, d),
        "t_mlp2": (d, d),
        "decoder": _decoder_shapes(cfg),
        "final_norm": {"scale": (d,)},
        "out_proj": (d, dc.d_data),
    }
    if dc.d_cond:
        shapes["cond_proj"] = (dc.d_cond, d)
    return shapes


def lm_param_shapes(cfg: ModelConfig) -> dict:
    """The tree of leaf shapes of ``repro_torch.models.lm`` for ``cfg``, as
    the JAX package's ``lm_init`` makes it: ``embed`` for token inputs (not
    for frames), ``head`` unless the embeddings are tied to token inputs."""
    shapes = {"decoder": _decoder_shapes(cfg), "final_norm": {"scale": (cfg.d_model,)}}
    if cfg.embed_inputs:
        shapes["embed"] = {"table": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        shapes["head"] = {"w": (cfg.d_model, cfg.vocab_size)}
    return shapes


def _convert(tree, shapes, path, dev):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"params at {path or '<root>'}: expected keys "
                             f"{sorted(shapes)}, got {got}")
        return {k: _convert(tree[k], shapes[k], f"{path}.{k}".lstrip("."), dev)
                for k in shapes}
    arr = np.asarray(tree)
    if arr.shape != tuple(shapes):
        raise ValueError(f"params at {path}: expected shape {shapes}, got {arr.shape}")
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C")).to(dev)


def from_jax_params(tree, dc: DenoiserConfig, device=None):
    """The JAX package's unboxed denoiser params (nested dicts of numpy
    arrays) as the port's params: float32 tensors on ``device`` (None means
    "cuda").  Keys and shapes are checked against ``dc``."""
    return _convert(tree, param_shapes(dc), "", resolve_device(device))


def from_jax_lm_params(tree, cfg: ModelConfig, device=None):
    """The JAX package's unboxed ``lm_init`` params (nested dicts of numpy
    arrays) as the port's LM params: float32 tensors on ``device`` (None
    means "cuda").  Keys and shapes are checked against ``cfg``."""
    return _convert(tree, lm_param_shapes(cfg), "", resolve_device(device))


def _random_tree(shapes, leaf):
    """The tree of ``shapes`` with each leaf made by ``leaf(path, shape,
    stacked)`` (``path``: the leaf's keys from the root), in the tree's key
    order."""
    def make(tree, path, stacked):
        if isinstance(tree, dict):
            return {k: make(v, path + (k,), stacked or k == "decoder")
                    for k, v in tree.items()}
        return leaf(path, tree, stacked)

    return make(shapes, (), False)


def _fan_in(shape, stacked) -> int:
    """The fan-in of a lecun-normal leaf: all but the last axis (and not the
    stacked leading layers axis), as in the JAX package: an expert stack's
    (E, d, ff) counts E x d, its (E, ff, d) E x ff."""
    return math.prod(shape[int(stacked):-1])


def denoiser_init_params(dc: DenoiserConfig, generator: torch.Generator, device=None):
    """Denoiser params drawn with the law of the JAX package's
    ``denoiser_init``: product weights lecun-normal (normal / sqrt(fan-in),
    the fan-in over all but the last axis and not over the stacked layers
    axis), ``out_proj`` zero, the RMSNorm scales zero (the norm is
    (1 + scale)) and the qkv biases zero.  Drawn on ``device`` (None means
    "cuda") from ``generator``, which must live there; the leaves come in
    the tree's key order."""
    dev = resolve_device(device)

    def leaf(path, shape, stacked):
        if path[-1] in ("out_proj", "scale", "bq", "bk", "bv"):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        a = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return a.mul_(1.0 / math.sqrt(_fan_in(shape, stacked)))

    return _random_tree(param_shapes(dc), leaf)


def init_denoiser_params(dc: DenoiserConfig, seed: int, out_scale: float = 1e-2,
                         device=None):
    """Random params from ``numpy.random.default_rng(seed)``.

    Product weights are lecun-normal over all but their last axis, as in
    the JAX package.  Unlike its init, ``out_proj`` and the norm scales are
    nonzero (normal * ``out_scale`` / sqrt(d) and normal * 0.1):
    a zero ``out_proj`` makes the denoiser output 0 everywhere, so every
    speculation would be accepted and the reject path never run.  Train
    from ``denoiser_init_params``, not from these.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d = dc.backbone.d_model

    def leaf(path, shape, stacked):
        name = path[-1]
        a = rng.standard_normal(shape, dtype=np.float32)
        if name == "scale":
            a *= 0.1
        elif name == "out_proj":
            a *= out_scale / math.sqrt(d)
        elif name in ("bq", "bk", "bv"):
            a *= 0.0
        else:
            a *= 1.0 / math.sqrt(_fan_in(shape, stacked))
        return torch.from_numpy(a).to(dev)

    return _random_tree(param_shapes(dc), leaf)


def from_jax_opt_state(state, dc: DenoiserConfig, device=None):
    """The JAX package's ``adamw`` state of denoiser params, ``{"mu", "nu",
    "step"}`` with numpy leaves, as the port's: ``mu`` and ``nu`` float32
    trees on ``device`` (None means "cuda"), ``step`` an int32 scalar."""
    dev = resolve_device(device)
    return {"mu": from_jax_params(state["mu"], dc, dev),
            "nu": from_jax_params(state["nu"], dc, dev),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=dev)}


def lm_init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """LM params drawn with the law of the JAX package's ``lm_init``, the
    ones to train from: products lecun-normal (as ``denoiser_init_params``;
    an expert stack's fan-in counts its expert axis), ``embed.table``,
    ``head.w`` and the MoE ``router`` normal * 0.02, ``conv_w`` and ``dt_proj``
    normal * 0.1, mLSTM's ``w_i`` and ``w_f`` normal * 0.02, sLSTM's
    ``r_gates`` normal * 0.05; the norm scales, biases and xattn gates zero,
    but mLSTM's forget bias ``b_f`` 3 (a gate that remembers); ``A_log`` =
    log(1..N) and ``D`` = 1.  Drawn on ``device`` (None means "cuda") from
    ``generator``, which must live there, in the tree's key order."""
    dev = resolve_device(device)

    def leaf(path, shape, stacked):
        name = path[-1]
        fixed = _fixed_leaf(name, shape, dev)
        if fixed is not None:
            return fixed
        if name in ("scale", "conv_b", "dt_bias", "bq", "bk", "bv", "gate", "b_i",
                    "b_gates"):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        if name == "b_f":
            return torch.full(shape, 3.0, dtype=torch.float32, device=dev)
        a = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        std = _NORMAL_STD.get(name)
        return a.mul_(std if std is not None else 1.0 / math.sqrt(_fan_in(shape, stacked)))

    return _random_tree(lm_param_shapes(cfg), leaf)


# leaves the JAX LM init draws normal * std, not lecun-normal
_NORMAL_STD = {"table": 0.02, "w": 0.02, "w_i": 0.02, "w_f": 0.02, "conv_w": 0.1,
               "dt_proj": 0.1, "r_gates": 0.05, "router": 0.02}


def _fixed_leaf(name, shape, dev):
    """The mamba leaves both LM inits set: ``A_log`` = log(1..N) in every
    row, ``D`` = 1; None for any other leaf."""
    if name == "A_log":
        row = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=dev))
        return row.expand(shape).contiguous()
    if name == "D":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    return None


# the longest run of float32 numbers ``init_lm_params`` draws at once into a
# leaf of another dtype (256 MiB)
_DRAW_CHUNK = 1 << 26


def init_lm_params(cfg: ModelConfig, seed: int, device=None, dtype=None):
    """Random LM params, the tree of ``lm_param_shapes``, drawn on ``device``
    (None means "cuda") from ``torch.Generator(device).manual_seed(seed)``:
    a full-width model is 1.4 G floats, too many to draw on the host.  The
    same seed gives other numbers on the CPU than on the card; to run both
    on the same params, make them once and copy them.

    As the JAX init (``lm_init_params``) where it sets the dynamics:
    products lecun-normal, the normal-drawn leaves at its scales, ``A_log``
    and ``D`` as there, so the decays are those of a real mamba, and
    mLSTM's forget bias ``b_f`` near 3 (3 + normal * 0.1).  Unlike it, the
    norm scales, the biases ``conv_b``, ``dt_bias``, ``b_i``, ``b_gates``
    and the QKV biases ``bq``, ``bk``, ``bv`` (qwen2.5) are nonzero (normal
    * 0.1), and so is each xattn layer's ``gate`` (normal; the JAX init's 0
    would make the layer a no-op): zero leaves would hide a missing term.

    ``dtype`` (e.g. the compute dtype), where given: the leaves that
    ``lm_compute_params`` casts are drawn straight into it, in runs of at
    most ``_DRAW_CHUNK`` float32 numbers (256 MiB) over the leaf's flat
    order, so neither the float32 tree nor a float32 copy of one big leaf
    exists (qwen3-moe's tree would take 122 GB; one layer of dbrx's
    ``w_gate`` stack 4.23 GB, its embedding table 2.47 GB).  Same law, each
    leaf at the std of its whole shape; other numbers than the float32 draw
    (and than a draw a layer at a time, so qwen3-moe's bf16 numbers are not
    those of earlier versions).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def law(name, shape, stacked):
        """(std, mean) of the leaf's normal draws."""
        if name in ("scale", "conv_b", "dt_bias", "bq", "bk", "bv", "b_i", "b_gates"):
            return 0.1, 0.0
        if name == "b_f":
            return 0.1, 3.0
        if name == "gate":
            return 1.0, 0.0
        std = _NORMAL_STD.get(name)
        return (std if std is not None else 1.0 / math.sqrt(_fan_in(shape, stacked))), 0.0

    def leaf(path, shape, stacked):
        name = path[-1]
        fixed = _fixed_leaf(name, shape, dev)
        if fixed is not None:
            return fixed
        std, mean = law(name, shape, stacked)

        def normal(size):
            a = torch.randn(size, generator=gen, dtype=torch.float32, device=dev).mul_(std)
            return a.add_(mean) if mean else a

        if dtype is None or not casts_to_compute(path):
            return normal(shape)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for run in out.view(-1).split(_DRAW_CHUNK):
            run.copy_(normal(run.numel()))
        return out

    return _random_tree(lm_param_shapes(cfg), leaf)


# the JAX ASDChainState leaves, with the dtypes the port holds them in (the
# keys' uint32 words in int64)
_STATE_DTYPES = {
    "y": torch.float32, "a": torch.int64, "v_cache": torch.float32,
    "v_valid": torch.bool, "rounds": torch.int64, "head_calls": torch.int64,
    "model_evals": torch.int64, "accepts": torch.int64, "proposals": torch.int64,
    "theta_live": torch.int64, "ctrl": torch.float32, "k_u": torch.int64,
    "k_xi": torch.int64, "u_buf": torch.float32, "xi_buf": torch.float32,
    "b_live": torch.int64, "bctrl": torch.float32, "draft_points": torch.int64,
}


def from_jax_chain_state(state, K: int, theta: int, device=None) -> ASDChainState:
    """A slot batch of the JAX package's ``ASDChainState`` (leaves as numpy
    arrays with a leading slot axis B) as the port's ``ASDChainState`` on
    ``device`` (None means "cuda"), branch fields included.  A counter-mode
    state holds no noise buffers (``u_buf`` and ``xi_buf`` None).

    Shapes are checked against K and theta (the clamped cap that shaped the
    buffers): y (B, K+theta+1 or theta+1, *event), u_buf (B, K+theta+1),
    xi_buf (B, K+theta+1, *event), ctrl and bctrl (B, n), k_u and k_xi
    (B, 2), the rest (B,)."""
    dev = resolve_device(device)
    get = state.get if isinstance(state, dict) else (lambda k: getattr(state, k))
    counter = get("u_buf") is None and get("xi_buf") is None
    arrs = {k: np.asarray(get(k)) for k in _STATE_DTYPES
            if not (counter and k in ("u_buf", "xi_buf"))}
    for k in ("k_u", "k_xi"):
        arrs[k] = arrs[k].astype(np.int64)
    B = arrs["a"].shape[0] if arrs["a"].ndim == 1 else -1
    ev = arrs["v_cache"].shape[1:]
    n = K + theta + 1
    y_len = arrs["y"].shape[1] if arrs["y"].ndim >= 2 else -1
    want = {"y": (B, y_len) + ev, "v_cache": (B,) + ev, "u_buf": (B, n),
            "xi_buf": (B, n) + ev, "ctrl": (B,) + arrs["ctrl"].shape[1:2],
            "bctrl": (B,) + arrs["bctrl"].shape[1:2], "k_u": (B, 2), "k_xi": (B, 2)}
    for name in arrs:
        shape = want.get(name, (B,))
        if B < 0 or arrs[name].shape != shape or (
                name in ("ctrl", "bctrl") and arrs[name].ndim != 2):
            raise ValueError(f"chain state {name}: expected {shape} (B slots, "
                             f"K={K}, theta={theta}), got {arrs[name].shape}")
    if y_len not in (n, theta + 1):
        raise ValueError(f"chain state y: length {y_len} is neither K+theta+1 = {n} "
                         f"nor theta+1 = {theta + 1}")
    leaves = dict(u_buf=None, xi_buf=None)
    leaves.update({k: torch.from_numpy(np.array(v, order="C")).to(dev, _STATE_DTYPES[k])
                   for k, v in arrs.items()})
    return ASDChainState(**leaves)
