"""Language model: embedding -> decoder -> final norm -> head, the loss,
and the serving paths (cache init, prefill, greedy-decode steps), as the
JAX package's ``repro/models/lm.py``.

Params are a plain dict of tensors in the JAX package's tree layout (see
``repro_torch.weights.lm_param_shapes``); every function runs on the device
of its params.  The caches are updated in place and returned.  Ported: token
inputs, and the frame stub ((B, L, d_model) embeddings, musicgen's); rotary,
sinusoidal or no positions; embedding scales (gemma2's); an untied or tied
head, final softcap; the vision stub's patch embeddings (B, Nv, d_model)
that xattn layers attend to (llama-3.2-vision's), given in the compute
dtype; MoE FFNs (qwen3-moe's and dbrx's, every expert on the device) in
the forward, the prefill, the decode step and the loss.  ``lm_loss`` is
the next-token loss the trainer (``repro_torch.launch.train``) takes
gradients of, plus ``router_aux_weight`` times the MoE layers' summed
load-balancing loss; it runs the naive attention core, as the JAX
package's does (kernel B2 has no backward).  ``lm_fwd`` returns the
logits alone (the JAX package's returns them with the aux sum).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import (decoder_cache_init, decoder_fwd, decoder_prefill,
                                        decoder_step)
from repro_torch.nn.layers import (embedding_apply, rmsnorm_apply, sinusoidal_embed,
                                   softcap, unembed_apply)

# leaves used only in the compute dtype (everything else -- norms, the
# conv, x_proj, dt, A and D of the mamba mixer -- enters float32 math in
# the prefill or the decode step)
_COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
                             "w_down", "in_proj", "out_proj", "table", "w", "router"})
# the same inside an xlstm block's cell: only its projections.  mLSTM's
# wq, wk, wv, conv_w, w_i, w_f and sLSTM's w_gates, r_gates enter float32
# math in the decode step (and the gates in the forward too).
_CELL_COMPUTE_LEAVES = frozenset({"up_proj", "down_proj", "gate_proj"})


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def casts_to_compute(path: tuple) -> bool:
    """Whether the leaf at ``path`` (its dict keys from the params' root)
    is used only in the compute dtype."""
    names = _CELL_COMPUTE_LEAVES if "cell" in path else _COMPUTE_LEAVES
    return path[-1] in names


def lm_compute_params(params, cfg: ModelConfig, path: tuple = ()):
    """The params with every leaf that is only used in the compute dtype
    cast to it once.  The ``lm_*`` functions cast each use to that dtype
    anyway, so results are the same; casting once saves a pass over the
    weights per call (a decode step reads them all).  ``path``: where
    ``params`` sits in the whole tree, for a subtree cast alone."""
    if isinstance(params, dict):
        return {k: lm_compute_params(v, cfg, path + (k,)) for k, v in params.items()}
    return params.to(compute_dtype(cfg)) if casts_to_compute(path) else params


def _embed(params, inputs, cfg: ModelConfig, pos=None):
    """Token ids (B, L), or frames (B, L, d_model) where ``cfg.embed_inputs``
    is False, -> (B, L, d_model) in the compute dtype: scaled by
    ``embed_scale`` rounded to the compute dtype first (as the JAX package's
    ``jnp.asarray(scale, cdt)``: gemma2's sqrt(3584) is 59.75 in bf16), plus
    sinusoidal positions 0..L-1, or ``pos`` (a 0-d device tensor) for one
    decode step."""
    cdt = compute_dtype(cfg)
    if cfg.embed_inputs:
        x = embedding_apply(params["embed"], inputs, cdt)
    else:
        x = inputs.to(cdt)
    if cfg.embed_scale != 1.0:
        x = x * float(torch.tensor(cfg.embed_scale, dtype=cdt))
    if cfg.pos_embed == "sinusoidal":
        positions = (torch.arange(x.shape[1], device=x.device) if pos is None
                     else pos.view(1))
        x = x + sinusoidal_embed(positions, cfg.d_model).to(cdt)
    return x


def _head(params, x, cfg: ModelConfig):
    """Logits from ``head.w``, or from ``embed.table`` where the embeddings
    are tied (a tied arch with frame inputs has a head), then the final
    softcap."""
    if cfg.tie_embeddings and cfg.embed_inputs:
        logits = unembed_apply(params["embed"], x)
    else:
        logits = x @ params["head"]["w"].to(x.dtype)
    return softcap(logits, cfg.final_softcap)


def _lm_fwd_aux(params, tokens, cfg: ModelConfig, vision=None, impl: str = "flash",
                tp_axis=None, batch_axis=None):
    """(logits, the MoE layers' summed aux loss, float32 0-d): the JAX
    package's ``lm_fwd``.  ``tp_axis``: the blocks' tensor parallelism
    (``models/blocks.py``), where the params hold a rank's head and
    hidden blocks; ``batch_axis``: the data-parallel ranks whose batch
    blocks the MoE's aux loss spans."""
    x = _embed(params, tokens, cfg)
    x, aux = decoder_fwd(params["decoder"], x, cfg,
                         dict(causal=True, vision=vision, impl=impl, tp_axis=tp_axis,
                              batch_axis=batch_axis))
    return _head(params, rmsnorm_apply(params["final_norm"], x), cfg), aux


def lm_fwd(params, tokens, cfg: ModelConfig, vision=None, impl: str = "flash"):
    """tokens: (B, L) int ids, or (B, L, d_model) frames -> logits (B, L,
    vocab) in the compute dtype.  ``vision``: (B, Nv, d_model) patch
    embeddings for the xattn layers.  ``impl``: the attention core,
    "flash" (kernel B2 on the card) or "naive" (differentiable)."""
    return _lm_fwd_aux(params, tokens, cfg, vision=vision, impl=impl)[0]


def lm_loss(params, batch, cfg: ModelConfig, impl: str = "naive", tp_axis=None,
            batch_axis=None):
    """batch: dict(tokens, labels (B, L) int, mask (B, L) optional, vision
    optional) -> (loss, metrics): the mean next-token negative
    log-likelihood over the masked positions (logits in float32,
    logsumexp minus the label's logit; the denominator at least 1), plus
    ``router_aux_weight`` times the MoE layers' summed load-balancing loss.
    metrics: ``nll`` (the mean alone), ``moe_aux`` (that sum; 0 without
    MoE) and ``tokens``.  ``tp_axis``: a model group the attention and
    FFN blocks run tensor-parallel over; ``batch_axis``: the mesh
    trainer's data-parallel ranks, each with an equal block of the batch's
    rows, which the mean and the MoE's aux loss span (the mean of the
    ranks' losses is then the whole batch's, as are their gradients')."""
    logits, aux = _lm_fwd_aux(params, batch["tokens"], cfg, vision=batch.get("vision"),
                              impl=impl, tp_axis=tp_axis, batch_axis=batch_axis)
    logits = logits.float()
    labels = batch["labels"].long()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    if batch_axis is None or batch_axis.world == 1:
        denom = torch.clamp(mask.sum(), min=1.0)
    else:  # the whole batch's count, a rank's share of it
        denom = torch.clamp(batch_axis.psum(mask.sum()), min=1.0) / batch_axis.world
    loss = (nll * mask).sum() / denom
    total = loss + cfg.router_aux_weight * aux
    return total, {"nll": loss.detach(), "moe_aux": aux.detach(), "tokens": denom}


def lm_cache_init(params, cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16):
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions:
    KV in ``dtype``, recurrent states in float32."""
    return decoder_cache_init(params["decoder"], cfg, batch, max_len, dtype)


def lm_prefill(params, tokens, caches, cfg: ModelConfig, vision=None):
    """Fills the caches with positions 0..L-1 of tokens (B, L) (or frames
    (B, L, d_model)), and the xattn layers' caches with the keys and values
    of ``vision`` (B, Nv, d_model).  Returns (last-position logits (B, 1,
    vocab), caches)."""
    x = _embed(params, tokens, cfg)
    x, caches = decoder_prefill(params["decoder"], x, caches, cfg,
                                dict(causal=True, vision=vision))
    return _head(params, rmsnorm_apply(params["final_norm"], x[:, -1:]), cfg), caches


def lm_decode_step(params, token, caches, pos, cfg: ModelConfig):
    """token: (B,) int ids (or a (B, 1, d_model) frame) at position ``pos``,
    a 0-d integer tensor on the params' device as the JAX package's ``pos:
    () int32`` (a Python int is made one).  Nothing reads ``pos`` or the
    token on the host, so the step can be captured as a CUDA graph and
    replayed with both advanced in place.  Returns (logits (B, 1, vocab),
    caches)."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
    x = _embed(params, token[:, None] if cfg.embed_inputs else token, cfg, pos)
    x, caches = decoder_step(params["decoder"], x, caches, pos, cfg)
    return _head(params, rmsnorm_apply(params["final_norm"], x), cfg), caches
