"""Language model: embedding -> decoder -> final norm -> head, and the
serving paths (cache init, prefill, greedy-decode steps), as the JAX
package's ``repro/models/lm.py``.

Params are a plain dict of tensors in the JAX package's tree layout (see
``repro_torch.weights.lm_param_shapes``); every function runs on the device
of its params.  The caches are updated in place and returned.  Ported: token
inputs with rotary or no positions, an untied head, final softcap.  The
loss, frame and vision inputs, sinusoidal positions, embedding scales and
tied embeddings are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import (decoder_cache_init, decoder_fwd, decoder_prefill,
                                        decoder_step)
from repro_torch.nn.layers import cast_leaves, embedding_apply, rmsnorm_apply, softcap

# leaves used only in the compute dtype (everything else -- norms, the
# conv, x_proj, dt, A and D of the mamba mixer -- enters float32 math in
# the prefill or the decode step)
_COMPUTE_LEAVES = frozenset({"wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_gate", "w_up",
                             "w_down", "in_proj", "out_proj", "table", "w"})


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def lm_compute_params(params, cfg: ModelConfig):
    """The params with every leaf that is only used in the compute dtype
    cast to it once.  The ``lm_*`` functions cast each use to that dtype
    anyway, so results are the same; casting once saves a pass over the
    weights per call (a decode step reads them all)."""
    return cast_leaves(params, _COMPUTE_LEAVES, compute_dtype(cfg))


def _embed(params, tokens, cfg: ModelConfig):
    if not cfg.embed_inputs or cfg.embed_scale != 1.0 or cfg.pos_embed == "sinusoidal":
        raise NotImplementedError(f"{cfg.name}: frame inputs, embedding scales and "
                                  "sinusoidal positions are not ported yet")
    return embedding_apply(params["embed"], tokens, compute_dtype(cfg))


def _head(params, x, cfg: ModelConfig):
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: tied embeddings are not ported yet")
    return softcap(x @ params["head"]["w"].to(x.dtype), cfg.final_softcap)


def lm_fwd(params, tokens, cfg: ModelConfig):
    """tokens: (B, L) int ids -> logits (B, L, vocab) in the compute dtype."""
    x = _embed(params, tokens, cfg)
    x = decoder_fwd(params["decoder"], x, cfg, dict(causal=True))
    return _head(params, rmsnorm_apply(params["final_norm"], x), cfg)


def lm_cache_init(params, cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16):
    """Zero caches for ``batch`` sequences of up to ``max_len`` positions:
    KV in ``dtype``, recurrent states in float32."""
    return decoder_cache_init(params["decoder"], cfg, batch, max_len, dtype)


def lm_prefill(params, tokens, caches, cfg: ModelConfig):
    """Fills the caches with positions 0..L-1 of tokens (B, L).  Returns
    (last-position logits (B, 1, vocab), caches)."""
    x = _embed(params, tokens, cfg)
    x, caches = decoder_prefill(params["decoder"], x, caches, cfg, dict(causal=True))
    return _head(params, rmsnorm_apply(params["final_norm"], x[:, -1:]), cfg), caches


def lm_decode_step(params, token, caches, pos, cfg: ModelConfig):
    """token: (B,) int ids at position ``pos``, a 0-d integer tensor on the
    params' device as the JAX package's ``pos: () int32`` (a Python int is
    made one).  Nothing reads ``pos`` or the token on the host, so the step
    can be captured as a CUDA graph and replayed with both advanced in
    place.  Returns (logits (B, 1, vocab), caches)."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
    x = _embed(params, token[:, None], cfg)
    x, caches = decoder_step(params["decoder"], x, caches, pos, cfg)
    return _head(params, rmsnorm_apply(params["final_norm"], x), cfg), caches
