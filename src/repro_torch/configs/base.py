"""Model configuration dataclasses (the port's own copy of the JAX package's
``configs/base.py``: ``BlockDesc``, ``ModelConfig``, ``reduced``, and the
four input-shape cells ``InputShape`` with ``ALL_SHAPES``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BlockDesc:
    """One block inside the repeating layer group.

    kind: "attn" | "hymba" | "mamba" | "mlstm" | "slstm" | "xattn"
    window: sliding-attention window; 0 = full.  May be overridden
      per-repeat via ``window_per_repeat``.
    moe: this block's FFN is the MoE (vs dense SwiGLU).  d_ff == 0 => no FFN.
    """

    kind: str = "attn"
    window: int = 0
    window_per_repeat: Optional[tuple] = None
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    group: tuple = (BlockDesc(),)
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embed: str = "rope"  # rope | sinusoidal | none
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 1
    n_vision_tokens: int = 0
    d_vision: int = 0
    embed_inputs: bool = True
    ffn_kind: str = "swiglu"  # swiglu | gelu
    embed_scale: float = 1.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = True

    def __post_init__(self):
        gsize = len(self.group)
        if self.n_layers % gsize:
            raise ValueError(f"{self.name}: n_layers {self.n_layers} is not a "
                             f"multiple of the group size {gsize}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.group)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return max(1, self.ssm_expand) * self.n_heads * self.resolved_head_dim

    def param_count_estimate(self) -> int:
        """Closed-form parameter count: attention and FFN (or every expert)
        a layer, and the embedding and head; norms, biases, routers and
        mixers are left out (the JAX package's estimate)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = (d * self.n_heads * hd  # q
                + 2 * d * self.n_kv_heads * hd  # k, v
                + self.n_heads * hd * d)  # o
        ffn = (self.n_experts or 1) * 3 * d * self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + emb


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the assigned input-shape cells."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduced config for CPU tests: at most two repeats of
    the group, d_model 64, 4 heads of 16, float32 compute, windows capped
    at 32 (the JAX package's ``reduced``)."""
    gsize = len(cfg.group)
    small = dict(
        n_layers=gsize * min(2, cfg.n_repeats),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        capacity_factor=max(cfg.capacity_factor, 4.0),
        n_vision_tokens=min(cfg.n_vision_tokens, 16),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        compute_dtype="float32",
        name=cfg.name + "-smoke",
        scan_layers=cfg.scan_layers,
        remat=False,
    )
    reps = small["n_layers"] // gsize
    new_group = []
    for b in cfg.group:
        wpr = b.window_per_repeat
        if wpr is not None:
            wpr = tuple(min(w, 32) if w else 0 for w in wpr[:reps])
        new_group.append(dataclasses.replace(
            b, window=min(b.window, 32) if b.window else 0, window_per_repeat=wpr))
    small["group"] = tuple(new_group)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
