"""The 10 assigned LM architectures (copied from the JAX package's
``configs/archs.py``): xlstm-125m, hymba-1.5b, the dense archs (tinyllama,
yi, gemma2, qwen2.5), llama-3.2-vision, musicgen and the MoE archs
dbrx-132b and qwen3-moe-30b-a3b (every expert on one device).  Each also
has its own module (``configs/<id>.py``) exporting ``CONFIG``."""

from __future__ import annotations

from repro_torch.configs.base import BlockDesc, ModelConfig


def xlstm_125m() -> ModelConfig:
    # [ssm] sLSTM + mLSTM blocks [arXiv:2405.04517]; d_ff=0 (blocks carry
    # their own projections); alternating (mlstm, slstm) groups.
    return ModelConfig(
        name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
        group=(BlockDesc("mlstm"), BlockDesc("slstm")),
        pos_embed="none", ssm_conv=4, ssm_state=16,
    )


def dbrx_132b() -> ModelConfig:
    # [moe] 16 experts top-4, fine-grained [hf:databricks/dbrx-base]
    return ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab_size=100352,
        group=(BlockDesc("attn", moe=True),),
        n_experts=16, top_k=4, rope_theta=5e5,
    )


def qwen3_moe_30b() -> ModelConfig:
    # [moe] 128 experts top-8 fine-grained [hf:Qwen/Qwen3-30B-A3B]
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab_size=151936,
        group=(BlockDesc("attn", moe=True),),
        n_experts=128, top_k=8, rope_theta=1e6,
    )


def hymba_1_5b() -> ModelConfig:
    # [hybrid] parallel attn+mamba heads [arXiv:2411.13676]; sliding-window
    # attention with 3 full-attention layers (first / middle / last).
    reps = 32
    windows = tuple(0 if r in (0, reps // 2, reps - 1) else 1024 for r in range(reps))
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, d_ff=5504, vocab_size=32001,
        group=(BlockDesc("hymba", window_per_repeat=windows),),
        ssm_state=16, ssm_conv=4, ssm_expand=1,
    )


def tinyllama_1_1b() -> ModelConfig:
    # [dense] llama2-arch small [arXiv:2401.02385]
    return ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, d_ff=5632, vocab_size=32000,
    )


def yi_6b() -> ModelConfig:
    # [dense] llama-arch GQA [arXiv:2403.04652]
    return ModelConfig(
        name="yi-6b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab_size=64000,
        rope_theta=5e6,
    )


def gemma2_9b() -> ModelConfig:
    # [dense] local+global alternating, logit softcap [arXiv:2408.00118]
    return ModelConfig(
        name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
        group=(BlockDesc("attn", window=4096), BlockDesc("attn", window=0)),
        attn_softcap=50.0, final_softcap=30.0,
        embed_scale=3584.0**0.5, tie_embeddings=True,
    )


def qwen2_5_14b() -> ModelConfig:
    # [dense] GQA, QKV bias [hf:Qwen/Qwen2.5]
    return ModelConfig(
        name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=13824, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6,
    )


def llama32_vision_11b() -> ModelConfig:
    # [vlm] cross-attn image layers every 5th slot [hf:meta-llama/...-Vision];
    # vision frontend is a STUB: input_specs() provides patch embeddings.
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
        group=(
            BlockDesc("attn"), BlockDesc("attn"), BlockDesc("attn"),
            BlockDesc("attn"), BlockDesc("xattn"),
        ),
        n_vision_tokens=6400, rope_theta=5e5,
    )


def musicgen_medium() -> ModelConfig:
    # [audio] decoder-only over EnCodec tokens [arXiv:2306.05284]; the
    # EnCodec frontend is a STUB: inputs are precomputed frame embeddings.
    return ModelConfig(
        name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
        n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
        pos_embed="sinusoidal", ffn_kind="gelu", embed_inputs=False,
    )


ARCHS = {
    "xlstm-125m": xlstm_125m,
    "dbrx-132b": dbrx_132b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
    "hymba-1.5b": hymba_1_5b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "yi-6b": yi_6b,
    "gemma2-9b": gemma2_9b,
    "qwen2.5-14b": qwen2_5_14b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "musicgen-medium": musicgen_medium,
}

# archs whose full-sequence mixer is sub-quadratic end to end; only these
# run the long_500k cell
SUBQUADRATIC = {"xlstm-125m", "hymba-1.5b"}
