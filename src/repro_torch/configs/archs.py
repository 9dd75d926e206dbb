"""The assigned LM architectures the port runs (copied from the JAX
package's ``configs/archs.py``).  Only ``hymba-1.5b`` so far: the other
archs come with their blocks."""

from __future__ import annotations

from repro_torch.configs.base import BlockDesc, ModelConfig


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


ARCHS = {"hymba-1.5b": hymba_1_5b}
