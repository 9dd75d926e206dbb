"""The paper's own denoiser configs, the LM archs and their input-shape
cells (copied from the JAX package's registry)."""

from __future__ import annotations

from repro_torch.configs.archs import ARCHS, SUBQUADRATIC
from repro_torch.configs.base import ALL_SHAPES, BlockDesc, InputShape, ModelConfig
from repro_torch.models.diffusion import DenoiserConfig


def paper_ldm_dit() -> DenoiserConfig:
    """Latent-diffusion stand-in for StableDiffusion-v2 (paper §6.1, Fig 2):
    DiT-XL-class transformer over 32x32 latent patch tokens."""
    backbone = ModelConfig(
        name="paper-ldm-dit", family="dense", n_layers=28, d_model=1152,
        n_heads=16, n_kv_heads=16, d_ff=4608, vocab_size=1,
        pos_embed="none", embed_inputs=False,
    )
    return DenoiserConfig(backbone=backbone, seq_len=1024, d_data=16)


def paper_pixel_dit() -> DenoiserConfig:
    """Pixel-space stand-in for the LSUN-Church DDPM (paper §6.1, Fig 4):
    256x256x3 images as 1024 8x8-patch tokens."""
    backbone = ModelConfig(
        name="paper-pixel-dit", family="dense", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=1,
        pos_embed="none", embed_inputs=False,
    )
    return DenoiserConfig(backbone=backbone, seq_len=1024, d_data=192)


def paper_diffusion_policy(action_dim: int = 14) -> DenoiserConfig:
    """Robomimic-style diffusion policy (paper §6.2): denoises an action
    sequence of k=16 steps x action_dim (7 single-arm / 14 bi-manual)."""
    backbone = ModelConfig(
        name="paper-diffusion-policy", family="dense", n_layers=8, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=1,
        pos_embed="none", embed_inputs=False,
    )
    return DenoiserConfig(backbone=backbone, seq_len=16, d_data=action_dim)


def paper_diffusion_policy_smoke(action_dim: int = 4) -> DenoiserConfig:
    """Test-sized diffusion policy: same topology as
    ``paper-diffusion-policy`` at smoke dims, computed in float32."""
    backbone = ModelConfig(
        name="paper-diffusion-policy-smoke", family="dense", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=1,
        pos_embed="none", embed_inputs=False, compute_dtype="float32",
        remat=False,
    )
    return DenoiserConfig(backbone=backbone, seq_len=8, d_data=action_dim)


def qwen3_moe_a3b_smoke(action_dim: int = 4) -> DenoiserConfig:
    """CI/demo-sized qwen3-moe-30b-a3b-family denoiser: attention blocks
    with a token-choice top-k MoE FFN, at smoke dims, computed in float32.
    capacity_factor >= E/k, so no token is dropped."""
    backbone = ModelConfig(
        name="qwen3-moe-a3b-smoke", family="moe", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=1,
        group=(BlockDesc("attn", moe=True),),
        n_experts=8, top_k=2, capacity_factor=8.0,
        pos_embed="none", embed_inputs=False, compute_dtype="float32",
        remat=False,
    )
    return DenoiserConfig(backbone=backbone, seq_len=8, d_data=action_dim)


PAPER_MODELS = {
    "paper-ldm-dit": paper_ldm_dit,
    "paper-pixel-dit": paper_pixel_dit,
    "paper-diffusion-policy": paper_diffusion_policy,
    "paper-diffusion-policy-smoke": paper_diffusion_policy_smoke,
    "qwen3-moe-a3b-smoke": qwen3_moe_a3b_smoke,
}


def get_denoiser_config(name: str) -> DenoiserConfig:
    """A paper denoiser config by its name (the JAX registry's: the dense
    ones and the MoE smoke model)."""
    if name in PAPER_MODELS:
        return PAPER_MODELS[name]()
    raise KeyError(f"unknown or not yet ported paper model {name!r}; "
                   f"known: {sorted(PAPER_MODELS)}")


def get_config(name: str) -> ModelConfig:
    """A ported LM arch by its name, e.g. ``"hymba-1.5b"``."""
    if name in ARCHS:
        return ARCHS[name]()
    raise KeyError(f"unknown or not yet ported arch {name!r}; known: {sorted(ARCHS)}")


def shapes_for(name: str) -> list[InputShape]:
    """The shape cells an arch runs: every one but long_500k, which only the
    sub-quadratic archs run."""
    return [s for s in ALL_SHAPES if s.name != "long_500k" or name in SUBQUADRATIC]


def all_cells():
    """Every (arch, shape, skipped) cell, the skipped ones included."""
    return [(name, shape, shape.name == "long_500k" and name not in SUBQUADRATIC)
            for name in ARCHS for shape in ALL_SHAPES]
