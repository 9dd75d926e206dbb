"""--arch qwen3-moe-30b-a3b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["qwen3-moe-30b-a3b"]()
