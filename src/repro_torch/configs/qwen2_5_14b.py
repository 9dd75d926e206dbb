"""--arch qwen2.5-14b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["qwen2.5-14b"]()
