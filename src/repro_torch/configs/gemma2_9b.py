"""--arch gemma2-9b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["gemma2-9b"]()
