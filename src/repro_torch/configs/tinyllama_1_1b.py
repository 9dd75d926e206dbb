"""--arch tinyllama-1.1b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["tinyllama-1.1b"]()
