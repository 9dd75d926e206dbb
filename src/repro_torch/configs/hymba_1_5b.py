"""--arch hymba-1.5b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["hymba-1.5b"]()
