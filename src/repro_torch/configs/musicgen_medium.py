"""--arch musicgen-medium: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["musicgen-medium"]()
