"""--arch llama-3.2-vision-11b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["llama-3.2-vision-11b"]()
