"""--arch xlstm-125m: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["xlstm-125m"]()
