"""--arch dbrx-132b: the exact assigned config (see archs.py for provenance)."""
from repro_torch.configs.archs import ARCHS

CONFIG = ARCHS["dbrx-132b"]()
