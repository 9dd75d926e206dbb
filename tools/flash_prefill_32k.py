#!/usr/bin/env python3
"""Time B2 (bf16, the wgmma kernel) at every lm-zoo arch's 32k prefill
shape on one NVIDIA GPU.

    python3 tools/flash_prefill_32k.py

from the root of a checkout.  The dry run's prefill_32k cells
(``repro_torch.launch.dryrun``) run ``lm_prefill`` at (1, 32768), which
launches B2 once an attention layer on (1, 32768, H, hd) with the keys
repeated to every head (the llama-vision cross layers on the 6400 vision
keys, non-causal): one row a distinct (window, cross) of each arch whose
cell the card holds (not dbrx-132b; xlstm-125m has no attention), but
``chip_smoke.py``'s DRYRUN_PREFILL_FLASH, which the smoke holds and times
itself.  Two more rows re-time B2 and SDPA at the lm-zoo's 2 x 4096
prefill shapes of qwen2.5-14b and musicgen-medium.  Each row is
``chip_smoke.py``'s ``flash_shape_row``: the kernel against its plain
version within FLASH_TOLERANCE, then the kernel, the plain version and
SDPA (none where a softcap is on) on cold-cache timers, with the bound.
Prints the card's name and power limit and one JSON line a row.  Exits
non-zero where there is no CUDA device or a row is outside the tolerance.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("tinyllama-1.1b", "hymba-1.5b", "yi-6b", "gemma2-9b", "qwen2.5-14b",
         "llama-3.2-vision-11b", "musicgen-medium", "qwen3-moe-30b-a3b")
L = 32768
# the 2 x 4096 lm-zoo rows whose device times earlier runs did not record
ZOO_4K = (("qwen2.5-14b", 40, 128), ("musicgen-medium", 24, 64))


def prefill_shapes(cfg):
    """{(cross, window): attention layers} of ``cfg``'s prefill."""
    out = {}
    for desc in cfg.group:
        wins = desc.window_per_repeat or (desc.window,) * cfg.n_repeats
        for w in wins:
            if desc.kind in ("attn", "hymba", "xattn"):
                key = (desc.kind == "xattn", 0 if desc.kind == "xattn" else int(w))
                out[key] = out.get(key, 0) + 1
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_prefill_32k: no CUDA device; nothing was run")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    smoke_row = (cs.DRYRUN_PREFILL_FLASH, True, 0, 0.0)
    rows = [(arch, (1, L, cfg.n_vision_tokens if cross else L, cfg.n_heads,
                    cfg.resolved_head_dim), not cross, w, cfg.attn_softcap, n)
            for arch in ARCHS for cfg in [get_config(arch)]
            for (cross, w), n in sorted(prefill_shapes(cfg).items())]
    rows = [r for r in rows if ((r[0], r[1]), r[2], r[3], r[4]) != smoke_row]
    rows += [(arch, (2, 4096, 4096, H, hd), True, 0, 0.0, get_config(arch).n_layers)
             for arch, H, hd in ZOO_4K]
    bad = []
    for i, (arch, shape, causal, window, cap, layers) in enumerate(rows):
        try:
            row = cs.flash_shape_row(torch, dev, f"{arch} prefill", shape, causal, window,
                                     cap, seed=cs.SEED + 90 + i)
        except RuntimeError as e:
            bad.append(str(e))
            continue
        print(json.dumps(dict(arch=arch, launches_a_prefill=layers, **row)), flush=True)
    if bad:
        sys.exit(f"flash_prefill_32k: {bad}")


if __name__ == "__main__":
    main()
