#!/usr/bin/env python3
"""Time the two designs of B7's backward on one NVIDIA GPU.

    python3 tools/ssm_scan_bwd_designs.py

from the root of a checkout.  (b) is the port's kernel,
``src/repro_torch/csrc/ssm_scan_bwd.cu`` (a shared-memory ring filled by
``cp.async``); (a) is ``tools/ssm_scan_bwd_designs.cu`` (the forward's
register pipeline run backward: each thread loads its next steps into
registers while its chain runs the current ones), built here with nvcc
into ``build/ssm_scan_bwd_designs/``.
Both are held against ``ssm_scan_backward_plain`` in bits at hymba-1.5b's
training shape (8, 128, 25,600) and at edge shapes, then timed at the
training shape in turns (a, b, b, a) with ``chip_smoke.py``'s cold-cache
timers: CUDA events around each call and torch.profiler device time, a
64 MB L2 flush before each call.  Prints the card's name and power limit,
each build's registers and spills, one JSON line a timing, and a last JSON
line with each design's mean device ms and the faster design.  Exits
non-zero where there is no CUDA device or a design disagrees with the
plain version.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "tools" / "ssm_scan_bwd_designs.cu"
OUT = ROOT / "build" / "ssm_scan_bwd_designs"
SHAPE = (8, 128, 25600)
EDGES = ((2, 37, 25601), (3, 17, 130), (2, 1, 25600), (2, 50, 1), (2, 33, 256))


def _build_regs(cs):
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "libssm_scan_bwd_regs.so"
    done = subprocess.run([_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-shared", str(SRC),
                           "-o", str(lib)], capture_output=True, text=True)
    if done.returncode != 0:
        sys.exit(f"nvcc failed on {SRC.name}:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(lib)).repro_ssm_scan_bwd_regs
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, cs.ptxas_of(done.stdout + done.stderr, "ssm_scan_bwd_regs_kernel")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("ssm_scan_bwd_designs: no CUDA device; nothing was run")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_scan.ops import (linear_scan, ssm_scan_backward_cuda,
                                                  ssm_scan_backward_plain, ssm_scan_plain)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    _build.library()
    regs_fn, regs_ptxas = _build_regs(cs)
    print(json.dumps({"build": {"a_register_pipeline": regs_ptxas,
                                "b_cp_async_ring": cs._ptxas_info("ssm_scan_bwd",
                                                                  "ssm_scan_bwd_kernel")}}),
          flush=True)

    def regs(a, h, G):
        da, db = torch.empty_like(a), torch.empty_like(a)
        B, L, D = a.shape
        _build.check(regs_fn(a.data_ptr(), h.data_ptr(), G.data_ptr(), da.data_ptr(),
                             db.data_ptr(), B, L, D, torch.cuda.current_stream().cuda_stream),
                     "ssm_scan_bwd_regs launch")
        return da, db

    designs = {"a_register_pipeline": regs, "b_cp_async_ring": ssm_scan_backward_cuda}
    inputs = {}
    for B, L, D in (SHAPE,) + EDGES:
        g = torch.Generator(device=dev).manual_seed(B * L + D)
        a = 0.5 + 0.499 * torch.rand(B, L, D, generator=g, device=dev)
        h = ssm_scan_plain(a, torch.randn(B, L, D, generator=g, device=dev))
        G = torch.randn(B, L, D, generator=g, device=dev)
        want = ssm_scan_backward_plain(a, h, G)
        for name, fn in designs.items():
            got = fn(a, h, G)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                sys.exit(f"ssm_scan_bwd_designs: {name} differs from the plain backward at "
                         f"{(B, L, D)}")
        inputs[(B, L, D)] = (a, h, G)
    print(json.dumps({"equal_bits": [list(s) for s in inputs]}), flush=True)

    a, h, G = inputs[SHAPE]
    n = a.numel()
    bound, _ = cs.bound_ms(20.0 * n, 3.0 * n, cs.PEAK_F32)
    device = {name: [] for name in designs}
    for name in ("a_register_pipeline", "b_cp_async_ring", "b_cp_async_ring",
                 "a_register_pipeline"):
        fn = designs[name]
        ms = cs.cold_ms(lambda: fn(a, h, G), reps=20)
        dms, lost = cs.device_ms(lambda: fn(a, h, G), reps=20,
                                 wrapper=linear_scan if name.startswith("b_") else None)
        if dms is not None:
            device[name].append(dms)
        print(json.dumps({"design": name, "shape": list(SHAPE), "ms": ms, "device_ms": dms,
                          "device_records_lost": lost, "bound_ms": bound}), flush=True)
    means = {k: sum(v) / len(v) if v else None for k, v in device.items()}
    timed = {k: v for k, v in means.items() if v is not None}
    print(json.dumps({"nvidia_smi": smi, "shape": list(SHAPE), "bound_ms": bound,
                      "device_ms": means,
                      "share_of_bound": {k: bound / v for k, v in timed.items()},
                      "faster": min(timed, key=timed.get) if timed else None}), flush=True)


if __name__ == "__main__":
    main()
