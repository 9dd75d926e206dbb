#!/usr/bin/env python3
"""Which of a denoiser's products give a row other bits in a smaller batch,
on one NVIDIA GPU.

    python3 tools/batch_row_bits.py

from the root of a checkout.  A rank of a serve mesh holds a block of the
slots, so its model calls carry fewer points than a rank of a mesh with
fewer batch ranks; a point's row must keep its bits all the same.  This
prints, for the float32 products of ``paper-diffusion-policy-smoke`` (8
tokens a point, d_model 64, 4 heads of 16, d_ff 128) whole and as a rank's
tensor-parallel block on a model axis of 2, the row counts at which the
first 16 rows of ``x @ w`` differ in bits from those of a 320-row product
(cuBLAS picks its kernel, and with it the order of a sum, by the shape);
then whether B2's float32 kernel gives a point's rows other bits in a
smaller batch; then the same for the whole forward (``denoiser_fwd``) and
for a rank's tensor-parallel forward (its psum left out: every rank's
partial sum is row for row the same function of its own rows), and last
for the serve mesh's model call, which runs in blocks of 16 points
(``models/diffusion.py::_mesh_call``).  TF32 is off.  Prints the card's
name and power limit first and one JSON line a check; exits non-zero
where there is no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("batch_row_bits: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.distributed.group import MeshGroups
    from repro_torch.distributed.sharding import param_pspecs, shard_params, tp_paths
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.models.diffusion import _mesh_call, denoiser_fwd
    from repro_torch.nn.param import param_axes
    from repro_torch.weights import init_denoiser_params, param_shapes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # (in, out) of the products: in_proj, wq / wk / wv / wo, the FFN, out_proj,
    # whole and as a tensor-parallel rank's block (wq 64 -> 32, wo 32 -> 64,
    # w_gate / w_up 64 -> 64, w_down 64 -> 64)
    for k, n in [(4, 64), (64, 64), (64, 128), (128, 64), (64, 4), (64, 32), (32, 64)]:
        w = torch.randn(k, n, generator=g, device=dev)
        x = torch.randn(320, k, generator=g, device=dev)
        ref = (x @ w)[:16]
        rows = [m for m in (16, 32, 40, 80, 96, 160, 200) if not torch.equal((x[:m] @ w)[:16], ref)]
        print(json.dumps({"check": "product", "in": k, "out": n,
                          "rows_that_differ_from_320": rows}), flush=True)
    for H in (2, 4):
        q, kk, v = (torch.randn(20, 8, H, 16, generator=g, device=dev) for _ in range(3))
        ref = flash_mha(q, kk, v, causal=False)[:2]
        points = [b for b in (2, 4, 5, 10, 16) if not torch.equal(
            flash_mha(q[:b], kk[:b], v[:b], causal=False)[:2], ref)]
        print(json.dumps({"check": "flash_attention_f32", "heads": H,
                          "points_that_differ_from_20": points}), flush=True)

    dc = paper_diffusion_policy_smoke()
    params = init_denoiser_params(dc, 0, out_scale=1.0, device=dev)
    mesh = MeshGroups((1, 2), ("data", "model"), 0, "cuda")
    axes, shapes = param_axes(dc), param_shapes(dc)
    specs = param_pspecs(axes, shapes, mesh)
    assert tp_paths(axes, specs), "the smoke config has tensor-parallel leaves"
    local = shard_params(params, specs, mesh)
    # rank 0 of two, its psum left out: the rows of its partial sums
    partial = types.SimpleNamespace(world=2, rank=0, axis_index=lambda: 0, psum=lambda x: x)
    t = torch.linspace(1, 9, 20, device=dev)
    y = torch.randn(20, dc.seq_len, dc.d_data, generator=g, device=dev)
    calls = {
        "denoiser_fwd whole": lambda tb, yb: denoiser_fwd(params, tb, yb, dc),
        "denoiser_fwd tensor-parallel rank": lambda tb, yb: denoiser_fwd(
            local, tb, yb, dc, tp_axis=partial),
        "mesh model call (16-point blocks)": lambda tb, yb: _mesh_call(
            local, tb, yb, None, dc, None, dict(tp_axis=partial)),
    }
    with torch.no_grad():
        for name, fn in calls.items():
            ref = fn(t, y)
            points = [b for b in (1, 2, 4, 5, 8, 10, 16) if not torch.equal(fn(t[:b], y[:b]),
                                                                            ref[:b])]
            print(json.dumps({"check": name, "points_that_differ_from_20": points}), flush=True)


if __name__ == "__main__":
    main()
