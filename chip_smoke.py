#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

run from the root of a checkout (it adds ``src`` to ``sys.path`` itself).
Phases, each printing one JSON line and raising on any failure:

  1. device   the card (nvidia-smi's name and power limit, on a line of its
              own), torch and CUDA versions; TF32 is switched off.
  2. build    nvcc builds the kernels from ``src/repro_torch/csrc``.
  3. grs / flash_attention
              each kernel against its plain PyTorch version on the card, at
              the main path's shape and at edge shapes: max abs error,
              kernel / plain / library times (median of CUDA-event timings)
              and the card's bound for the same work.
  4. denoiser the full-width ``paper-pixel-dit`` denoiser (random weights
              from a seed): one forward through the flash kernel against
              the same forward through the naive attention.
     asd      ``asd_sample_batched`` (4 chains, theta 8, K 64) with the
              launch counts of both kernels during that run, then the
              sequential baseline on the same chains.
     reference
              the same sampler on a small denoiser, on the card and on the
              CPU with the same noise: counters equal, samples close.
  5. kernels  one JSON line with every ported kernel's numbers.
  6. the last line: {"ok": true, "device": {...}}.

It exits non-zero, printing no result, where there is no CUDA device or
no ``src/repro_torch`` beside it.  No JAX is imported.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): bf16 tensor cores, float32 without
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12

K, THETA, CHAINS = 64, 8, 4
SEED = 0
OUT_SCALE = 1e-2  # out_proj = normal * OUT_SCALE / sqrt(d_model)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timings."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- phase 3


def check_grs(torch, dev):
    from repro_torch.core.grs import grs as grs_plain
    from repro_torch.kernels.grs.ops import grs

    def inputs(R, D, seed, zero_rows=True):
        g = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand(R, generator=g, device=dev)
        xi = torch.randn(R, D, generator=g, device=dev)
        mh = torch.randn(R, D, generator=g, device=dev)
        m = mh + 2.0 * torch.randn(R, D, generator=g, device=dev) / D ** 0.5
        sig = torch.rand(R, generator=g, device=dev) + 0.5
        if zero_rows and R > 3:
            sig[0] = 0.0  # sigma 0, v != 0: reject, z = m
            m[1] = mh[1]  # v 0: accept
            sig[2] = 0.0
            m[2] = mh[2]  # sigma 0 and v 0: accept
        return u, xi, mh, m, sig

    def compare(args):
        zk, ak = grs(*args)
        torch.cuda.synchronize()
        zp, ap = grs_plain(*args)
        u, xi, mh, m, sig = args
        v = (mh - m).double()
        vv, vx = (v * v).sum(-1), (v * xi.double()).sum(-1)
        s = torch.where(sig > 0, sig, torch.ones_like(sig)).double()
        margin = (torch.log(torch.clamp(u.double(), min=1e-20))
                  - torch.clamp(-(vx / s + vv / (2 * s * s)), max=0)).abs()
        near = (margin < 1e-5) & (sig > 0)
        if not torch.equal(ak[~near], ap[~near]):
            fail(f"grs: accept bits differ away from the threshold at {tuple(xi.shape)}")
        err = (zk - zp).abs().max().item()
        if not err <= 1e-5:
            fail(f"grs: max abs error {err} > 1e-5 at {tuple(xi.shape)}")
        return err, int(ak.sum())

    R, D = CHAINS * THETA, 1024 * 192
    edges = {}
    for name, (r, d, zero) in {"R=1": (1, 1000, False), "D=1": (8, 1, True),
                               "D=4097": (9, 4097, True),
                               "sigma0_v0_rows": (16, 5000, True)}.items():
        edges[name] = compare(inputs(r, d, len(name), zero))[0]
    main = inputs(R, D, 1, zero_rows=False)
    err, accepted = compare(main)
    ms = cuda_ms(lambda: grs(*main), reps=20)
    plain_ms = cuda_ms(lambda: grs_plain(*main), reps=20)
    bms, by = bound_ms(4.0 * R * D * 4 + 3 * R * 4, 10.0 * R * D, PEAK_F32)
    emit("grs", shape=[R, D], max_abs_err=err, accepted_rows=accepted,
         edge_max_abs_err=edges, tolerance="z atol 1e-5; accept bits equal "
         "except rows within 1e-5 of the threshold",
         ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    return dict(name="grs", route="cuda", source="src/repro_torch/csrc/grs.cu",
                replaces="src/repro/kernels/grs/kernel.py:27", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def check_flash(torch, dev):
    from repro_torch.kernels.flash_attention.ops import attention_plain, flash_mha

    bf16 = torch.bfloat16

    def inputs(B, L, S, H, hd, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(B, n, H, hd, generator=g, device=dev).to(bf16)
                for n in (L, S, S)]

    def compare(q, k, v, **opts):
        ok = flash_mha(q, k, v, **opts)
        torch.cuda.synchronize()
        op = attention_plain(q, k, v, **opts)
        err = (ok.float() - op.float()).abs().max().item()
        # one bf16 rounding of the output on each side: 8 mantissa bits
        if not err <= 2e-2:
            fail(f"flash: max abs error {err} > 2e-2 at {tuple(q.shape)} {opts}")
        return err

    edges = {
        "L=16": compare(*inputs(4, 16, 16, 16, 64, 1), causal=False),
        "ragged L=40": compare(*inputs(4, 40, 40, 16, 64, 2), causal=False),
        "causal": compare(*inputs(2, 300, 300, 8, 64, 3), causal=True),
        "window 48": compare(*inputs(2, 300, 300, 8, 64, 4), causal=True, window=48),
        "softcap 30": compare(*inputs(2, 200, 200, 8, 64, 5), causal=False,
                              softcap=30.0),
        "dh=72": compare(*inputs(2, 256, 256, 16, 72, 6), causal=False),
    }
    B, L, H, hd = CHAINS * THETA, 1024, 16, 64
    q, k, v = inputs(B, L, L, H, hd, 7)
    err = compare(q, k, v, causal=False)
    ms = cuda_ms(lambda: flash_mha(q, k, v, causal=False), reps=5)
    plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=False), reps=5)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt), reps=5)
    bms, by = bound_ms(4.0 * B * L * H * hd * 2, 4.0 * B * H * L * L * hd, PEAK_BF16)
    emit("flash_attention", shape=[B, L, H, hd], dtype="bfloat16", max_abs_err=err,
         edge_max_abs_err=edges, tolerance="atol 2e-2 (bf16 output)", ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, library="scaled_dot_product_attention",
         bound_ms=bms, bound_by=by,
         tflops=4.0 * B * H * L * L * hd / ms / 1e9)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:27",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=library_ms)


# ---------------------------------------------------------------- phase 4


def run_slice(torch, dev):
    from repro_torch.configs.registry import paper_pixel_dit
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.core.sequential import sequential_sample_batched
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.grs.ops import grs
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.weights import init_denoiser_params

    dc = paper_pixel_dit()
    cfg = dc.backbone
    t0 = time.perf_counter()
    params = init_denoiser_params(dc, SEED, out_scale=OUT_SCALE, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    emit("weights", model=cfg.name, params=n_params, seconds=time.perf_counter() - t0,
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         d_ff=cfg.d_ff, seq_len=dc.seq_len, d_data=dc.d_data, seed=SEED,
         out_scale=OUT_SCALE)

    flash_fn = make_sl_model_fn(params, dc)
    naive_fn = make_sl_model_fn(params, dc, attn_impl="naive")
    g = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.tensor([0.05, 0.5, 5.0, 50.0], device=dev)
    y = torch.randn(4, dc.seq_len, dc.d_data, generator=g, device=dev) * (t * t + t).sqrt()[:, None, None]
    with torch.no_grad():
        out_f, out_n = flash_fn(t, y), naive_fn(t, y)
    torch.cuda.synchronize()
    rel = ((out_f - out_n).norm() / out_n.norm()).item()
    if not (torch.isfinite(out_f).all() and rel <= 5e-2):
        fail(f"denoiser: flash vs naive relative L2 error {rel} > 5e-2")
    emit("denoiser", relative_l2_err=rel, max_abs_err=(out_f - out_n).abs().max().item(),
         out_abs_max=out_n.abs().max().item(),
         tolerance="relative L2 5e-2: bf16 compute over 24 layers; the naive "
         "core rounds scores and probabilities to bf16, the kernel does not")

    sched = sl_geometric(K, t_min=0.05, t_max=50.0)
    y0 = torch.zeros(CHAINS, dc.seq_len, dc.d_data, device=dev)
    # each model call and the GRS step once, alone, for the time breakdown
    with torch.no_grad():
        pts = torch.randn(CHAINS * THETA, dc.seq_len, dc.d_data, generator=g, device=dev)
        tv = sched.t_model[:THETA].repeat(CHAINS).to(dev)
        verify_ms = cuda_ms(lambda: flash_fn(tv, pts), reps=3, warmup=1)
        propose_ms = cuda_ms(lambda: flash_fn(tv[:CHAINS], pts[:CHAINS]), reps=3, warmup=1)

        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        grs.launches = flash_mha.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = asd_sample_batched(flash_fn, sched, y0, THETA, eager_head=False,
                                 generator=g, device=dev)
        torch.cuda.synchronize()
        asd_s = time.perf_counter() - t0
        launches = {"grs": grs.launches, "flash_attention": flash_mha.launches}

        g = torch.Generator(device=dev).manual_seed(SEED + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = sequential_sample_batched(flash_fn, sched, y0, generator=g, device=dev)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0

    rounds = res.rounds.tolist()
    head_calls = res.head_calls.tolist()
    depth = (res.rounds + res.head_calls).tolist()
    loop_rounds = max(rounds)
    model_calls = 2 * loop_rounds  # one proposal + one verification call a round
    finite = bool(torch.isfinite(res.sample).all() and torch.isfinite(seq).all())
    shape_ok = tuple(res.sample.shape) == (CHAINS, dc.seq_len, dc.d_data)
    if not (finite and shape_ok):
        fail(f"asd: finite={finite}, sample shape {tuple(res.sample.shape)}")
    if launches["grs"] < loop_rounds or launches["grs"] == 0:
        fail(f"asd: {launches['grs']} GRS launches for {loop_rounds} rounds")
    if launches["flash_attention"] != cfg.n_layers * model_calls:
        fail(f"asd: {launches['flash_attention']} flash launches, expected "
             f"{cfg.n_layers} x {model_calls} model calls")
    accepts, proposals = int(res.accepts.sum()), int(res.proposals.sum())
    emit("asd", K=K, theta=THETA, chains=CHAINS, eager_head=False,
         schedule="sl_geometric(K, t_min=0.05, t_max=50.0)",
         rounds=rounds, head_calls=head_calls, depth=depth,
         mean_depth=statistics.mean(depth),
         K_over_depth=[K / d for d in depth], accept_rate=accepts / max(proposals, 1),
         accepts=accepts, proposals=proposals, model_calls=model_calls,
         launches=launches, asd_wall_s=asd_s, sequential_wall_s=seq_s,
         sequential_model_calls=K, finite=finite,
         samples_per_s_asd=CHAINS / asd_s, samples_per_s_sequential=CHAINS / seq_s)
    emit("where_time_goes", round_wall_ms=asd_s / loop_rounds * 1e3,
         verification_call_ms=verify_ms, proposal_call_ms=propose_ms,
         note="each call timed alone (CUDA events, median of 3); the kernels' "
              "own times are in the grs and flash_attention lines")
    profile_round(torch, dev, flash_fn, sched, y0)
    return launches


# device kernels by what they do, matched on their names
_KERNEL_GROUPS = (("flash_attention", ("flash_fwd",)), ("grs", ("grs_",)),
                  ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")))


def profile_round(torch, dev, model_fn, sched, y0):
    """One warm ASD round under torch.profiler: device time by kernel group
    and the device's idle share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.asd import asd_round, init_chain_state

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    with torch.no_grad():
        st = init_chain_state(sched.to(dev), y0, THETA, generator=g)
        st = asd_round(model_fn, sched.to(dev), st, THETA)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            asd_round(model_fn, sched.to(dev), st, THETA)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    if not kernels:
        emit("profile", round_wall_ms=wall_ms, device_ms="not measured",
             note="the profiler recorded no device time")
        return
    busy = sum(ms for _, ms, _ in kernels)
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["other"] = 0.0
    for key, ms, _ in kernels:
        group = next((name for name, marks in _KERNEL_GROUPS
                      if any(m in key for m in marks)), "other")
        groups[group] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit("profile", round_wall_ms=wall_ms, device_busy_ms=busy,
         device_idle_share=max(0.0, 1.0 - busy / wall_ms), device_ms_by_group=groups,
         top_kernels=[{"name": k[:80], "ms": ms, "count": n} for k, ms, n in top],
         note="one warm round (proposal + verification call, GRS, plan and "
              "commit) under torch.profiler; kernels run on one stream")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def check_reference(torch, dev):
    """The sampler on a small denoiser, on the card and on the CPU, with the
    same weights and noise: counters equal, samples within 2e-3 (float32
    sums in other orders, grown over the chained steps)."""
    from repro_torch.configs.registry import paper_diffusion_policy_smoke
    from repro_torch.core.asd import asd_sample_batched
    from repro_torch.core.schedules import sl_geometric
    from repro_torch.models.diffusion import make_sl_model_fn
    from repro_torch.weights import init_denoiser_params

    dc = paper_diffusion_policy_smoke()
    k, theta, b = 16, 4, 3
    sched = sl_geometric(k, 0.05, 50.0)
    gen = torch.Generator().manual_seed(SEED)
    u = torch.rand(b, k + theta + 1, generator=gen)
    xi = torch.randn(b, k + theta + 1, dc.seq_len, dc.d_data, generator=gen)
    y0 = torch.zeros(b, dc.seq_len, dc.d_data)
    out = {}
    for where in ("cpu", dev):
        params = init_denoiser_params(dc, SEED, out_scale=1.0, device=where)
        with torch.no_grad():
            out[str(where)] = asd_sample_batched(
                make_sl_model_fn(params, dc), sched, y0, theta, u_buf=u, xi_buf=xi,
                device=where)
    cpu, card = out["cpu"], out[str(dev)]
    for name in ("rounds", "head_calls", "model_evals", "accepts", "proposals"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            fail(f"reference: {name} differs between card and CPU")
    err = (card.sample.cpu() - cpu.sample).abs().max().item()
    if not err <= 2e-3 or not bool((cpu.accepts < cpu.proposals).any()):
        fail(f"reference: sample error {err} or no rejection")
    emit("reference", model=dc.backbone.name, K=k, theta=theta, chains=b,
         max_abs_err=err, tolerance=2e-3, rounds=cpu.rounds.tolist(),
         accepts=int(cpu.accepts.sum()), proposals=int(cpu.proposals.sum()))


# ---------------------------------------------------------------- main


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing was run")
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.exit(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    emit("build", nvcc_seconds="cached" if info["seconds"] is None else info["seconds"],
         load_seconds=time.perf_counter() - t0, library=info["path"])

    kernels = [check_grs(torch, dev), check_flash(torch, dev)]
    launches = run_slice(torch, dev)
    check_reference(torch, dev)
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
