"""Tables of the dry run's per-cell records (``repro_torch.launch.dryrun``):
the port's copy of the JAX package's ``analysis/report.py``.

    PYTHONPATH=src python -m repro_torch.analysis.report [--dir results/dryrun_torch]

``roofline_table`` gives the JAX module's text for records of the JAX
form.  ``dryrun_table`` keeps the JAX columns that mean something for a
run on one card (the record's status, the measured step's temporaries and
arguments) and adds the measured step's status; the collective counts are
"-" until the dry run has sharding variants (ROADMAP.md A13).
``measured_table`` gives each cell's measured batch-1 step against its
analytic bound, the cells furthest below their bound first.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(directory: str):
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_t(x):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.2e}"


def fmt_b(x):
    if not x:
        return "-"
    return f"{x / 2**30:.2f}"


def _label(r):
    v = r.get("variant")
    return f"{r['shape']}:{v}" if v else r["shape"]


def dryrun_table(recs):
    lines = [
        "| arch | shape | status | measured | per-dev temp GiB | per-dev args GiB | collectives (AR/AG/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {_label(r)} | SKIP ({r['reason'][:40]}...) | - | - | - | - |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {_label(r)} | FAIL | - | - | - | - |")
            continue
        mem = r.get("memory", {})
        lines.append(
            f"| {r['arch']} | {_label(r)} | ok | {r.get('measured', {}).get('status', '-')} "
            f"| {fmt_b(mem.get('temp_bytes'))} | {fmt_b(mem.get('argument_bytes'))} "
            f"| - |"
        )
    return "\n".join(lines)


def roofline_table(recs):
    lines = [
        "| arch | shape | t_compute s | t_memory s | t_collective s | dominant "
        "| roofline frac | MODEL_FLOPS/HLO | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            continue
        ro = r["roofline"]
        note = _bottleneck_note(r)
        lines.append(
            f"| {r['arch']} | {_label(r)} | {fmt_t(ro['t_compute_s'])} "
            f"| {fmt_t(ro['t_memory_s'])} | {fmt_t(ro['t_collective_s'])} "
            f"| {ro['dominant']} | {ro.get('roofline_fraction', 0):.2f} "
            f"| {r.get('useful_flops_ratio', 0):.2f} | {note} |"
        )
    return "\n".join(lines)


def _bottleneck_note(r) -> str:
    ro = r["roofline"]
    dom = ro["dominant"]
    arch, shape = r["arch"], r["shape"]
    if dom == "collective":
        return ("shrink TP / use model axis for DP-FSDP; overlap TP all-reduce "
                "with compute")
    if dom == "memory":
        if "decode" in shape or "500k" in shape:
            return "KV-cache reads dominate: quantize cache / widen batch"
        return "increase arithmetic intensity: larger microbatch or fusion"
    return "compute-bound: near-roofline; watch remat re-forward (x4/3)"


def _fmt(x, spec):
    return "-" if x is None else format(x, spec)


def measured_table(recs):
    """The measured batch-1 steps: ok ones by fraction of their bound,
    lowest first, then the cells too large for the card and the errors
    (the record's, or its measured step's)."""
    ok, rest = [], []
    for r in recs:
        if r["status"] == "skipped":
            continue
        m = r.get("measured")
        (ok if r["status"] == "ok" and m and m["status"] == "ok" else rest).append(r)
    ok.sort(key=lambda r: r["measured"]["fraction"])
    lines = [
        "| arch | shape | step | ms | bound ms (by) | fraction | tokens/s | peak GB "
        "| reckoned GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in ok:
        m = r["measured"]
        lines.append(
            f"| {r['arch']} | {_label(r)} | {m.get('step') or m['what']} | {m['ms']:.3f} "
            f"| {m['bound_ms']:.3f} ({m['bound_by']}) | {m['fraction']:.3f} "
            f"| {m['tokens_per_s']:,.0f} | {_fmt(m.get('peak_gb'), '.2f')} "
            f"| {m['reckoned_gb']:.2f} |"
        )
    for r in rest:
        m = r.get("measured") or {"status": "error"}
        status = m["status"]
        if status == "error":
            error = (m.get("error") or r.get("error") or "").replace("|", "/")
            status = f"error: {error[:60]}"
        lines.append(f"| {r['arch']} | {_label(r)} | {status} | - | - | - | - | - "
                     f"| {_fmt(m.get('reckoned_gb'), '.2f')} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    for mesh in ("single", "multi"):
        d = os.path.join(args.dir, mesh)
        if not os.path.isdir(d):
            continue
        recs = load(d)
        devices = sorted({r["measured"]["device"] for r in recs
                          if r.get("measured", {}).get("device")})
        ok = sum(r["status"] == "ok" for r in recs)
        skip = sum(r["status"] == "skipped" for r in recs)
        print(f"\n### {mesh} mesh: {ok} ok / {skip} skipped / {len(recs)} total\n")
        print(f"measured on: {'; '.join(devices) or 'no device'}\n")
        print(dryrun_table(recs))
        print()
        if mesh == "single":
            print("#### Roofline (single-pod, per the brief)\n")
            print(roofline_table(recs))
            print()
        print("#### Measured batch-1 steps\n")
        print(measured_table(recs))


if __name__ == "__main__":
    main()
