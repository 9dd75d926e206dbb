"""The port's serve CLI, ``python -m repro_torch.launch.serve``, on the CPU
with the smoke model: every engine and option prints the JAX CLI's lines
with ``finite=True`` (branched runs with its ``branch depth`` clause,
sharded runs with its ``shards=2 router=...`` clause, model-parallel runs
over two ranks with its ``mp=2`` clause and ``collectives:`` line); a
model-parallel combination the JAX CLI rejects exits with its message;
every flag the port has no counterpart for exits with status 2 and names
its ROADMAP.md item; without ``--device cpu`` and with no card it raises
instead of running on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--model", "paper-diffusion-policy-smoke", "--K", "20"]

# each run covers several options; together they cover every engine and
# option chip_smoke.py runs on the card
RUNS = {
    "continuous": [],
    "fused": ["--engine", "fused"],
    "packed-aimd-metrics-profile": [
        "--execution", "packed", "--round-budget", "24", "--theta-controller", "aimd",
        "--metrics-port", "0", "--profile-supersteps", "2", "--profile-dir", "{tmp}/profile"],
    "fused-round-accept-rate-R4-trace": [
        "--execution", "packed", "--round-budget", "24", "--round-impl", "fused",
        "--theta-controller", "accept-rate", "--rounds-per-sync", "4",
        "--trace-out", "{tmp}/trace.json"],
    "num-branches-2": ["--num-branches", "2"],
    "branch-controller-gain": ["--num-branches", "2", "--branch-controller", "gain"],
    "shards-2": ["--shards", "2"],
    "shards-2-round-robin": ["--shards", "2", "--router", "round-robin"],
    "shards-2-dispatch-fused": ["--shards", "2", "--dispatch", "fused", "--execution",
                                "packed", "--round-impl", "fused"],
    # model parallelism: two ranks started by the CLI, each on the CPU (K 10:
    # every collective crosses processes)
    "model-shards-2": ["--model-shards", "2", "--K", "10"],
    "seq-shards-2": ["--seq-shards", "2", "--K", "10"],
    "expert-parallel-moe": ["--model", "qwen3-moe-a3b-smoke", "--K", "10", "--expert-parallel",
                            "--model-shards", "2"],
}


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [a.replace("{tmp}", str(tmp_path)) for a in args]
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *BASE, *args],
                          capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_the_cli_serves_on_the_cpu(run, tmp_path):
    proc = _cli(RUNS[run], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "finite=True" in out and "finite=False" not in out
    if run == "fused":
        assert out.startswith("[fused] sampled 8 chains (K=20)")
        return
    line = next(ln for ln in out.splitlines() if ln.startswith("[continuous]"))
    # the profiled run's warm pool (one request a slot) lands in the stats too
    served = 12 if "--profile-supersteps" in RUNS[run] else 8
    assert f"served {served} requests on 4 slots" in line and "samples/s" in line
    assert "output (8, 4) per request, finite=True" in out
    if "--metrics-port" in RUNS[run]:
        assert "/healthz status=ok" in out and "[metrics] scraped" in out
        assert "controller=aimd" in line and "packed B=24/32" in line
        assert "[profile] 2 warm supersteps" in out
        assert (tmp_path / "profile" / "serve_trace.json").is_file()
    if "--trace-out" in RUNS[run]:
        doc = json.loads((tmp_path / "trace.json").read_text())
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"dispatch", "device_wait", "harvest", "request"} <= names
        assert "[trace]" in out
        assert "R=4" in line and "controller=accept-rate" in line
    if "--shards" in RUNS[run]:
        router = "round-robin" if "--router" in RUNS[run] else "least-loaded"
        assert f", shards=2 router={router}" in line
        assert ("dispatch=fused" in line) == ("--dispatch" in RUNS[run])
        assert "packed B=16/16" in line if "--execution" in RUNS[run] else "unpacked" in line
        assert "shard 1: 4 routed, 4 retired" in proc.stderr
    else:
        assert "shards=" not in line
    mp = "--model-shards" in RUNS[run] or "--seq-shards" in RUNS[run]
    assert (", mp=2" in line) == mp and ("  collectives: " in out) == mp
    assert ("(sequence-parallel)" in line) == ("--seq-shards" in RUNS[run])
    assert ("(expert-parallel)" in line) == ("--expert-parallel" in RUNS[run])
    if "--num-branches" in RUNS[run]:
        # the JAX CLI's clause: mean accepted prefix a round, wasted drafts
        assert "branch depth " in line and "(waste " in line and "B=2)" in line
    else:
        assert "branch depth" not in line


REFUSED = {
    # the JAX CLI's default mesh serves since its model axis does; packed
    # rounds over its 2 batch ranks do not (A13 item 11)
    "--mesh 2x4": ("A13", ["--mesh", "2x4", "--execution", "packed"]),
    "--grs-impl": ("A8", ["--grs-impl", "core"]),
    "--pack-impl": ("A8", ["--pack-impl", "kernel"]),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_flags_without_a_counterpart_exit_2(what, capsys):
    item, args = REFUSED[what]
    with pytest.raises(SystemExit) as exc:
        serve.main(BASE + args)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"ROADMAP.md {item}" in err and args[0] in err


def test_a_refusal_is_the_process_exit_status(tmp_path):
    proc = _cli(["--mesh", "2x4", "--execution", "packed"], tmp_path)
    assert proc.returncode == 2 and "ROADMAP.md A13" in proc.stderr
    assert "finite" not in proc.stdout


# the model-parallel combinations the JAX CLI rejects, with its messages
BAD_COMBINATIONS = {
    "tp with sp": ["--model-shards", "2", "--seq-shards", "2"],
    "ep without a group": ["--expert-parallel"],
    "ep on the MoE without a group": ["--expert-parallel", "--model", "qwen3-moe-a3b-smoke"],
    "sp over heads that do not divide": ["--seq-shards", "3"],
}


@pytest.mark.parametrize("what", sorted(BAD_COMBINATIONS))
def test_a_bad_model_parallel_combination_gives_the_jax_message(what, monkeypatch):
    from repro.launch import serve as j_serve

    args = BAD_COMBINATIONS[what]
    with pytest.raises(SystemExit) as port:
        serve.main(BASE + args)
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", "--mesh", "1x1", *BASE[2:], *args])
    with pytest.raises(SystemExit) as ref:
        j_serve.main()
    assert isinstance(port.value.code, str) and port.value.code == ref.value.code


def test_main_returns_the_engine_summary():
    summary = serve.main(BASE + ["--chains", "4", "--K", "10"])
    assert summary["retired"] == 4 and summary["finite"] and summary["slots"] == 2
    assert summary["rounds_total"] > 0 and 0.0 <= summary["accept_rate"] <= 1.0


def test_without_a_card_the_cli_raises_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--model", "paper-diffusion-policy-smoke", "--K", "10"])
