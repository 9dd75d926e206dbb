"""The port's serve CLI against the JAX CLI at ``--mesh 1x1 --shards 2``
(per-shard dispatch, which runs on one CPU device), both in process with
the smoke model: the served requests, the rounds (summed over the shards
in both) and the accept rate must agree.  Both inits keep ``out_proj``
zero, so every proposal is accepted and the weights' draws do not enter
these numbers."""

import re
import sys

import pytest

from repro.launch import serve as j_serve
from repro_torch.launch import serve as t_serve

ARGS = ["--model", "paper-diffusion-policy-smoke", "--K", "20", "--chains", "8",
        "--slots", "4", "--shards", "2"]
LINE = re.compile(r"\[continuous\] served (\d+) requests on 4 slots .*shards=2 "
                  r"router=(\S+), .*: (\d+) fused rounds in \d+ supersteps, "
                  r"accept rate ([0-9.]+)")


@pytest.mark.parametrize("router", ["least-loaded", "round-robin"])
def test_the_sharded_cli_agrees_with_jax(router, capsys, monkeypatch):
    argv = ARGS + ["--router", router]
    monkeypatch.setattr(sys, "argv", ["repro.launch.serve", "--mesh", "1x1", *argv])
    j_serve.main()
    jline = next(ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[continuous]"))
    summary = t_serve.main(["--device", "cpu", *argv])
    tline = next(ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[continuous]"))
    j, t = LINE.search(jline), LINE.search(tline)
    assert j and t, (jline, tline)
    assert j.groups() == t.groups() == (str(8), router, t.group(3), "1.00")
    assert summary["retired"] == 8 and summary["rounds_total"] == int(j.group(3))
    assert summary["accept_rate"] == 1.0 and summary["finite"]
