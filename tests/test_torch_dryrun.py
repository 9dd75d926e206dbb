"""The port's dry run (``repro_torch.launch.dryrun``), its mesh and its
report: the reckoning's ``too_large`` cells, the measured steps of each
kind on reduced cells on the CPU (their plain versions), the refusals, the
resume rule, and the report's tables against the JAX package's
(``repro.analysis.report`` imports no JAX).  The analytic records are held
against the JAX dry run in ``test_torch_dryrun_jax.py``."""

import json

import pytest

from repro.analysis import report as j_report
from repro_torch.analysis import report as t_report
from repro_torch.analysis import roofline as t_rl
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import PAPER_MODELS, get_config
from repro_torch.launch import dryrun as t_dry
from repro_torch.launch import mesh as t_mesh

# the cells whose reckoning passes 0.9 of the H100's memory
TOO_LARGE = {("yi-6b", "train_4k"), ("gemma2-9b", "train_4k"),
             ("llama-3.2-vision-11b", "train_4k"), ("qwen2.5-14b", "train_4k"),
             ("qwen3-moe-30b-a3b", "train_4k"), ("dbrx-132b", "train_4k"),
             ("dbrx-132b", "prefill_32k"), ("dbrx-132b", "decode_32k"),
             ("paper-pixel-dit", "asd")}
SHARDING_VARIANTS = ("fsdp", "dp", "sp", "pad48sp", "dp256", "dp256memopt", "fsdpa1")


def test_the_too_large_cells_are_the_reckoned_ones():
    limit = t_dry.FIT_SHARE * t_dry.H100_BYTES
    assert t_dry.capacity_bytes("cpu") == t_dry.H100_BYTES == 85_017_493_504
    over = {(arch, shape) for arch, shape, _ in t_dry.parse_cells("all")
            if t_dry.reckon(t_dry.resolve_cell(arch, shape))["total"] > limit}
    assert over == TOO_LARGE
    assert len(t_dry.parse_cells("all")) - len(over) == 28
    # the memopt variant (counter noise, no trajectory) fits
    assert t_dry.reckon(t_dry.resolve_cell("paper-pixel-dit", "asd", "memopt"))["total"] < limit
    for arch, shape in sorted(TOO_LARGE):
        m = t_dry.measure(t_dry.resolve_cell(arch, shape), t_dry.torch.device("cpu"))
        assert m["status"] == "too_large" and m["reckoned_gb"] > m["limit_gb"]
        assert "ms" not in m and "bound_ms" not in m


def test_params_are_counted_leaf_by_leaf_on_the_meta_device():
    cell = t_dry.resolve_cell("qwen3-moe-30b-a3b", "decode_32k")
    tree = t_dry.meta_params(cell)
    leaves = [t for _, t in t_dry.pytree.paths(tree)]
    assert all(t.device.type == "meta" for t in leaves)
    total, active = t_dry.param_counts(cell.cfg, tree)
    assert total == sum(t.numel() for t in leaves)
    # the expert stacks are discounted, the router is not
    cfg = cell.cfg
    experts = sum(t.numel() for p, t in t_dry.pytree.paths(tree)
                  if p[-2] == "moe" and p[-1] != "router")
    assert active == total - experts + experts * cfg.top_k // cfg.n_experts


REDUCED = [("tinyllama-1.1b", "train_4k", 32), ("hymba-1.5b", "train_4k", 24),
           ("hymba-1.5b", "prefill_32k", 48), ("llama-3.2-vision-11b", "prefill_32k", 40),
           ("qwen3-moe-30b-a3b", "prefill_32k", 40), ("xlstm-125m", "decode_32k", 48),
           ("musicgen-medium", "decode_32k", 48), ("hymba-1.5b", "long_500k", 64)]
MEASURED_KEYS = {"status", "what", "batch", "ms", "tokens_per_s", "peak_gb", "reckoned_gb",
                 "bound_ms", "bound_by", "fraction", "device", "launches_per_run"}
RECORD_KEYS = {"arch", "shape", "mesh", "variant", "status", "ts", "devices", "params_total",
               "params_active", "tokens", "analytic", "model_flops", "useful_flops_ratio",
               "roofline", "measured"}


@pytest.mark.parametrize("arch, shape, L", REDUCED)
def test_run_cell_measures_a_reduced_lm_cell_on_the_cpu(tmp_path, arch, shape, L):
    rec = t_dry.run_cell(arch, shape, "single", str(tmp_path), device="cpu",
                         config=reduced(get_config(arch)), seq_len=L)
    assert rec["status"] == "ok", rec.get("traceback")
    assert RECORD_KEYS <= set(rec) and rec["devices"] == 256
    m = rec["measured"]
    assert MEASURED_KEYS <= set(m) and m["status"] == "ok" and m["finite"]
    assert m["batch"] == 1 and m["device"] == "cpu" and m["peak_gb"] is None
    assert len(m["runs_ms"]) >= 3 and m["ms"] > 0 and 0 < m["fraction"] <= 1.05
    assert not any(m["launches_per_run"].values())  # plain versions on the CPU
    kind = shape.split("_")[0]
    assert m["what"].startswith({"train": "one AdamW step", "prefill": "lm_prefill",
                                 "decode": "one lm_decode_step", "long": "one lm_decode_step"}
                                [kind])
    assert m["tokens"] == (1 if kind in ("decode", "long") else L)
    saved = json.loads((tmp_path / f"{arch}__{shape}.json").read_text())
    assert saved["measured"]["ms"] == m["ms"]


@pytest.mark.parametrize("variant", ["", "memopt", "aimd", "acceptrate"])
def test_run_cell_measures_an_asd_round_on_the_cpu(tmp_path, variant):
    rec = t_dry.run_cell("paper-diffusion-policy-smoke", "asd", "multi", str(tmp_path),
                         variant, device="cpu", n_chains=3, K=24)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 512 and rec["tokens"] == 3 * 8
    m = rec["measured"]
    assert m["status"] == "ok" and m["finite"] and m["batch"] == 3 and len(m["runs_ms"]) == 3
    assert m["tokens"] == 3 * 9 * 8 and "rounds 2-4" in m["what"]
    noise = "counter" if variant == "memopt" else "buffer"
    assert f"{noise} noise" in m["what"]
    assert set(m["reckoned_parts_gb"]) >= {"weights", "chains", "round"}


def test_accum_variants_change_the_analytic_term_only(tmp_path):
    cfg = reduced(get_config("tinyllama-1.1b"))
    recs = {v: t_dry.run_cell("tinyllama-1.1b", "train_4k", "single", str(tmp_path), v,
                              device="cpu", config=cfg, seq_len=16)
            for v in ("", "accum2")}
    assert "analytic term only" in recs["accum2"]["note"]
    assert recs["accum2"]["analytic"]["hbm_bytes"] < recs[""]["analytic"]["hbm_bytes"]
    assert recs["accum2"]["measured"]["bound_ms"] == recs[""]["measured"]["bound_ms"]


@pytest.mark.parametrize("variant", SHARDING_VARIANTS)
def test_sharding_variants_are_refused_naming_a9(tmp_path, variant, capsys):
    with pytest.raises(ValueError, match="A13"):
        t_dry.parse_cells(f"tinyllama-1.1b:train_4k:{variant}")
    with pytest.raises(ValueError, match="A13"):
        t_dry.run_cell("tinyllama-1.1b", "train_4k", "single", str(tmp_path), variant,
                       device="cpu")
    with pytest.raises(SystemExit) as exit_:
        t_dry.main(["--cells", f"paper-pixel-dit:asd:{variant}", "--device", "cpu",
                    "--out", str(tmp_path)])
    assert exit_.value.code == 2 and "A13" in capsys.readouterr().err
    assert not list(tmp_path.rglob("*.json"))


def test_bad_cells_are_refused():
    for spec in ("tinyllama-1.1b", "nope:train_4k", "tinyllama-1.1b:train_8k",
                 "tinyllama-1.1b:train_4k:fast"):
        with pytest.raises(ValueError):
            t_dry.parse_cells(spec)
    todo = t_dry.parse_cells("all")
    assert len(todo) == 32 + 5 and todo[-5:] == [(pm, "asd", "") for pm in PAPER_MODELS]
    assert t_dry.parse_cells("paper") == todo[-5:]


def test_an_ok_record_is_skipped_and_an_error_rerun(tmp_path, capsys):
    cfg = reduced(get_config("tinyllama-1.1b"))
    first = t_dry.run_cell("tinyllama-1.1b", "decode_32k", "single", str(tmp_path),
                           device="cpu", config=cfg, seq_len=16)
    again = t_dry.run_cell("tinyllama-1.1b", "decode_32k", "single", str(tmp_path),
                           device="cpu", config=cfg, seq_len=16)
    assert again == first and "[skip]" in capsys.readouterr().out
    # an LM cell under an ASD option is recorded as an error, and rerun
    bad = t_dry.run_cell("tinyllama-1.1b", "decode_32k", "single", str(tmp_path), "memopt",
                         device="cpu", config=cfg, seq_len=16)
    assert bad["status"] == "error" and "ASD sampler option" in bad["error"]
    rerun = t_dry.run_cell("tinyllama-1.1b", "decode_32k", "single", str(tmp_path), "memopt",
                           device="cpu", config=cfg, seq_len=16)
    assert rerun["ts"] > bad["ts"]


def test_the_cli_writes_one_record_a_cell(tmp_path):
    assert t_dry.main(["--mesh", "multi", "--cells", "paper-diffusion-policy-smoke:asd",
                       "--device", "cpu", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "multi" / "paper-diffusion-policy-smoke__asd.json").read_text())
    assert rec["mesh"] == "multi" and rec["measured"]["status"] == "ok"
    assert "K 1000" in rec["measured"]["what"]


def test_the_cli_measures_a_cell_once_for_both_meshes(tmp_path, monkeypatch):
    cell = ["--cells", "paper-diffusion-policy-smoke:asd", "--device", "cpu",
            "--out", str(tmp_path)]
    measured = []
    measure = t_dry.measure
    monkeypatch.setattr(t_dry, "measure", lambda *a: measured.append(a) or measure(*a))
    assert t_dry.main(["--mesh", "single"] + cell) == 0
    assert t_dry.main(["--mesh", "multi"] + cell) == 0
    assert len(measured) == 1
    recs = {mesh: json.loads((tmp_path / mesh / "paper-diffusion-policy-smoke__asd.json")
                             .read_text()) for mesh in ("single", "multi")}
    assert recs["single"]["measured"] == recs["multi"]["measured"]
    assert recs["multi"]["measured"]["measured_in"] == "single"
    assert (recs["single"]["devices"], recs["multi"]["devices"]) == (256, 512)
    # the report reads the meshes' records, not the kept measurements
    assert [r["mesh"] for r in t_report.load(str(tmp_path / "multi"))] == ["multi"]


def test_the_measured_table_lists_errors_and_too_large_cells():
    ok = {"arch": "yi-6b", "shape": "decode_32k", "variant": "", "status": "ok",
          "measured": {"status": "ok", "step": "decode step (graph)", "ms": 2.0,
                       "bound_ms": 1.0, "bound_by": "bytes", "fraction": 0.5,
                       "tokens_per_s": 500.0, "peak_gb": 1.5, "reckoned_gb": 1.25}}
    recs = [ok,
            {"arch": "dbrx-132b", "shape": "prefill_32k", "variant": "", "status": "ok",
             "measured": {"status": "too_large", "reckoned_gb": 294.14}},
            {"arch": "hymba-1.5b", "shape": "prefill_32k", "variant": "pad48",
             "status": "error", "error": "RuntimeError: sizes differ",
             "measured": {"status": "error", "error": "RuntimeError: sizes differ"}},
            {"arch": "tinyllama-1.1b", "shape": "decode_32k", "variant": "memopt",
             "status": "error", "error": "ValueError: an ASD | option"},
            {"arch": "yi-6b", "shape": "long_500k", "status": "skipped", "reason": "x"}]
    table = t_report.measured_table(recs).splitlines()
    assert len(table) == 2 + 4
    assert "| yi-6b | decode_32k | decode step (graph) | 2.000 | 1.000 (bytes) | 0.500 " in \
        table[2]
    assert "| too_large |" in table[3] and "294.14" in table[3]
    assert "| error: RuntimeError: sizes differ |" in table[4]
    assert "| error: ValueError: an ASD / option |" in table[5]


def _jax_form_records():
    """Records of the JAX dry run's form: ok (compute-, memory- and
    collective-dominated), skipped and failed."""
    def ok(arch, shape, tc, tm, tl, variant=""):
        terms = {"compute": tc, "memory": tm, "collective": tl}
        dom = max(terms, key=terms.get)
        return {"arch": arch, "shape": shape, "mesh": "single", "variant": variant,
                "status": "ok", "compile_s": 12.34, "devices": 256,
                "useful_flops_ratio": 0.71,
                "roofline": {"t_compute_s": tc, "t_memory_s": tm, "t_collective_s": tl,
                             "dominant": dom, "bound_s": max(terms.values()),
                             "roofline_fraction": tc / max(terms.values())},
                "hlo": {"coll_counts": {"all-reduce": 3, "all-gather": 1}},
                "memory": {"temp_bytes": 3 << 30, "argument_bytes": 5 << 29}}

    return [ok("tinyllama-1.1b", "train_4k", 4e-2, 1e-3, 2e-3),
            ok("yi-6b", "decode_32k", 1e-6, 3e-4, 0.0),
            ok("hymba-1.5b", "prefill_32k", 1e-3, 4e-3, 0.0, variant="pad48"),
            ok("dbrx-132b", "train_4k", 1e-3, 1e-4, 5e-3),
            ok("xlstm-125m", "long_500k", 1e-6, 1e-5, 0.0),
            {"arch": "yi-6b", "shape": "long_500k", "mesh": "single", "status": "skipped",
             "reason": "long_500k requires sub-quadratic attention (DESIGN.md)"},
            {"arch": "gemma2-9b", "shape": "train_4k", "mesh": "single", "variant": "",
             "status": "error", "error": "boom"}]


def test_the_report_gives_the_jax_text_on_jax_records(tmp_path):
    recs = _jax_form_records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    assert t_report.load(str(tmp_path)) == j_report.load(str(tmp_path)) == recs
    assert t_report.roofline_table(recs) == j_report.roofline_table(recs)
    for r in recs:
        assert t_report._label(r) == j_report._label(r)
        if r["status"] == "ok":
            assert t_report._bottleneck_note(r) == j_report._bottleneck_note(r)
    for x in (None, 0, 0.0, 1.5e-7, 3.25, 12345.0):
        assert t_report.fmt_t(x) == j_report.fmt_t(x)
        assert t_report.fmt_b(x) == j_report.fmt_b(x)
    # dryrun_table: the same rows and the columns that mean something on
    # one card (arch, shape, status, temporaries, arguments)
    t_rows = [line.split("|") for line in t_report.dryrun_table(recs).splitlines()]
    j_rows = [line.split("|") for line in j_report.dryrun_table(recs).splitlines()]
    assert len(t_rows) == len(j_rows)
    for t, j in zip(t_rows[2:], j_rows[2:]):
        assert [t[i] for i in (1, 2, 3, 5, 6)] == [j[i] for i in (1, 2, 3, 5, 6)]
        assert t[7].strip() == "-"


def test_the_report_prints_measured_steps_with_the_device(tmp_path, capsys):
    cfg = reduced(get_config("hymba-1.5b"))
    out = tmp_path / "single"
    for shape, L in (("prefill_32k", 32), ("decode_32k", 32)):
        t_dry.run_cell("hymba-1.5b", shape, "single", str(out), device="cpu", config=cfg,
                       seq_len=L)
    rec = t_dry.run_cell("dbrx-132b", "prefill_32k", "single", str(out), device="cpu")
    assert rec["measured"]["status"] == "too_large"
    recs = t_report.load(str(out))
    table = t_report.measured_table(recs).splitlines()
    assert len(table) == 2 + 3 and "too_large" in table[-1]
    fracs = [float(line.split("|")[6]) for line in table[2:4]]
    assert fracs == sorted(fracs)  # furthest below the bound first
    t_report.main(["--dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "measured on: cpu" in printed and "#### Measured batch-1 steps" in printed


def test_the_production_mesh_is_refused_on_one_device_and_1x1_works():
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} devices.*have 1.*A13"):
            t_mesh.make_production_mesh(multi_pod=multi, device="cpu")
    mesh = t_mesh.make_debug_mesh((1, 1), ("data", "model"), device="cpu")
    assert (mesh.shape, mesh.axis_names, mesh.size) == ((1, 1), ("data", "model"), 1)
    assert mesh.devices[0].type == "cpu"
    with pytest.raises(AssertionError):
        t_mesh.make_debug_mesh((2, 2), device="cpu")


def test_the_measured_bound_is_the_batch1_cost_at_the_h100_peaks():
    cell = t_dry.resolve_cell("tinyllama-1.1b", "train_4k")
    total, _ = t_dry.param_counts(cell.cfg, t_dry.meta_params(cell))
    cost = t_dry._cell_cost(cell, total, batch1=True)
    glob = t_dry._cell_cost(cell, total, batch1=False)
    assert cost.flops * 256 == glob.flops  # batch 1 of the global 256
    assert cost.notes == "accum=1 remat=True"
    assert max(cost.flops / t_rl.PEAK_FLOPS_BF16, cost.hbm_bytes / t_rl.HBM_BW) * 1e3 == \
        pytest.approx(40.389, abs=5e-4)
