"""The port's dry-run records (``repro_torch.launch.dryrun``) against the
JAX package's analytic arithmetic, for every (arch, shape) cell, the paper
ASD cells and a few variants, on both production meshes.

The JAX side runs in a subprocess: importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices (its lines 1-3), which would change
every later JAX test of this process.  It gives ``_param_counts`` over
``jax.eval_shape(lm_init)`` (and ``denoiser_init``) unboxed,
``analyze_cell`` at ``TRAIN_ACCUM`` and the config's remat, the ASD cells'
inline cost, and ``make_production_mesh()``'s shape and axis names; the
roofline terms are its arithmetic (``dryrun.py:386-397``) at the H100
constants.  Counts must be equal, floats within 1e-12 relative."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.registry import PAPER_MODELS, all_cells
from repro_torch.launch import dryrun as t_dry
from repro_torch.launch import mesh as t_mesh

ROOT = Path(__file__).resolve().parents[1]
VARIANT_CELLS = [("tinyllama-1.1b", "train_4k", "accum2"),
                 ("tinyllama-1.1b", "train_4k", "accum32"),
                 ("hymba-1.5b", "prefill_32k", "pad48"),
                 ("paper-pixel-dit", "asd", "memopt")]
CELLS = ([(arch, shape.name, "") for arch, shape, _ in all_cells()]
         + [(pm, "asd", "") for pm in PAPER_MODELS] + VARIANT_CELLS)

JAX_SIDE = r"""
import dataclasses, json, sys
import jax
from repro.launch import dryrun as jd
from repro.analysis import analytic as an
from repro.configs.base import ALL_SHAPES
from repro.configs.registry import PAPER_MODELS, get_config, get_denoiser_config
from repro.models import lm as lm_lib
from repro.models.diffusion import denoiser_init
from repro.nn.param import unbox

cells = json.loads(sys.argv[1])
out = {"mesh": {}, "cells": {}}
for multi in (False, True):
    m = jd.make_production_mesh(multi_pod=multi)
    out["mesh"]["multi" if multi else "single"] = [list(m.devices.shape),
                                                   list(m.axis_names), int(m.devices.size)]
counts = {}
for arch, shape_name, variant in cells:
    opts = dict(jd.VARIANTS[variant])
    rep = opts.pop("cfg_replace", None)
    if arch in PAPER_MODELS:
        dc = get_denoiser_config(arch)
        cfg, key = dc.backbone, (arch, None)
        init = lambda k: denoiser_init(k, dc)
    else:
        cfg = get_config(arch)
        if rep:
            cfg = dataclasses.replace(cfg, **rep)
        key = (arch, json.dumps(rep))
        init = lambda k: lm_lib.lm_init(k, cfg)
    if key not in counts:
        counts[key] = jd._param_counts(cfg, unbox(jax.eval_shape(init, jax.random.PRNGKey(0))))
    total, active = counts[key]
    if arch in PAPER_MODELS:  # build_asd_cell's sizes, run_cell's lines 373-381
        n_chains = opts.pop("n_chains", 64)
        if arch == "paper-diffusion-policy":
            n_chains = max(n_chains, 512)
        shape_tokens = n_chains * dc.seq_len
        nch = shape_tokens // dc.seq_len
        fwd = an.model_fwd_flops(cfg, dc.seq_len)
        cost = an.CellCost(
            flops=nch * 9 * fwd,
            hbm_bytes=total * 2 * 2 + nch * 9 * dc.seq_len * cfg.n_layers * cfg.d_model * 2 * 2,
            model_flops=2.0 * total * nch * 9 * dc.seq_len,
            notes=f"one ASD round (theta=8 +1 head), {nch} chains")
    else:
        shape = next(s for s in ALL_SHAPES if s.name == shape_name)
        shape_tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
                        else shape.global_batch)
        cost = an.analyze_cell(cfg, shape, total,
                               accum=opts.get("accum") or jd.TRAIN_ACCUM, remat=cfg.remat)
    out["cells"]["|".join((arch, shape_name, variant))] = dict(
        params_total=total, params_active=active, tokens=shape_tokens,
        analytic=cost.as_dict())
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(CELLS)], env=env,
                         capture_output=True, text=True, timeout=600, check=False)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch, shape, variant", CELLS)
def test_analytic_record_is_the_jax_dry_runs(jax_side, mesh, arch, shape, variant):
    want = jax_side["cells"]["|".join((arch, shape, variant))]
    shape_, axes, n_chips = jax_side["mesh"][mesh]
    got = t_dry.analytic_record(t_dry.resolve_cell(arch, shape, variant), mesh)
    assert (got["mesh_shape"], got["mesh_axes"], got["devices"]) == (shape_, axes, n_chips)
    for k in ("params_total", "params_active", "tokens"):
        assert got[k] == want[k], k
    cost = want["analytic"]
    assert got["analytic"]["notes"] == cost["notes"]
    for k in ("flops", "hbm_bytes", "model_flops"):
        assert _close(got["analytic"][k], cost[k]), k
    assert _close(got["model_flops"], cost["model_flops"])
    assert _close(got["useful_flops_ratio"], cost["model_flops"] / cost["flops"])
    # src/repro/launch/dryrun.py:386-397 at the H100 constants
    t_compute = cost["flops"] / n_chips / 989e12
    t_memory = cost["hbm_bytes"] / n_chips / 3.35e12
    terms = {"compute": t_compute, "memory": t_memory, "collective": 0.0}
    ro = got["roofline"]
    assert _close(ro["t_compute_s"], t_compute) and _close(ro["t_memory_s"], t_memory)
    assert ro["t_collective_s"] == 0.0
    assert ro["dominant"] == max(terms, key=terms.get)
    assert _close(ro["bound_s"], max(terms.values()))
    assert _close(ro["roofline_fraction"], t_compute / max(terms.values()))


def test_the_mesh_shapes_are_the_jax_ones(jax_side):
    for mesh, multi in (("single", False), ("multi", True)):
        shape, axes = t_mesh.production_mesh_shape(multi)
        assert [list(shape), list(axes)] == jax_side["mesh"][mesh][:2]
