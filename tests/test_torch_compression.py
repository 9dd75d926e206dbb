"""The int8 gradient all-reduce (``repro_torch.distributed.compression``)
against the JAX package's ``repro.distributed.compression``.

  * with no key / generator, ``qdq`` gives JAX's bits on one device (JAX
    run in the same subprocess as the rest), and
    ``int8_psum_tree`` over a two-rank ``pod`` group (and
    ``make_compressed_pod_allreduce`` on a 2x1x1 mesh of ranks) gives the
    bits JAX's ``int8_psum_tree`` gives inside a ``shard_map`` over two
    forced host devices, on every rank;
  * with a generator, the error of ``qdq`` and of the compressed mean is
    within one quantization step (the scale), and stochastic rounding is
    unbiased: over N draws the mean error of each element is within 6
    standard errors of 0 (a dithered rounding's error has variance at most
    1/4 of a step squared), where rounding to nearest keeps a fixed bias.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.distributed import compression as t_comp
from repro_torch.distributed.group import run_group

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"w": (16, 24), "b": (24,), "zeros": (3, 5), "tiny": (7,)}
DRAWS = 2000

_JAX_SCRIPT = r"""
import sys
import numpy as np, jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compression import int8_psum_tree, qdq, quantize_int8

flat = dict(np.load(sys.argv[1]))
tree = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("grads/")}
mesh = Mesh(np.asarray(jax.devices()[:2]), ("pod",))
fn = jax.jit(jax.shard_map(lambda g: int8_psum_tree(
    jax.tree_util.tree_map(lambda x: x[0], g), "pod"),
    mesh=mesh, in_specs=P("pod"), out_specs=P(), check_vma=False))
out = {k: np.asarray(v) for k, v in fn(tree).items()}
for k, v in flat.items():  # one device: qdq and quantize_int8 of one leaf
    if k.startswith("single/"):
        q, scale = quantize_int8(v)
        out[k + "/qdq"], out[k + "/q"] = np.asarray(qdq(v)), np.asarray(q)
        out[k + "/scale"] = np.asarray(scale)
np.savez(sys.argv[2], **out)
"""


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in SHAPES.items():
        x = rng.standard_normal((2,) + shape).astype(np.float32) * rng.uniform(0.01, 3.0)
        if name == "zeros":
            x[:] = 0
        if name == "tiny":
            x *= 1e-30  # subnormal scales
        out[f"grads/{name}"] = x
    return out


@pytest.fixture(scope="module")
def psums(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    inputs, out = str(tmp / "inputs.npz"), str(tmp / "jax.npz")
    flat = _grads()
    np.savez(inputs, **flat, **{f"single/{k.split('/')[1]}": v[0]
                                for k, v in _grads(1).items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, inputs, out], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        torch_out = run_group(ranks.compression_case, 2, "cpu", (inputs,))
    finally:
        err = proc.communicate(timeout=300)[1]
    assert proc.returncode == 0, err[-3000:]
    return dict(flat=flat, jax=dict(np.load(out)), ranks=torch_out)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_qdq_without_a_key_gives_jax_bits(psums, name):
    x = _grads(1)[f"grads/{name}"][0]
    jax_of = {k: psums["jax"][f"single/{name}/{k}"] for k in ("qdq", "q", "scale")}
    got = t_comp.qdq(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), jax_of["qdq"].view(np.int32))
    q, s = t_comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), jax_of["q"])
    assert float(s) == float(jax_of["scale"])


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("how", ["psum", "pod"])
def test_int8_psum_tree_gives_jax_bits_on_every_rank(psums, name, how):
    want = psums["jax"][name]
    for r in psums["ranks"]:
        assert np.array_equal(r[how][name].view(np.int32), want.view(np.int32)), r
    exact = psums["flat"][f"grads/{name}"].mean(axis=0)
    scale = max(np.abs(psums["flat"][f"grads/{name}"]).max() / 127, 1e-45)
    assert np.abs(want - exact).max() <= scale  # within one quantization step


def test_stochastic_psum_is_within_a_step_and_the_same_on_every_rank(psums):
    for name in SHAPES:
        got = [r["stochastic"][name] for r in psums["ranks"]]
        assert np.array_equal(got[0], got[1])
        x = psums["flat"][f"grads/{name}"]
        scale = max(np.abs(x).max() / 127, 1e-45)
        assert np.abs(got[0] - x.mean(axis=0)).max() <= scale


def test_stochastic_rounding_is_unbiased_by_law():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(64).astype(np.float32))
    x[0] = x.abs().max() * 0.3  # an element far from the grid
    scale = float(x.abs().max()) / 127
    gen = torch.Generator().manual_seed(11)
    draws = torch.stack([t_comp.qdq(x, gen) for _ in range(DRAWS)])
    err = (draws - x) / scale
    assert float(err.abs().max()) <= 1.0  # within one step
    bound = 6 * 0.5 / np.sqrt(DRAWS)  # 6 standard errors of a variance <= 1/4
    assert float(err.mean(0).abs().max()) <= bound
    # rounding to nearest keeps its error: the mean error is the error
    nearest = (t_comp.qdq(x) - x) / scale
    assert float(nearest.abs().max()) > bound
