"""The rest of ``core/`` and of the package layout: the SL <-> OU-DDPM
reparametrization of paper Thm 9 against the JAX package's on a grid of
t and s (float32, within 1e-6 relative), ``repro_torch.core`` exporting
``repro.core``'s names, the kernel packages' exports, and the per-arch
config modules."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as j_core
import repro_torch.core as t_core
from repro.core import schedules as j_sch
from repro_torch.configs.archs import ARCHS
from repro_torch.core import schedules as t_sch

# names of repro.core whose modules the port has not ported (none now)
NOT_PORTED = ()
T = np.geomspace(1e-3, 1e3, 61).astype(np.float32)
S = np.linspace(0.01, 4.0, 41).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)


def test_the_reparametrization_matches_jax():
    _close(t_sch.ou_time_of_sl(torch.from_numpy(T)), j_sch.ou_time_of_sl(jnp.asarray(T)))
    _close(t_sch.sl_time_of_ou(torch.from_numpy(S)), j_sch.sl_time_of_ou(jnp.asarray(S)))
    x = np.random.default_rng(0).standard_normal((41, 3)).astype(np.float32)
    ty, tt = t_sch.sl_of_ddpm_state(torch.from_numpy(x), torch.from_numpy(S)[:, None])
    jy, jt = j_sch.sl_of_ddpm_state(jnp.asarray(x), jnp.asarray(S)[:, None])
    _close(ty, jy)
    _close(tt, jt)
    y = np.random.default_rng(1).standard_normal((61, 3)).astype(np.float32)
    tx, ts = t_sch.ddpm_of_sl_state(torch.from_numpy(y), torch.from_numpy(T)[:, None])
    jx, js = j_sch.ddpm_of_sl_state(jnp.asarray(y), jnp.asarray(T)[:, None])
    _close(tx, jx)
    _close(ts, js)


def test_the_reparametrization_round_trips_and_takes_numbers():
    s = t_sch.ou_time_of_sl(torch.from_numpy(T))
    np.testing.assert_allclose(t_sch.sl_time_of_ou(s).numpy(), T, rtol=1e-5)
    y = torch.randn(61, 3, generator=torch.Generator().manual_seed(2))
    x, s = t_sch.ddpm_of_sl_state(y, torch.from_numpy(T)[:, None])
    back, t = t_sch.sl_of_ddpm_state(x, s)
    np.testing.assert_allclose(back.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)
    assert t_sch.ou_time_of_sl(2.0).dtype == torch.float32
    np.testing.assert_allclose(float(t_sch.ou_time_of_sl(2.0)),
                               float(j_sch.ou_time_of_sl(2.0)), rtol=1e-6)


def test_core_exports_the_jax_packages_names():
    want = set(j_core.__all__) - set(NOT_PORTED)
    assert set(t_core.__all__) == want
    for name in want:
        # the registries (dicts) have no module of their own
        home = getattr(getattr(t_core, name), "__module__", "repro_torch.")
        assert home.startswith("repro_torch."), name


@pytest.mark.parametrize("package,names", [
    ("repro_torch.kernels.pack", ("gather_rows", "scatter_rows")),
    ("repro_torch.kernels.superstep", ("fused_gather", "fused_verify_commit"))])
def test_the_kernel_packages_export_their_wrappers(package, names):
    mod = importlib.import_module(package)
    ops = importlib.import_module(package + ".ops")
    assert tuple(mod.__all__) == names
    for name in names:
        assert getattr(mod, name) is getattr(ops, name)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_ported_arch_has_its_module(name):
    mod = importlib.import_module("repro_torch.configs." + name.replace("-", "_")
                                  .replace(".", "_"))
    assert mod.CONFIG == ARCHS[name]()


def test_every_module_of_the_port_imports_first():
    """Each module of the port imported first in a clean interpreter (the
    package's modules dropped from ``sys.modules`` between them): no import
    cycle, whichever module a caller imports first."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
                  for p in (root / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
            "        del sys.modules[k]\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.argv))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-2000:]
