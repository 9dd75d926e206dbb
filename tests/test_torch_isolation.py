"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and no kernel wrapper
reads an environment variable (which could switch its kernel off)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
WRAPPERS = sorted((PORT / "kernels").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_the_port_has_the_files_it_is_checked_on():
    assert len(FILES) > 45
    assert {p.name for p in WRAPPERS} >= {"ops.py", "_build.py"}
    for kernel in ("grs", "flash_attention", "pack", "superstep", "ssm_scan"):
        assert PORT / "kernels" / kernel / "ops.py" in WRAPPERS, kernel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_repro_imports(path):
    bad = [n for n in _imported(ast.parse(path.read_text())) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_import_check_catches_what_it_should():
    src = ("import jax\nfrom repro.core import asd\nimport repro_torch.core\n"
           "import importlib\nimportlib.import_module('jax.numpy')\n")
    names = list(_imported(ast.parse(src)))
    assert [n for n in names if _forbidden(n)] == ["jax", "repro.core", "jax.numpy"]


def _env_lookups(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "environb"):
            yield node.attr
        if isinstance(node, ast.Name) and node.id in ("environ", "getenv"):
            yield node.id


@pytest.mark.parametrize("path", WRAPPERS, ids=lambda p: str(p.relative_to(ROOT)))
def test_kernel_wrappers_read_no_environment(path):
    found = list(_env_lookups(ast.parse(path.read_text())))
    assert not found, f"{path.relative_to(ROOT)} reads the environment: {found}"


TRAINER = sorted(p for part in ("data", "training", "checkpoint")
                 for p in (PORT / part).rglob("*.py"))


def test_the_trainer_modules_are_checked():
    names = {str(p.relative_to(PORT)) for p in TRAINER}
    assert names >= {"data/pipeline.py", "training/optimizer.py", "training/train_step.py",
                     "training/loop.py", "checkpoint/manager.py", "checkpoint/_msgpack.py"}
    assert set(TRAINER) <= set(FILES)


@pytest.mark.parametrize("path", TRAINER + [PORT / "weights.py", PORT / "pytree.py",
                                             PORT / "launch" / "train.py",
                                             ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_trainer_imports_no_jax_msgpack_or_repro(path):
    """The card's machine has no msgpack either: the checkpoint manifest goes
    through the port's own codec."""
    bad = [n for n in _imported(ast.parse(path.read_text()))
           if _forbidden(n) or n.split(".")[0] == "msgpack"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
