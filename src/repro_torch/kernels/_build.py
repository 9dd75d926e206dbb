"""Build and load the port's CUDA kernel library at first use.

Every ``csrc/*.cu`` source (which may include the ``csrc/*.cuh`` headers)
is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build lives
in ``build/repro_torch/<hash of the sources and flags>/`` at the root of the
checkout, so a changed source builds anew and an unchanged one is reused.
Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_lib = None
# what the first build in this process did: seconds spent in nvcc (None when
# a cached library was loaded) and where the library is
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources: list[Path], out_dir: Path) -> None:
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        log = open(out_dir / (src.stem + ".log"), "w")
        procs.append((src, log, subprocess.Popen(
            [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            failed.append(src)
    if failed:
        text = "\n".join((out_dir / (s.stem + ".log")).read_text() for s in failed)
        raise RuntimeError(f"nvcc failed on {[s.name for s in failed]}:\n{text}")
    objs = [str(out_dir / (s.stem + ".o")) for s in sources]
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(out_dir / LIB_NAME), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stderr}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    if _lib is not None:
        return _lib
    sources = _sources()
    final = BUILD_ROOT / _digest(sources)
    seconds = None
    if not (final / LIB_NAME).exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
        try:
            _compile(sources, tmp)
            try:
                os.replace(tmp, final)
            except OSError:  # another process finished the same build first
                shutil.rmtree(tmp, ignore_errors=True)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(final / LIB_NAME))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=seconds, path=str(final / LIB_NAME))
    _lib = lib
    return lib


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry of the library with its signature declared."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
