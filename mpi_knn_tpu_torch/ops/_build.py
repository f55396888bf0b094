"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
under ``mpi_knn_tpu_torch/_build/<hash of the sources>/``, at first use.
Nothing is built when a module is imported, and a missing ``nvcc`` is an
error when a CUDA tensor needs a kernel: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("fused_knn",)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "mpi_knn_tpu_torch are built from csrc/ at first use"
    )


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless already built; returns nvcc's
    output, or "cached"."""
    out = _lib_path(name)
    if out.exists():
        return "cached"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return log


def build_all() -> dict:
    """Build every kernel source. Returns {name: {"seconds": s, "log": nvcc
    output or "cached"}}."""
    info = {}
    for name in SOURCES:
        t0 = time.perf_counter()
        log = build(name)
        info[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return info


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    build(name)
    return ctypes.CDLL(str(_lib_path(name)))
