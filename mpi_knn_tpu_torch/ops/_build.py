"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
under ``mpi_knn_tpu_torch/_build/<hash>/``, at first use; the hash covers
the source, every ``csrc/*.cuh`` header and the flags. Nothing is built
when a module is imported, and a missing ``nvcc`` is an error when a CUDA
tensor needs a kernel: there is no fallback.
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
SOURCES = ("fused_knn", "fused_ring", "fused_ring_dma", "approx_topk")


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


def _flags(defines=()) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def _lib_path(name: str, defines=()) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def _start(name: str, defines=()):
    """Start nvcc for ``csrc/<name>.cu`` (with the preprocessor
    ``defines``) unless already built: returns (process, temporary output)
    or None."""
    out = _lib_path(name, defines)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, started, defines=()) -> str:
    """Wait for a build that ``_start`` began; returns nvcc's output, or
    "cached" when nothing was built."""
    if started is None:
        return "cached"
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, _lib_path(name, defines))  # atomic: a loader sees all or nothing
    return log


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu`` unless already built."""
    return _finish(name, _start(name, defines), defines)


def build_all(variants=()) -> dict:
    """Build every kernel source, and each (name, defines) measurement
    build of ``variants``, one nvcc process each, all started together.
    Returns {label: {"seconds": s, "log": nvcc output or "cached"}}, seconds
    counted from the common start; a variant's label carries its defines."""
    t0 = time.perf_counter()
    jobs = [(name, ()) for name in SOURCES] + [(n, tuple(d)) for n, d in variants]
    started = [_start(name, defines) for name, defines in jobs]
    info = {}
    for (name, defines), proc in zip(jobs, started):
        log = _finish(name, proc, defines)
        label = name + "".join(f" -D{d}" for d in defines)
        info[label] = {"seconds": time.perf_counter() - t0, "log": log}
    return info


@functools.cache
def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed; a
    measurement may ask for a build with preprocessor ``defines``."""
    build(name, defines)
    return ctypes.CDLL(str(_lib_path(name, defines)))
