"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
under ``mpi_knn_tpu_torch/_build/<hash>/``, at first use; the hash covers
the source, every ``csrc/*.cuh`` header and the flags. Nothing is built
when a module is imported, and a missing ``nvcc`` is an error when a CUDA
tensor needs a kernel: there is no fallback.

With a persistent cache active (``serve/aotcache.py``: ``--cache-dir`` or
``TKNN_AOT_CACHE``), :func:`load` takes each library from the cache
instead: a verified entry is loaded without nvcc, and a missing or
damaged one is built by nvcc from these sources and stored.

Every nvcc build is counted in the metrics registry (``nvcc_builds_total``,
``nvcc_build_seconds``), and while one runs the process beats its
heartbeat between polls: under a supervisor a slow but live build keeps
the beats flowing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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
_POLL_S = 1.0  # seconds between heartbeats while nvcc runs


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


@functools.cache
def nvcc_version() -> str | None:
    """``nvcc --version``'s last line (the build), or None without nvcc."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[-1]


def _flags(defines=()) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def digest(name: str, defines=()) -> str:
    """sha256 over ``csrc/<name>.cu``, every ``csrc/*.cuh`` header and the
    flags: what one build of the library depends on in the repo."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return h.hexdigest()


def _lib_path(name: str, defines=()) -> Path:
    return BUILD_ROOT / digest(name, defines)[:16] / f"lib{name}.so"


def _start(name: str, defines=(), out: Path | None = None):
    """Start nvcc for ``csrc/<name>.cu`` (with the preprocessor
    ``defines``) into ``out`` (default: its ``_build`` path) unless ``out``
    exists: returns (process, temporary output, output, start time) or
    None."""
    out = _lib_path(name, defines) if out is None else out
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())


def _finish(name: str, started) -> str:
    """Wait for a build that ``_start`` began, beating the heartbeat between
    polls; returns nvcc's output, or "cached" when nothing was built."""
    from mpi_knn_tpu_torch.obs.metrics import record_compile
    from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat

    if started is None:
        return "cached"
    proc, tmp, out, t0 = started
    while True:
        try:
            log, _ = proc.communicate(timeout=_POLL_S)
            break
        except subprocess.TimeoutExpired:  # still building: show progress
            maybe_beat(f"nvcc {name}")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a loader sees all or nothing
    record_compile("nvcc", time.perf_counter() - t0)
    return log


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu`` unless already built."""
    return _finish(name, _start(name, defines))


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
        log = _finish(name, proc)
        label = name + "".join(f" -D{d}" for d in defines)
        info[label] = {"seconds": time.perf_counter() - t0, "log": log}
    return info


_load_lock = threading.Lock()
_loaded: dict = {}  # (name, defines) -> ctypes.CDLL, once per process


def load_all(jobs) -> list:
    """The loaded libraries of ``jobs`` ((name, defines) pairs), each built
    or taken from the persistent cache once per process; the nvcc builds
    they need run together."""
    from mpi_knn_tpu_torch.serve import aotcache

    jobs = [(name, tuple(defines)) for name, defines in jobs]
    with _load_lock:
        todo = list(dict.fromkeys(j for j in jobs if j not in _loaded))
        if todo:
            cache = aotcache.active_cache()
            if cache is None:
                started = [_start(*j) for j in todo]
                for (name, _), s in zip(todo, started):
                    _finish(name, s)
                paths = {j: _lib_path(*j) for j in todo}
            else:
                paths = cache.library_paths(todo)
            for j in todo:
                _loaded[j] = ctypes.CDLL(str(paths[j]))
        return [_loaded[j] for j in jobs]


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed; a
    measurement may ask for a build with preprocessor ``defines``."""
    return load_all([(name, defines)])[0]
