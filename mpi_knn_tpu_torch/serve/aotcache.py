"""Persistent on-disk cache of the compiled kernels: a restarted process
builds nothing it has built before (the JAX package's
``serve/aotcache.py``).

The reference persists XLA executables, one per (index, config, bucket)
cell. In the port the only compiled artifacts are the kernel libraries
nvcc builds from ``csrc/`` (``ops/_build.py``): the serving engine's
per-bucket entries are shapes and host buffers, built in milliseconds, and
nothing is compiled per bucket. So an entry here is one library: the
reference's per-cell key (``index_facts``, the cell's
``fingerprint_facts``, ``expect_args``) has no counterpart, and
:func:`fingerprint_facts` here describes one library build.

Keying: an entry is addressed by a sha256 over

- what ``ops/_build.digest`` hashes: the source, every ``csrc/*.cuh``
  header and the nvcc flags (preprocessor defines included);
- the platform facts (:func:`platform_facts`): the GPU's name and compute
  capability, the CUDA runtime torch was built for, the nvcc build,
  torch's version and this module's ``FORMAT_VERSION``.

Anything that could change the library or the card it runs on is in the
key, so a mismatched entry is simply never found.

Entry layout (one file ``<key>.tknnlib``): an 8-byte magic, the format,
the key, the payload's length and sha256, a JSON document of the facts
the key hashes (for a human or the doctor), then the payload, the
library's bytes. :meth:`AOTCache.load` verifies all of it before anything
is loaded: a truncated library that still loaded would crash at a launch,
not at load. A verified payload is written to ``lib/<key>-<sha>.so`` in
the cache directory, named by its content, and loaded from there, so a
handle always belongs to the bytes that were verified.

Damage: a stale, truncated or corrupt entry falls back to a real nvcc
build from the repo's sources, loudly: counted in
``aot_cache_errors_total``, warned on stderr, and the entry overwritten
by the fresh build. The fallback is the same kernel rebuilt, never its
plain version. A failed store is counted and warned, never fatal.

Concurrency: writers write a temp file in the cache directory and
``os.replace`` it into place (``utils/atomicio``), so readers see the old
entry or the new one, never a torn file, and several processes share one
directory without locks.

Activation is process-level: :func:`set_cache_dir` explicitly, the
``TKNN_AOT_CACHE`` env var ambiently, or ``--cache-dir`` on the query,
mutate and doctor CLIs. With no cache, ``ops/_build.py`` builds into
``_build/`` as it always did, and nothing is written to any cache
directory.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import struct
import threading
import warnings

from mpi_knn_tpu_torch.obs import metrics as obs_metrics
from mpi_knn_tpu_torch.utils.atomicio import atomic_write_bytes

# bump when the entry layout changes: old entries must miss, not half-load
FORMAT_VERSION = 1

MAGIC = b"TKNNLIB\x01"
ENTRY_SUFFIX = ".tknnlib"
ENV_VAR = "TKNN_AOT_CACHE"

# magic, format, key (64 hex), payload length, payload sha256, meta length
_HEADER = struct.Struct("<8sI64sQ32sI")


# ---------------------------------------------------------------------------
# Fingerprinting


def platform_facts() -> dict:
    """The process's half of the key: the card the library runs on and the
    toolchain that builds it."""
    import torch

    from mpi_knn_tpu_torch.ops import _build

    facts = {
        "device": None,
        "capability": None,
        "cuda": torch.version.cuda,
        "nvcc": _build.nvcc_version(),
        "torch": torch.__version__,
        "format": FORMAT_VERSION,
    }
    if torch.cuda.is_available():
        i = torch.cuda.current_device()
        facts["device"] = torch.cuda.get_device_name(i)
        facts["capability"] = list(torch.cuda.get_device_capability(i))
    return facts


def fingerprint_facts(name: str, defines=(), platform: dict | None = None) -> dict:
    """The key's preimage, stored in the entry: the library, the digest of
    its sources and flags, and the platform facts."""
    from mpi_knn_tpu_torch.ops import _build

    return {
        "library": name,
        "defines": list(defines),
        "build": _build.digest(name, defines),
        "platform": platform_facts() if platform is None else platform,
    }


def fingerprint(name: str, defines=(), platform: dict | None = None) -> str:
    """Content address of one library build on this platform."""
    doc = json.dumps(fingerprint_facts(name, defines, platform), sort_keys=True)
    return hashlib.sha256(doc.encode()).hexdigest()


# ---------------------------------------------------------------------------
# The cache


def _counter(name: str, help: str):  # noqa: A002 (registry convention)
    return obs_metrics.get_registry().counter(name, help=help)


def _count_hit():
    _counter("aot_cache_hits_total",
             "kernel libraries loaded from the persistent cache").inc()


def _count_miss():
    _counter("aot_cache_misses_total",
             "persistent cache lookups that found no entry").inc()


def _count_error():
    _counter(
        "aot_cache_errors_total",
        "stale/corrupt/unloadable cache entries that fell back to a real "
        "nvcc build, and failed stores (loud, never a wrong library)",
    ).inc()


def _count_store():
    _counter("aot_cache_stores_total",
             "kernel libraries stored into the persistent cache").inc()


def pack_entry(key: str, payload: bytes, meta: dict | None = None) -> bytes:
    """The bytes of one entry (see the module docstring)."""
    meta_b = json.dumps(meta or {}, sort_keys=True).encode()
    return _HEADER.pack(MAGIC, FORMAT_VERSION, key.encode(), len(payload),
                        hashlib.sha256(payload).digest(), len(meta_b)) \
        + meta_b + payload


def unpack_entry(key: str, blob: bytes) -> tuple[bytes, dict]:
    """(payload, meta) of an entry stored under ``key``; raises ValueError
    on anything that does not verify."""
    if len(blob) < _HEADER.size:
        raise ValueError(f"entry of {len(blob)} bytes is shorter than its header")
    magic, fmt, got_key, n, sha, n_meta = _HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise ValueError("bad magic number")
    if fmt != FORMAT_VERSION:
        raise ValueError(f"format {fmt} != {FORMAT_VERSION}")
    if got_key != key.encode():
        raise ValueError("entry key does not match its filename")
    if len(blob) != _HEADER.size + n_meta + n:
        raise ValueError(
            f"entry holds {len(blob)} bytes, its header says "
            f"{_HEADER.size + n_meta + n} (truncated or corrupt)")
    payload = blob[_HEADER.size + n_meta:]
    if hashlib.sha256(payload).digest() != sha:
        raise ValueError("payload checksum mismatch (corrupt entry)")
    return payload, json.loads(blob[_HEADER.size:_HEADER.size + n_meta])


class AOTCache:
    """One cache directory of content-addressed kernel libraries. Every
    read-side failure is a miss: counted and warned, never raised into the
    caller, which then builds for real."""

    def __init__(self, path: str | os.PathLike):
        self.dir = pathlib.Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)

    def entry_path(self, key: str) -> pathlib.Path:
        return self.dir / f"{key}{ENTRY_SUFFIX}"

    # -- read side --------------------------------------------------------

    def load(self, key: str) -> pathlib.Path | None:
        """The path of the verified library stored under ``key``, written
        out for loading, or None (a miss: absent, stale, corrupt or
        truncated entries all land here; only absence is silent)."""
        try:
            blob = self.entry_path(key).read_bytes()
        except FileNotFoundError:
            _count_miss()
            return None
        except OSError as e:
            _warn_bad(key, f"unreadable entry file: {e}")
            return None
        try:
            payload, _ = unpack_entry(key, blob)
            path = self._materialize(key, payload)
        except (ValueError, OSError) as e:
            _warn_bad(key, f"{type(e).__name__}: {e}")
            return None
        _count_hit()
        return path

    def _materialize(self, key: str, payload: bytes) -> pathlib.Path:
        """Write a verified payload where it is loaded from, named by its
        content."""
        sha = hashlib.sha256(payload).hexdigest()
        path = self.dir / "lib" / f"{key[:32]}-{sha[:16]}.so"
        path.parent.mkdir(exist_ok=True)
        atomic_write_bytes(path, payload)
        return path

    # -- write side -------------------------------------------------------

    def store(self, key: str, payload: bytes, meta: dict | None = None) -> bool:
        """Store ``payload`` under ``key`` by temp file + ``os.replace``
        (concurrent writers race benignly: the last full entry wins).
        Returns False, counted and warned, when the write fails: a broken
        cache must not take serving down with it."""
        try:
            atomic_write_bytes(self.entry_path(key), pack_entry(key, payload, meta))
        except OSError as e:
            _count_error()
            warnings.warn(
                f"aot cache: cannot store entry {key[:12]}…: "
                f"{type(e).__name__}: {e}", RuntimeWarning, stacklevel=2)
            return False
        _count_store()
        return True

    def library_paths(self, jobs) -> dict:
        """{(name, defines): path to load} for kernel library builds: each
        from its verified entry, or, for a miss, built by nvcc from the
        repo's sources (every miss's nvcc started together), stored, and
        loaded from where the cache wrote it (from the build's own output
        when the cache cannot take it)."""
        from mpi_knn_tpu_torch.ops import _build

        platform = platform_facts()
        paths, misses = {}, []
        for name, defines in jobs:
            key = fingerprint(name, defines, platform)
            path = self.load(key)
            if path is None:
                misses.append((name, defines, key))
            else:
                paths[(name, defines)] = path
        scratch = _build.BUILD_ROOT / "aot-scratch"
        outs = [scratch / f"{key[:16]}.{os.getpid()}.so" for _, _, key in misses]
        started = [_build._start(name, defines, out=out)
                   for (name, defines, _), out in zip(misses, outs)]
        for (name, defines, key), out, job in zip(misses, outs, started):
            _build._finish(name, job)
            payload = out.read_bytes()
            meta = fingerprint_facts(name, defines, platform)
            path = None
            if self.store(key, payload, meta):
                try:
                    path = self._materialize(key, payload)
                except OSError as e:
                    _warn_bad(key, f"cannot write it out: {e}")
            if path is None:
                path = out
            else:
                out.unlink()
            paths[(name, defines)] = path
        return paths

    # -- introspection ----------------------------------------------------

    def stats(self) -> dict:
        """{dir, entries, bytes}: the doctor verdict's cache block."""
        entries = 0
        nbytes = 0
        try:
            for p in self.dir.glob(f"*{ENTRY_SUFFIX}"):
                entries += 1
                nbytes += p.stat().st_size
        except OSError:
            pass
        return {"dir": str(self.dir), "entries": entries, "bytes": nbytes}


def _warn_bad(key: str, why: str) -> None:
    _count_error()
    warnings.warn(
        f"aot cache: entry {key[:12]}… is unusable ({why}); falling back "
        "to a real nvcc build and overwriting it",
        RuntimeWarning,
        stacklevel=3,
    )


# ---------------------------------------------------------------------------
# Process-level activation

_lock = threading.Lock()
_active: AOTCache | None = None
_configured = False  # set_cache_dir was called (None = explicit disable)


def set_cache_dir(path: str | os.PathLike | None) -> AOTCache | None:
    """Activate (or, with None, explicitly disable) the process-wide
    cache. Explicit configuration beats the ``TKNN_AOT_CACHE`` env var."""
    global _active, _configured
    with _lock:
        _active = AOTCache(path) if path is not None else None
        _configured = True
        return _active


def active_cache() -> AOTCache | None:
    """The process's cache, if any: the explicitly configured one, else
    one ambient from ``TKNN_AOT_CACHE``, else None (cache off: every load
    behaves as it does without this module).

    An unusable ambient directory (read-only mount, permission wall)
    disables the cache loudly instead of raising: this is called on the
    way to a kernel launch. Explicit :func:`set_cache_dir` still raises:
    a flag pointing nowhere is a usage error at startup."""
    global _active, _configured
    with _lock:
        if _configured:
            return _active
        env = os.environ.get(ENV_VAR)
        if env:
            try:
                _active = AOTCache(env)
            except OSError as e:
                _count_error()
                warnings.warn(
                    f"aot cache: {ENV_VAR}={env!r} is unusable "
                    f"({type(e).__name__}: {e}); caching disabled for "
                    "this process",
                    RuntimeWarning,
                    stacklevel=2,
                )
                _active = None
            _configured = True
            return _active
        return None


def reset_for_tests() -> None:
    """Forget process-level activation (tests change env and config)."""
    global _active, _configured
    with _lock:
        _active = None
        _configured = False


# ---------------------------------------------------------------------------
# Doctor probe


def probe_roundtrip(cache: AOTCache, library: str | os.PathLike | None = None) -> dict:
    """Store-then-load round trip through the production entry format: the
    doctor's evidence that this directory can keep and give back a
    library. The payload is ``library``'s bytes where the caller has a
    built one (then the library written back out is also loaded), else
    fixed stand-in bytes. The probe key is fixed, so repeated doctor runs
    overwrite one well-known entry instead of growing the cache."""
    import ctypes

    key = hashlib.sha256(json.dumps({"probe": FORMAT_VERSION}).encode()).hexdigest()
    had_entry = cache.entry_path(key).exists()
    payload = (pathlib.Path(library).read_bytes() if library is not None
               else bytes(range(256)) * 16)
    stored = cache.store(key, payload, meta={"probe": True})
    path = cache.load(key) if stored else None
    out = {
        "probe_key": key[:16],
        "had_entry": had_entry,
        "store_ok": stored,
        "load_ok": path is not None,
        "bit_identical": path is not None and path.read_bytes() == payload,
    }
    if library is not None:
        out["dlopen_ok"] = False
        if path is not None:
            ctypes.CDLL(str(path))
            out["dlopen_ok"] = True
    return out
