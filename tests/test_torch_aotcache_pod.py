"""The kernel cache (``serve/aotcache.py``) shared by the processes of a
pod: two OS processes load every kernel library through one
``TKNN_AOT_CACHE`` directory at the same moment, with no lock between
them, as the cache's docstring says they may.

The file spawns itself as the worker (``TKNN_AOT_POD_WORKER``). A worker
stands in for nvcc and ``ctypes.CDLL`` as ``tests/test_torch_aotcache.py``
does (seeded bytes, 1 MiB a library, so a torn write would show), waits
for a start file so both begin together, loads every library, then races
the other worker storing and loading one entry, and writes what it saw.

- cold: both get every library's stand-in bytes, verified, from the
  shared directory; between them each library is built at least once
  and at most once a process; the race leaves no torn read (no load
  falls back) and no temp file;
- a damaged entry: each process that reads the damage rebuilds that one
  library once, loudly (a warning and ``aot_cache_errors_total``), and
  only that library; the entry afterwards holds the stand-in bytes, and a
  third process builds nothing.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER_ENV = "TKNN_AOT_POD_WORKER"
PLATFORM = {"device": "NVIDIA H100 80GB HBM3", "capability": [9, 0],
            "cuda": "12.8", "nvcc": "Build cuda_12.8.r12.8", "torch": "2.11.0",
            "format": 1}
RACE_ROUNDS = 20


def _payload(name, defines=()) -> bytes:
    unit = f"\x7fELF stand-in {name} {' '.join(defines)} ".encode()
    return unit * (2**20 // len(unit))


def _worker() -> int:
    import warnings

    sys.path.insert(0, str(REPO))
    from mpi_knn_tpu_torch.obs.metrics import get_registry, watch_compiles
    from mpi_knn_tpu_torch.ops import _build
    from mpi_knn_tpu_torch.serve import aotcache

    tmp = Path(os.environ["AOT_POD_DIR"])
    name = os.environ[WORKER_ENV]

    class FakeNvcc:
        returncode = 0

        def communicate(self, timeout=None):
            return "stand-in build", None

    def start(lib, defines=(), out=None):
        out = _build._lib_path(lib, defines) if out is None else out
        out.parent.mkdir(parents=True, exist_ok=True)
        part = out.with_suffix(f".{os.getpid()}.stand-in.tmp")
        part.write_bytes(_payload(lib, defines))
        return FakeNvcc(), part, out, time.perf_counter()

    loaded = []
    _build.BUILD_ROOT = tmp / f"build-{name}"
    _build._start = start
    _build.ctypes.CDLL = lambda path: loaded.append(str(path)) or str(path)
    aotcache.platform_facts = lambda: dict(PLATFORM)
    jobs = [(lib, ()) for lib in _build.SOURCES]
    reg = get_registry()

    def count(metric):
        return reg.counter(metric).value

    (tmp / f"ready-{name}").touch()
    while not (tmp / "go").exists():  # start together
        time.sleep(0.005)
    with warnings.catch_warnings(record=True) as warned, watch_compiles() as builds:
        warnings.simplefilter("always")
        _build.load_all(jobs)
        nvcc = list(builds)
        cache = aotcache.active_cache()
        key = aotcache.fingerprint("fused_knn", (), PLATFORM)
        race = []
        if os.environ.get("AOT_POD_RACE"):
            for _ in range(RACE_ROUNDS):
                cache.store(key, _payload("fused_knn"))
                got = cache.load(key)
                race.append(got is not None and got.read_bytes() == _payload("fused_knn"))
    out = {
        "builds": nvcc, "race_ok": race,
        "loaded": {lib: open(p, "rb").read() == _payload(lib)
                   for p, (lib, _) in zip(loaded, jobs)},
        "errors": count("aot_cache_errors_total"),
        "hits": count("aot_cache_hits_total"),
        "warnings": [str(w.message) for w in warned],
    }
    (tmp / f"{name}.json").write_text(json.dumps(out))
    return 0


def _run(tmp: Path, names, race=False) -> list:
    """Start one worker per name against the cache in ``tmp / "cache"``,
    release them together, and return what each saw."""
    for f in [tmp / "go", *tmp.glob("ready-*")]:
        f.unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("TKNN_")}
    env.update({"TKNN_AOT_CACHE": str(tmp / "cache"), "AOT_POD_DIR": str(tmp),
                **({"AOT_POD_RACE": "1"} if race else {})})
    procs = [subprocess.Popen([sys.executable, __file__], cwd=REPO,
                              env=dict(env, **{WORKER_ENV: n}),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for n in names]
    t0 = time.perf_counter()
    while not all((tmp / f"ready-{n}").exists() for n in names):
        if time.perf_counter() - t0 > 60 or any(p.poll() is not None for p in procs):
            break  # a worker that failed before the start shows below
        time.sleep(0.01)
    (tmp / "go").touch()  # every worker past its imports: release them
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a cache worker hung")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [json.loads((tmp / f"{n}.json").read_text()) for n in names]


def test_two_processes_share_one_cache_without_locks(tmp_path):
    from mpi_knn_tpu_torch.ops import _build
    from mpi_knn_tpu_torch.serve import aotcache

    libs = list(_build.SOURCES)
    a, b = _run(tmp_path, ["a", "b"], race=True)
    for got in (a, b):
        assert got["loaded"] == {lib: True for lib in libs}  # verified bytes
        assert got["race_ok"] == [True] * RACE_ROUNDS  # never a torn read
        assert got["errors"] == 0 and not got["warnings"]
        assert len(got["builds"]) <= len(libs)
    assert len(a["builds"]) + len(b["builds"]) >= len(libs)
    cache = aotcache.AOTCache(tmp_path / "cache")
    assert cache.stats()["entries"] == len(libs)
    assert not list((tmp_path / "cache").rglob("*.tmp"))

    # a damaged entry, read by two processes at once
    key = aotcache.fingerprint("fused_ring", (), PLATFORM)
    entry = cache.entry_path(key)
    entry.write_bytes(entry.read_bytes()[:4096])
    c, d = _run(tmp_path, ["c", "d"])
    rebuilt = 0
    for got in (c, d):
        assert got["loaded"] == {lib: True for lib in libs}
        assert got["builds"] in ([], ["nvcc"])  # that one library, once
        loud = [w for w in got["warnings"] if "falling back" in w]
        assert len(loud) == len(got["builds"]) == got["errors"]
        rebuilt += len(got["builds"])
    assert 1 <= rebuilt <= 2
    assert cache.load(key).read_bytes() == _payload("fused_ring")
    (e,) = _run(tmp_path, ["e"])
    assert e["builds"] == [] and e["errors"] == 0 and e["hits"] == len(libs)


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    sys.exit(_worker())
