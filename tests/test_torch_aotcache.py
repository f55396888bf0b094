"""The port's persistent cache of kernel libraries (``serve/aotcache.py``
with ``ops/_build.py``) and the session's warm surface, on the CPU, the
reference's contracts (``tests/test_aot_cache.py``) with stand-in bytes in
place of a library.

There is no nvcc here: a stand-in build writes seeded bytes where nvcc
would write the library, and ``ctypes.CDLL`` records the path it is given,
so everything between the two (the key, the entry's checks, the loud
fallback, the stores, the counts of builds, hits and misses) runs as on a
card. ``tests/test_torch_cuda.py`` restarts processes against a real cache
on the card, and the JAX package's ``AOTCache`` has the same activation
contract (``set_cache_dir``, ``TKNN_AOT_CACHE``, ``reset_for_tests``).

- the key: every axis (source, header, defines, each platform fact)
  changes it; an entry verifies its magic, format, key, length and
  checksum;
- a damaged entry falls back to a real build loudly and is overwritten; a
  failed store is not fatal; concurrent writers race benignly; a cache
  that is off touches nothing; the env var turns it on;
- a warm start loads every library from the cache with zero nvcc builds;
- ``warm`` dedupes identical rungs, builds in parallel bit for bit,
  publishes its progress, and two threads build one entry once.
"""

import threading
import time

import numpy as np
import pytest

from mpi_knn_tpu.serve import aotcache as jaot
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch.obs.metrics import get_registry, watch_compiles
from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.resilience import ResiliencePolicy
from mpi_knn_tpu_torch.serve import ServeSession, aotcache, build_index, engine

CPU = "cpu"
PLATFORM = {"device": "NVIDIA H100 80GB HBM3", "capability": [9, 0],
            "cuda": "12.8", "nvcc": "Build cuda_12.8.r12.8", "torch": "2.11.0",
            "format": aotcache.FORMAT_VERSION}


@pytest.fixture(autouse=True)
def _isolated_cache(monkeypatch):
    """Every test starts with no process-level cache and leaves none."""
    monkeypatch.delenv(aotcache.ENV_VAR, raising=False)
    aotcache.reset_for_tests()
    yield
    aotcache.reset_for_tests()


def _count(name: str) -> float:
    return get_registry().counter(name).value


class _FakeNvcc:
    """A finished build's process: ``_finish`` polls it as it polls nvcc."""

    returncode = 0

    def communicate(self, timeout=None):
        return "stand-in build", None


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """Stand-in nvcc (seeded bytes per library) and ``ctypes.CDLL``; the
    build root under tmp_path; the process's loaded libraries forgotten.
    Returns the list of paths loaded, in order."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(aotcache, "platform_facts", lambda: dict(PLATFORM))
    loaded = []

    def start(name, defines=(), out=None):
        out = _build._lib_path(name, defines) if out is None else out
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".stand-in.tmp")
        tmp.write_bytes(_payload(name, defines))
        return _FakeNvcc(), tmp, out, time.perf_counter()

    def cdll(path):
        loaded.append(str(path))
        return str(path)

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    return loaded


def _payload(name, defines=()) -> bytes:
    return (f"\x7fELF stand-in {name} {' '.join(defines)} ".encode()
            * 64)


# ---------------------------------------------------------------------------
# the key and the entry


def test_the_key_changes_on_every_axis(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fused_knn.cu").write_text("kernel v1")
    (csrc / "knn_tile.cuh").write_text("header v1")
    monkeypatch.setattr(_build, "CSRC", csrc)
    base = aotcache.fingerprint("fused_knn", (), PLATFORM)
    assert base == aotcache.fingerprint("fused_knn", (), dict(PLATFORM))
    keys = {base}
    for fact, value in (("device", "NVIDIA A100"), ("capability", [8, 0]),
                        ("cuda", "12.4"), ("nvcc", "Build cuda_12.4"),
                        ("torch", "2.10.0"), ("format", 99)):
        keys.add(aotcache.fingerprint("fused_knn", (), {**PLATFORM, fact: value}))
    keys.add(aotcache.fingerprint("fused_knn", ("KNN_WGMMA_PROMOTE=1",), PLATFORM))
    (csrc / "knn_tile.cuh").write_text("header v2")
    keys.add(aotcache.fingerprint("fused_knn", (), PLATFORM))
    (csrc / "fused_knn.cu").write_text("kernel v2")
    keys.add(aotcache.fingerprint("fused_knn", (), PLATFORM))
    assert len(keys) == 10
    facts = aotcache.fingerprint_facts("fused_knn", (), PLATFORM)
    assert facts["build"] == _build.digest("fused_knn") and facts["platform"] == PLATFORM


@pytest.mark.parametrize("damage", ["corrupt", "truncate", "magic", "key",
                                    "format", "empty"])
def test_a_damaged_entry_is_a_loud_miss(tmp_path, damage):
    cache = aotcache.AOTCache(tmp_path / "c")
    key, payload = "ab" * 32, _payload("fused_knn")
    assert cache.store(key, payload, meta={"library": "fused_knn"})
    path = cache.entry_path(key)
    blob = bytearray(path.read_bytes())
    if damage == "corrupt":
        blob[-10] ^= 0xFF
    elif damage == "truncate":
        blob = blob[: len(blob) // 2]
    elif damage == "magic":
        blob[0] ^= 0xFF
    elif damage == "key":
        blob[12] = ord("z")
    elif damage == "format":
        blob[8] += 1
    else:
        blob = b""
    path.write_bytes(bytes(blob))
    errors0, hits0 = _count("aot_cache_errors_total"), _count("aot_cache_hits_total")
    with pytest.warns(RuntimeWarning, match="falling back to a real nvcc build"):
        assert cache.load(key) is None
    assert _count("aot_cache_errors_total") == errors0 + 1
    assert _count("aot_cache_hits_total") == hits0
    assert not (tmp_path / "c" / "lib").exists() or not any(
        (tmp_path / "c" / "lib").iterdir())  # nothing unverified written out


def test_a_verified_entry_is_written_out_by_its_content(tmp_path):
    cache = aotcache.AOTCache(tmp_path / "c")
    misses0 = _count("aot_cache_misses_total")
    assert cache.load("cd" * 32) is None
    assert _count("aot_cache_misses_total") == misses0 + 1
    payload = _payload("approx_topk")
    assert cache.store("cd" * 32, payload, meta={"x": 1})
    path = cache.load("cd" * 32)
    assert path.read_bytes() == payload and path.parent == tmp_path / "c" / "lib"
    assert aotcache.unpack_entry("cd" * 32, cache.entry_path("cd" * 32).read_bytes()) \
        == (payload, {"x": 1})
    assert cache.stats() == {"dir": str(tmp_path / "c"), "entries": 1,
                             "bytes": cache.entry_path("cd" * 32).stat().st_size}


def test_a_failed_store_is_not_fatal(tmp_path):
    cache = aotcache.AOTCache(tmp_path / "c")
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    cache.dir = blocker / "sub"  # every write now fails
    errors0 = _count("aot_cache_errors_total")
    with pytest.warns(RuntimeWarning, match="cannot store"):
        assert cache.store("ef" * 32, b"payload") is False
    assert _count("aot_cache_errors_total") == errors0 + 1


def test_concurrent_writers_race_benignly(tmp_path):
    cache = aotcache.AOTCache(tmp_path / "c")
    key, payload = "12" * 32, _payload("fused_ring") * 200
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        cache.store(key, payload))) for _ in range(6)]
    threads += [threading.Thread(target=lambda: cache.load(key)) for _ in range(6)]
    errors0 = _count("aot_cache_errors_total")
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results == [True] * 6
    assert _count("aot_cache_errors_total") == errors0
    assert cache.load(key).read_bytes() == payload
    assert cache.stats()["entries"] == 1
    assert not list((tmp_path / "c").glob("*.tmp")) and not list(
        (tmp_path / "c").glob(".*.tmp"))


def test_activation_equals_the_reference(tmp_path, monkeypatch):
    for mod in (aotcache, jaot):
        monkeypatch.delenv(mod.ENV_VAR, raising=False)
        mod.reset_for_tests()
        assert mod.active_cache() is None
        monkeypatch.setenv(mod.ENV_VAR, str(tmp_path / mod.__name__))
        mod.reset_for_tests()
        assert mod.active_cache().stats()["dir"] == str(tmp_path / mod.__name__)
        mod.set_cache_dir(None)  # an explicit disable beats the env var
        assert mod.active_cache() is None
        mod.reset_for_tests()
    assert aotcache.ENV_VAR == jaot.ENV_VAR
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv(aotcache.ENV_VAR, str(blocker / "sub"))
    aotcache.reset_for_tests()
    with pytest.warns(RuntimeWarning, match="caching disabled"):
        assert aotcache.active_cache() is None


# ---------------------------------------------------------------------------
# loading through the cache


JOBS = [(name, ()) for name in _build.SOURCES]


def test_a_cache_that_is_off_touches_nothing(tmp_path, fake_build):
    elsewhere = tmp_path / "not-a-cache"
    elsewhere.mkdir()
    counts0 = [_count(f"aot_cache_{k}_total") for k in ("hits", "misses", "stores")]
    with watch_compiles() as builds:
        _build.load_all(JOBS)
        _build.load("fused_knn")  # once per process
    assert builds == ["nvcc"] * 4
    assert fake_build == [str(_build._lib_path(n)) for n, _ in JOBS]
    assert [_count(f"aot_cache_{k}_total") for k in ("hits", "misses", "stores")] \
        == counts0
    assert not any(elsewhere.iterdir())


def test_a_warm_start_builds_nothing(tmp_path, fake_build, monkeypatch):
    aotcache.set_cache_dir(tmp_path / "c")
    misses0, stores0, hits0 = (_count(f"aot_cache_{k}_total")
                               for k in ("misses", "stores", "hits"))
    with watch_compiles() as builds:
        _build.load_all(JOBS)
    assert builds == ["nvcc"] * 4
    assert _count("aot_cache_misses_total") == misses0 + 4
    assert _count("aot_cache_stores_total") == stores0 + 4
    assert aotcache.active_cache().stats()["entries"] == 4
    assert not any((_build.BUILD_ROOT / "aot-scratch").iterdir())
    cold = list(fake_build)
    monkeypatch.setattr(_build, "_loaded", {})  # a restarted process
    with watch_compiles() as builds:
        _build.load_all(JOBS)
    assert builds == []
    assert _count("aot_cache_hits_total") == hits0 + 4
    assert fake_build[4:] == cold  # the same verified bytes, the same files
    for path, (name, d) in zip(fake_build[4:], JOBS):
        assert open(path, "rb").read() == _payload(name, d)


def test_a_damaged_entry_is_rebuilt_and_overwritten(tmp_path, fake_build,
                                                    monkeypatch):
    cache = aotcache.set_cache_dir(tmp_path / "c")
    _build.load_all(JOBS)
    key = aotcache.fingerprint("fused_ring", (), PLATFORM)
    entry = cache.entry_path(key)
    entry.write_bytes(entry.read_bytes()[:100])  # truncated
    monkeypatch.setattr(_build, "_loaded", {})
    errors0 = _count("aot_cache_errors_total")
    with pytest.warns(RuntimeWarning, match="falling back"):
        with watch_compiles() as builds:
            _build.load_all(JOBS)
    assert builds == ["nvcc"] and _count("aot_cache_errors_total") == errors0 + 1
    assert cache.load(key).read_bytes() == _payload("fused_ring")  # overwritten


def test_an_uncachable_build_still_loads(tmp_path, fake_build, monkeypatch):
    cache = aotcache.set_cache_dir(tmp_path / "c")
    blocker = tmp_path / "file"
    blocker.write_text("")
    cache.dir = blocker / "sub"
    with pytest.warns(RuntimeWarning) as warned:
        _build.load("approx_topk")
    said = " ".join(str(w.message) for w in warned)
    assert "unreadable entry file" in said and "cannot store" in said
    assert open(fake_build[-1], "rb").read() == _payload("approx_topk")


def test_probe_roundtrip_reuses_one_entry(tmp_path):
    cache = aotcache.AOTCache(tmp_path / "c")
    out = aotcache.probe_roundtrip(cache)
    assert out["store_ok"] and out["load_ok"] and out["bit_identical"]
    assert not out["had_entry"] and "dlopen_ok" not in out
    assert aotcache.probe_roundtrip(cache)["had_entry"]
    assert cache.stats()["entries"] == 1


# ---------------------------------------------------------------------------
# warm: dedupe, the pool, progress, one build per entry


def _corpus(seed=0, m=1536, d=24):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


def _index(X, **kw):
    return build_index(X, KNNConfig(k=5, query_bucket=64, backend="serial", **kw),
                       device=CPU)


def test_warm_dedupes_identical_rungs_before_building():
    index = _index(_corpus())
    sess = ServeSession(index, resilience=ResiliencePolicy(batch_deadline_s=10.0),
                        device=CPU)
    assert [lb for lb, _ in sess.ladder] == ["full", "mixed", "bucket/32"]
    with watch_compiles() as builds:
        rep = sess.warm([64])
    assert (rep["raw_cells"], rep["deduped"], rep["cells"]) == (3, 1, 2)
    assert rep["built"] == rep["cells"] == len(index._cache) == len(builds)


def test_parallel_warm_serves_bit_for_bit_a_sequential_one():
    X = _corpus()
    sizes, Q = [16, 64, 128, 256], X[:100]
    seq = ServeSession(_index(X), device=CPU)
    seq.warm(sizes, parallel=1)
    ref = list(seq.stream([Q]))[0]
    index = _index(X)
    par = ServeSession(index, device=CPU)
    progress = []
    rep = par.warm(sizes, parallel=4,
                   progress=lambda r, t, b: progress.append((r, t)))
    assert rep["built"] == rep["cells"] == len(index._cache) == 3
    assert sorted(progress) == [(1, 3), (2, 3), (3, 3)]
    out = list(par.stream([Q]))[0]
    assert np.array_equal(out.dists, ref.dists) and np.array_equal(out.ids, ref.ids)
    rep2 = par.warm(sizes, parallel=4)
    assert rep2["reused"] == rep2["cells"] and rep2["built"] == 0


def test_warm_state_bucket_ready_and_warm_async():
    sess = ServeSession(_index(_corpus()), device=CPU)
    assert not sess.bucket_ready(10)
    t = sess.warm_async([10])
    t.join(timeout=60)
    assert not t.is_alive()
    assert sess.bucket_ready(10) and sess.bucket_ready(64)
    assert not sess.bucket_ready(65)
    assert sess.warm_snapshot() == {"total": 1, "ready": 1, "done": True}
    assert sess.coalesced_ready(10, 64) and not sess.coalesced_ready(10, 65)


def test_two_threads_build_one_entry_once(monkeypatch):
    index = _index(_corpus(m=256))
    slow = engine._new_entry

    def slow_entry(*a):
        time.sleep(0.2)
        return slow(*a)

    monkeypatch.setattr(engine, "_new_entry", slow_entry)
    got = []
    with watch_compiles() as builds:
        threads = [threading.Thread(target=lambda: got.append(
            engine.get_executable(index, index.cfg, 64))) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert builds == ["entry"] and len(got) == 4
    assert all(e is got[0] for e in got)
