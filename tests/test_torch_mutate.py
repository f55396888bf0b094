"""Live mutation in the port (``mpi_knn_tpu_torch/ivf/mutate.py``,
``serve/mutate.py``, ``serve/mutate_cli.py``, ``ServeSession.upsert`` /
``delete`` / ``compact`` / ``start_compactor``) against the JAX package's
``mpi_knn_tpu.ivf.mutate`` and ``mpi_knn_tpu.serve.mutate`` on the CPU, at
small sizes.

- the freelist from one id plane, and the upsert / delete plans, equal the
  JAX package's;
- a seeded sequence of upserts, deletes and in-place updates on a JAX index
  carried across (``convert.ivf_index_from_reference``) gives the same id
  plane, f32 rows and int8 / int4 codes and scales bit for bit, norms
  within 1e-6 relative, and the same answers (ids up to ties, distances
  within 1e-5 of the f64 distances to the stored rows); a compaction
  without retraining lays the store out as the JAX package's; a mutated
  index saved by either package loads in the other with the same freelist;
  the serial layout gets the same checks;
- in place: every store tensor keeps its storage, and re-upserting every
  live row under its own id with its own raw values leaves the store bit
  for bit unchanged; no scatter sees an index out of range;
- the reference's own contracts (``tests/test_mutation.py``), the
  refusals and the overflow errors with their partitions, a thread
  churning beside a depth-2 session, and the ``mutate`` CLI, whose lines
  equal the JAX CLI's on the same file and flags.

The hooks of ``resilience/`` and ``obs/`` (``test_compactor_defers_under_shed``,
``test_mutation_metrics_and_gauges``,
``test_compactor_thread_runs_and_flight_records``) are ported with the
JAX package beside them: the same mutations give the same counters and
gauges in both registries, and the port's flight record passes both
packages' validators.

Waiting for their slices (ROADMAP.md): the restart against a warm cache
(``test_zero_compiles_after_restart_with_warm_cache``: no kernel lies on
the mutation path, so the port's cache of kernel libraries has nothing to
restart there; ``tests/test_torch_aotcache.py`` holds the cache) and the
compile counts (``test_zero_compiles_under_sustained_ragged_churn``; the
doctor's mutation probe counts the builds of a second pass).

The reference's sharded-store cases (``test_s1_sharded_mutation_bit_identical``,
``test_sharded_mutation_and_compact``,
``test_4shard_build_with_tombstones_reloads_on_fewer_shards``) run on the
one-store sharded index and on a store whose slices lie apart (the layout
of a store over distinct cards), beside the JAX package's sharded mutation
on its virtual devices.
"""

import dataclasses
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpi_knn_tpu import KNNConfig as JaxConfig
from mpi_knn_tpu import ivf as jivf
from mpi_knn_tpu.ivf import mutate as jim
from mpi_knn_tpu.serve import build_index as jbuild_index
from mpi_knn_tpu.serve import mutate as jsm
from mpi_knn_tpu.serve import mutate_cli as jcli
from mpi_knn_tpu.serve.engine import query_knn as jquery_knn
from mpi_knn_tpu_torch import KNNConfig, build_index, query_knn
from mpi_knn_tpu_torch import cli as port_cli
from mpi_knn_tpu_torch.convert import ivf_index_from_reference
from mpi_knn_tpu_torch.ivf import build_ivf_index, load_ivf_index, save_ivf_index, search_ivf
from mpi_knn_tpu_torch.ivf import mutate as pim
from mpi_knn_tpu_torch.ivf.mutate import BucketOverflowError, Freelist, freelist_of, should_compact
from mpi_knn_tpu_torch.ops.quant import dequantize_rows
from mpi_knn_tpu_torch.serve import ServeSession
from mpi_knn_tpu_torch.serve import mutate as sm
from tests.oracle import recall_against_oracle

CPU = "cpu"
BASE = dict(k=5, partitions=8, nprobe=4, query_tile=32, query_bucket=32,
            mutation_bucket=32, dispatch_depth=1, kmeans_iters=8,
            bucket_headroom=0.5)
STORES = ("float32", "int8", "int4")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _blobs(rng, m=256, d=16, nc=8, scale=5.0):
    cents = rng.standard_normal((nc, d)).astype(np.float32) * scale
    assign = rng.integers(0, nc, m)
    X = (cents[assign] + rng.standard_normal((m, d))).astype(np.float32)
    return X, cents


def _ivf(X, **kw):
    return build_ivf_index(X, KNNConfig(**{**BASE, **kw}), device=CPU)


def _state(j) -> dict:
    """A JAX IVFIndex as the host values ``ivf_index_from_reference``
    takes."""
    return dict(
        cfg=dataclasses.asdict(j.cfg), m=j.m, dim=j.dim,
        partitions=j.partitions, bucket_cap=j.bucket_cap, nprobe=j.nprobe,
        tuned_recall=j.tuned_recall, mu=j.mu,
        centroids=np.asarray(j.centroids),
        centroid_sqs=np.asarray(j.centroid_sqs),
        buckets=np.asarray(j.buckets), bucket_ids=np.asarray(j.bucket_ids),
        bucket_sqs=np.asarray(j.bucket_sqs),
        bucket_scales=(None if j.bucket_scales is None
                       else np.asarray(j.bucket_scales)),
    )


def _pair(X, **kw):
    """A JAX clustered index and its carried copy in the port."""
    j = jivf.build_ivf_index(X, JaxConfig(**{**BASE, **kw}))
    return j, ivf_index_from_reference(_state(j), CPU)


def _store_np(p) -> dict:
    names = ("buckets", "bucket_ids", "bucket_sqs", "bucket_scales")
    return {n: getattr(p, n).numpy() for n in names if getattr(p, n) is not None}


def _assert_same_store(p, j):
    assert p.bucket_cap == j.bucket_cap
    assert np.array_equal(p.bucket_ids.numpy(), np.asarray(j.bucket_ids))
    assert np.array_equal(p.buckets.numpy(), np.asarray(j.buckets))
    if j.bucket_scales is not None:
        # within one ulp of the JAX package's jitted store, where XLA may
        # divide by QMAX as a reciprocal multiply; bit for bit its eager
        # quantizer (``_assert_eager_codes``), as test_torch_ivf holds it
        np.testing.assert_array_max_ulp(p.bucket_scales.numpy(),
                                        np.asarray(j.bucket_scales), maxulp=1)
    np.testing.assert_allclose(p.bucket_sqs.numpy(), np.asarray(j.bucket_sqs),
                               rtol=1e-6, atol=1e-6)


def _assert_eager_codes(p, ids, rows):
    """The codes and scales the port wrote for an upsert chunk equal the
    JAX package's eager ``quantize_rows`` of the same centered rows, bit
    for bit (the last of a repeated id)."""
    from mpi_knn_tpu.ops.quant import quantize_rows as jax_quantize

    last = dict(zip(np.asarray(ids).tolist(), np.asarray(rows)))
    centered = np.stack([(r - p.mu).astype(np.float32) for r in last.values()])
    codes, scales = (np.asarray(t) for t in jax_quantize(centered, dtype=p.cfg.dtype))
    fl = freelist_of(p)
    at = [fl.pos[i] for i in last]
    got = p.buckets.numpy()[tuple(np.array(at).T)]
    got_s = p.bucket_scales.numpy()[tuple(np.array(at).T)]
    assert np.array_equal(got, codes) and np.array_equal(got_s, scales)


def _rows_by_id(p) -> dict:
    """id -> the row as the index stores it (dequantized), f64, centered."""
    flat = p.buckets.reshape(-1, p.buckets.shape[-1])
    if p.bucket_scales is not None:
        flat = dequantize_rows(flat, p.bucket_scales.reshape(-1), p.cfg.dtype, p.dim)
    flat = flat.double().numpy()
    ids = p.bucket_ids.reshape(-1).numpy()
    return {int(i): flat[s] for s, i in enumerate(ids) if i >= 0}


def _assert_same_answers(p, j, Q, k=5):
    """Ids tie-aware against the JAX package's (>= 0.999); the port's
    distances within 1e-5 of the f64 distances to the rows as stored (ids
    may exceed m after upserts)."""
    gd, gi = (t.numpy() for t in search_ivf(p, Q, config=p.cfg.replace(k=k),
                                              device=CPU))
    wd, wi = (np.asarray(t) for t in jivf.search_ivf(j, Q, config=j.cfg.replace(k=k)))
    assert recall_against_oracle(gi, wd, wi, k) >= 0.999
    rows = _rows_by_id(p)
    qc = (np.asarray(Q, np.float64) - p.mu).astype(np.float32).astype(np.float64)
    valid = gi >= 0
    assert np.array_equal(valid, np.isfinite(gd))
    for r, c in zip(*np.nonzero(valid)):
        truth = ((qc[r] - rows[int(gi[r, c])]) ** 2).sum()
        np.testing.assert_allclose(gd[r, c], truth, rtol=1e-5, atol=1e-5)
    return gi


# ---------------------------------------------------------------------------
# The host half against the JAX package's


def _assert_same_freelist(a, b):
    assert a.free == b.free
    assert a.pos == b.pos
    assert a.stats() == b.stats()
    assert (a.total, a.cap, a.tombstones) == (b.total, b.cap, b.tombstones)


@pytest.mark.parametrize("headroom", [0.0, 0.5])
def test_freelist_from_one_id_plane_equals_jax(rng, headroom):
    X, _ = _blobs(rng)
    j, p = _pair(X, bucket_headroom=headroom)
    ids = np.asarray(j.bucket_ids).copy()
    ids[2, :5] = -1  # holes, as tombstones leave them
    _assert_same_freelist(Freelist(ids, 8), jim.Freelist(ids, 8))
    _assert_same_freelist(freelist_of(p), jim.freelist_of(j))


def test_plans_equal_jax(rng):
    X, _ = _blobs(rng)
    j, p = _pair(X)
    fa, fb = freelist_of(p), jim.freelist_of(j)
    ids = np.array([3, 4, 5000, 5001, 7, 5002], np.int32)
    parts = np.array([fb.pos[3][0], (fb.pos[4][0] + 1) % 8, 2, 2, 5, 0], np.int32)
    got, want = pim.plan_upsert(fa, ids, parts), jim.plan_upsert(fb, ids, parts)
    for a, b in zip(got[:4], want[:4]):
        assert np.array_equal(a, b)
    got[4]()
    want[4]()
    _assert_same_freelist(fa, fb)
    dels = np.array([3, 99999, 5001, 11], np.int32)
    got, want = pim.plan_delete(fa, dels), jim.plan_delete(fb, dels)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[3] == want[3] == 1
    got[2]()
    want[2]()
    _assert_same_freelist(fa, fb)


def test_overflow_names_the_partitions_as_jax(rng):
    X, _ = _blobs(rng)
    j, p = _pair(X, bucket_headroom=0.0)
    fa, fb = freelist_of(p), jim.freelist_of(j)
    full = int(np.argmin([len(f) for f in fb.free]))
    n = len(fb.free[full]) + 1
    ids = np.arange(9000, 9000 + n, dtype=np.int32)
    parts = np.full(n, full, np.int32)
    with pytest.raises(BucketOverflowError, match="headroom exhausted") as got:
        pim.plan_upsert(fa, ids, parts)
    with pytest.raises(jim.BucketOverflowError) as want:
        jim.plan_upsert(fb, ids, parts)
    assert got.value.partitions == tuple(want.value.partitions) == (full,)
    _assert_same_freelist(fa, fb)  # untouched


# ---------------------------------------------------------------------------
# A churn sequence against the JAX package's


def _churn_steps(rng, cents, m):
    """A seeded sequence: new ids, deletes (one unknown), in-place updates
    and moves with a repeated id, slots taken back, deletes again."""
    def near(n, scale=1.0):
        return (cents[rng.integers(0, len(cents), n)]
                + scale * rng.standard_normal((n, cents.shape[1]))).astype(np.float32)

    moved = near(12)
    moved[3] = moved[7]
    upd_ids = np.array([5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 6, 15])
    return [
        ("upsert", np.arange(1000, 1040), near(40)),
        ("delete", np.concatenate([np.arange(0, 30, 3), np.arange(1000, 1010),
                                   [m + 99999]]), None),
        ("upsert", upd_ids, moved),
        ("upsert", np.arange(2000, 2020), near(20)),
        ("delete", np.arange(2000, 2005), None),
        ("upsert", np.array([2001, 4000]), near(2)),
    ]


@pytest.mark.parametrize("dtype", STORES)
def test_churn_sequence_equals_jax(rng, dtype):
    X, cents = _blobs(rng, m=384)
    j, p = _pair(X, dtype=dtype)
    for kind, ids, rows in _churn_steps(rng, cents, len(X)):
        if kind == "upsert":
            got, want = sm.upsert_rows(p, ids, rows), jsm.upsert_rows(j, ids, rows)
            if dtype != "float32":
                _assert_eager_codes(p, ids, rows)
        else:
            got, want = sm.delete_rows(p, ids), jsm.delete_rows(j, ids)
        assert got == want, kind
        _assert_same_store(p, j)
        _assert_same_freelist(freelist_of(p), jim.freelist_of(j))
    assert p.live_rows == j.live_rows
    Q, _ = _blobs(np.random.default_rng(5), m=40)
    gi = _assert_same_answers(p, j, Q, k=8)
    # deleted and not upserted again (6..15 and 2001 came back)
    deleted = {0, 3, 18, 21, 24, 27} | set(range(1000, 1010)) | {2000, 2002, 2003, 2004}
    assert not deleted & set(gi.ravel().tolist())


@pytest.mark.parametrize("dtype", STORES)
def test_compact_without_retrain_lays_out_as_jax(rng, dtype):
    X, cents = _blobs(rng, m=384)
    j, p = _pair(X, dtype=dtype)
    for kind, ids, rows in _churn_steps(rng, cents, len(X)):
        if kind == "upsert":
            sm.upsert_rows(p, ids, rows)
            jsm.upsert_rows(j, ids, rows)
        else:
            sm.delete_rows(p, ids)
            jsm.delete_rows(j, ids)
    got = sm.compact_index(p, retrain=False, reason="test")
    want = jsm.compact_index(j, retrain=False, reason="test")
    got.pop("wall_s"), want.pop("wall_s")
    assert got == want
    _assert_same_store(p, j)
    _assert_same_freelist(freelist_of(p), jim.freelist_of(j))
    # a cap grown by min_cap, as the session's overflow backstop does
    cap = p.bucket_cap + 20
    got = sm.compact_index(p, retrain=False, min_cap=cap)
    want = jsm.compact_index(j, retrain=False, min_cap=cap)
    assert got["cap_after"] == want["cap_after"] > cap - 1
    _assert_same_store(p, j)
    Q, _ = _blobs(np.random.default_rng(6), m=40)
    _assert_same_answers(p, j, Q, k=8)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mutated_npz_crosses_packages(rng, tmp_path, writer):
    X, cents = _blobs(rng)
    j, p = _pair(X, dtype="int8")
    for kind, ids, rows in _churn_steps(rng, cents, len(X))[:3]:
        if kind == "upsert":
            sm.upsert_rows(p, ids, rows)
            jsm.upsert_rows(j, ids, rows)
        else:
            sm.delete_rows(p, ids)
            jsm.delete_rows(j, ids)
    path = str(tmp_path / "mut.npz")
    if writer == "port":
        save_ivf_index(p, path)
    else:
        jivf.save_ivf_index(j, path)
    # both freelists derived from the file's id plane
    back_j, back_p = jivf.load_ivf_index(path), load_ivf_index(path, device=CPU)
    a, b = freelist_of(back_p), jim.freelist_of(back_j)
    assert a.free == b.free and a.pos == b.pos and a.live == b.live
    _assert_same_store(back_p, back_j)
    Q, _ = _blobs(np.random.default_rng(7), m=24)
    _assert_same_answers(back_p, back_j, Q)
    # the reloaded index keeps mutating, as the JAX one does
    new = rng.standard_normal((3, 16)).astype(np.float32)
    assert (sm.upsert_rows(back_p, [5, 7777, 7778], new)
            == jsm.upsert_rows(back_j, [5, 7777, 7778], new))
    _assert_same_store(back_p, back_j)


def _serial_pair(X, **kw):
    cfg = {**dict(k=5, backend="serial", query_bucket=32, query_tile=32,
                  corpus_tile=64, mutation_bucket=32, exclude_zero=False,
                  bucket_headroom=0.5), **kw}
    return jbuild_index(X, JaxConfig(**cfg)), build_index(X, KNNConfig(**cfg),
                                                          device=CPU)


def test_serial_churn_equals_jax(rng):
    X, cents = _blobs(rng, m=200)
    j, p = _serial_pair(X)
    for kind, ids, rows in _churn_steps(rng, cents, len(X)):
        if kind == "upsert":
            got, want = sm.upsert_rows(p, ids, rows), jsm.upsert_rows(j, ids, rows)
        else:
            got, want = sm.delete_rows(p, ids), jsm.delete_rows(j, ids)
        assert got == want, kind
        assert np.array_equal(p.tile_ids.numpy(), np.asarray(j.tile_ids))
        assert np.array_equal(p.tiles.numpy(), np.asarray(j.tiles))
        np.testing.assert_allclose(p.tile_sqs.numpy(), np.asarray(j.tile_sqs),
                                   rtol=1e-6, atol=1e-6)
    assert p.live_rows == j.live_rows
    Q, _ = _blobs(np.random.default_rng(8), m=24)
    got = query_knn(Q, p, device=CPU, k=8)
    want = jquery_knn(Q, j, j.cfg.replace(k=8))
    assert recall_against_oracle(got.ids.numpy(), np.asarray(want.dists),
                                 np.asarray(want.ids), 8) >= 0.999
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-5, atol=1e-5)


def test_serial_overflow_equals_jax(rng):
    X, _ = _blobs(rng, m=64)
    j, p = _serial_pair(X, bucket_headroom=0.0)
    free = sum(len(f) for f in freelist_of(p).free)
    ids = np.arange(10**6, 10**6 + free + 1)
    rows = rng.standard_normal((free + 1, 16)).astype(np.float32)
    with pytest.raises(BucketOverflowError, match="tile stack is full") as got:
        sm.upsert_rows(p, ids, rows)
    with pytest.raises(jim.BucketOverflowError) as want:
        jsm.upsert_rows(j, ids, rows)
    assert str(got.value) == str(want.value)
    assert got.value.partitions == tuple(want.value.partitions) == ()


# ---------------------------------------------------------------------------
# In place


def _ptrs(index):
    return [t.data_ptr() for t in sm._store(index) if t is not None]


@pytest.mark.parametrize("dtype", STORES)
def test_reupsert_of_every_live_row_keeps_the_store_bit_for_bit(rng, dtype):
    X, _ = _blobs(rng, m=384)
    idx = _ivf(X, dtype=dtype)
    before = {n: a.copy() for n, a in _store_np(idx).items()}
    ptrs = _ptrs(idx)
    st = sm.upsert_rows(idx, np.arange(len(X)), X)
    assert st["upserted"] == len(X) and st["tombstones"] == 0
    for name, a in _store_np(idx).items():
        assert np.array_equal(a, before[name]), name
    assert _ptrs(idx) == ptrs


def test_serial_reupsert_keeps_the_tile_stack_bit_for_bit(rng):
    X, _ = _blobs(rng, m=200)
    _, p = _serial_pair(X)
    before = [t.clone() for t in sm._store(p)]
    sm.upsert_rows(p, np.arange(len(X)), X)
    assert all(torch.equal(a, b) for a, b in zip(sm._store(p), before))


@pytest.mark.parametrize("layout", ["ivf", "serial"])
def test_upsert_and_delete_write_in_place(rng, layout):
    X, cents = _blobs(rng)
    idx = _ivf(X) if layout == "ivf" else _serial_pair(X)[1]
    ptrs = _ptrs(idx)
    sm.upsert_rows(idx, np.arange(5000, 5020), rng.standard_normal((20, 16)))
    sm.delete_rows(idx, np.arange(5000, 5010))
    sm.upsert_rows(idx, [1, 2], X[[2, 1]])  # updates
    assert _ptrs(idx) == ptrs


def test_no_scatter_sees_a_sentinel(rng, monkeypatch):
    """Every index tensor that reaches a scatter lies inside the store."""
    X, cents = _blobs(rng)
    idx = _ivf(X)
    seen = []
    real = pim._kept

    def spy(part, slot, total):
        out = real(part, slot, total)
        if out is not None:
            seen.append((int(out[0].max()), int(out[0].min()), total))
        return out

    monkeypatch.setattr(sm, "_kept", spy)
    sm.upsert_rows(idx, np.arange(100, 140),
                   cents[rng.integers(0, 8, 40)] + rng.standard_normal((40, 16)))
    sm.delete_rows(idx, [1, 2, 77777])
    sm.upsert_rows(idx, [3], (cents[5] + 0.1)[None])
    assert seen and all(0 <= lo and hi < total for hi, lo, total in seen)


def test_compaction_swaps_in_a_fresh_store(rng):
    X, _ = _blobs(rng, m=384)
    idx = _ivf(X)
    sm.delete_rows(idx, np.arange(0, 100))
    old = _ptrs(idx)
    sm.compact_index(idx, retrain=False)
    assert not set(old) & set(_ptrs(idx))


# ---------------------------------------------------------------------------
# The reference's contracts (tests/test_mutation.py), on the port


def test_freelist_derivation_and_determinism():
    ids = np.full((3, 8), -1, np.int32)
    ids[0, :5] = [10, 11, 12, 13, 14]
    ids[2, 0] = 99
    fl = Freelist(ids, 3)
    assert fl.live == 6
    assert fl.pos[10] == (0, 0) and fl.pos[99] == (2, 0)
    assert fl.free[0][-1] == 5 and fl.free[1][-1] == 0
    assert fl.max_fill == 5 / 8
    assert fl.tombstones == 0


def test_freelist_headroom_reflects_build(rng):
    X, _ = _blobs(rng)
    idx = _ivf(X, bucket_headroom=0.5)
    fl = freelist_of(idx)
    assert fl.live == 256 and fl.max_fill < 1.0
    assert _ivf(X, bucket_headroom=0.0).bucket_cap < idx.bucket_cap


def test_upsert_then_query_finds_new_rows(rng):
    X, cents = _blobs(rng)
    idx = _ivf(X)
    new = (cents[3] + 0.01 * rng.standard_normal((8, 16))).astype(np.float32)
    ids = np.arange(1000, 1008)
    st = sm.upsert_rows(idx, ids, new)
    assert st["upserted"] == 8 and st["live"] == 264 and st["bucket"] == 32
    _, i = search_ivf(idx, new, config=idx.cfg.replace(k=5), device=CPU)
    assert set(ids.tolist()) & set(i[:, 0].tolist())
    assert idx.live_rows == 264 and idx.m == 256


def test_deleted_ids_are_never_returned(rng):
    X, cents = _blobs(rng)
    idx = _ivf(X)
    new = (cents[2] + 0.01 * rng.standard_normal((6, 16))).astype(np.float32)
    ids = np.arange(2000, 2006)
    sm.upsert_rows(idx, ids, new)
    st = sm.delete_rows(idx, ids[:4])
    assert st["deleted"] == 4 and st["tombstones"] == 4
    _, i = search_ivf(idx, new, config=idx.cfg.replace(k=10), device=CPU)
    assert not set(ids[:4].tolist()) & set(i.ravel().tolist())
    st = sm.delete_rows(idx, [2000, 2001, 777777])
    assert st["deleted"] == 0 and st["missing"] == 3


def test_upsert_existing_id_is_an_update(rng):
    X, cents = _blobs(rng)
    idx = _ivf(X)
    before = freelist_of(idx).live
    moved = (cents[7] + 0.01 * rng.standard_normal(16)).astype(np.float32)[None]
    sm.upsert_rows(idx, [3], moved)
    assert freelist_of(idx).live == before
    _, i = search_ivf(idx, moved + np.float32(0.1), config=idx.cfg.replace(k=3),
                      device=CPU)
    assert 3 in i[0].tolist()
    assert (idx.bucket_ids.numpy() == 3).sum() == 1


def test_upsert_dedupes_chunk_keeping_last(rng):
    X, cents = _blobs(rng)
    idx = _ivf(X)
    r1 = (cents[0] + 0.01 * rng.standard_normal(16)).astype(np.float32)
    r2 = (cents[5] + 0.01 * rng.standard_normal(16)).astype(np.float32)
    sm.upsert_rows(idx, [9000, 9000], np.stack([r1, r2]))
    assert (idx.bucket_ids.numpy() == 9000).sum() == 1
    _, i = search_ivf(idx, (r2 + np.float32(0.1))[None],
                      config=idx.cfg.replace(k=3), device=CPU)
    assert 9000 in i[0].tolist()


def test_upsert_validation(rng):
    X, _ = _blobs(rng)
    idx = _ivf(X)
    with pytest.raises(ValueError, match="must be >= 0"):
        sm.upsert_rows(idx, [-1], np.zeros((1, 16), np.float32))
    with pytest.raises(ValueError, match="ids but"):
        sm.upsert_rows(idx, [1, 2], np.zeros((1, 16), np.float32))
    with pytest.raises(ValueError, match=r"\(n, dim"):
        sm.upsert_rows(idx, [1], np.zeros((1, 8), np.float32))


@pytest.mark.parametrize("backend", ["pallas", "ring", "ring-overlap"])
def test_refusals_on_immutable_layouts(rng, backend):
    X, _ = _blobs(rng)
    idx = build_index(X, KNNConfig(backend=backend, query_bucket=32), device=CPU)
    for call in (lambda: sm.upsert_rows(idx, [1], np.zeros((1, 16), np.float32)),
                 lambda: sm.delete_rows(idx, [1]), lambda: sm.compact_index(idx),
                 lambda: sm.mutation_stats(idx),
                 lambda: ServeSession(idx, device=CPU).delete([1])):
        with pytest.raises(ValueError, match="cannot honor live mutation"):
            call()
    # the JAX package refuses the same layouts with the same words
    j = jbuild_index(X, JaxConfig(backend="pallas", query_bucket=32))
    with pytest.raises(ValueError, match="cannot honor live mutation"):
        jsm.delete_rows(j, [1])


def test_serial_has_no_compaction(rng):
    X, _ = _blobs(rng)
    sidx = build_index(X, KNNConfig(backend="serial", query_bucket=32), device=CPU)
    with pytest.raises(ValueError, match="no re-cluster pass"):
        sm.compact_index(sidx)
    with pytest.raises(ValueError, match="no compaction pass"):
        sm.Compactor(ServeSession(sidx, device=CPU))
    with pytest.raises(ValueError, match="does not track liveness"):
        build_index(X, KNNConfig(backend="pallas"), device=CPU).live_rows


def test_serial_upsert_delete_roundtrip(rng):
    X, _ = _blobs(rng, m=200)
    _, idx = _serial_pair(X)
    assert idx.live_rows == 200
    new = rng.standard_normal((9, 16)).astype(np.float32)
    sm.upsert_rows(idx, np.arange(7000, 7009), new)
    assert idx.live_rows == 209
    r = query_knn(new, idx, device=CPU)
    assert (r.ids[:, 0].numpy() == np.arange(7000, 7009)).all()
    sm.delete_rows(idx, np.arange(7000, 7005))
    r = query_knn(new[:5], idx, device=CPU, k=10)
    assert not set(range(7000, 7005)) & set(r.ids.ravel().tolist())
    assert idx.live_rows == 204


def test_serial_inplace_update_needs_no_headroom(rng):
    X, _ = _blobs(rng, m=64)
    idx = build_index(X, KNNConfig(backend="serial", query_bucket=16,
                                   corpus_tile=64, bucket_headroom=0.0,
                                   mutation_bucket=16, exclude_zero=False),
                      device=CPU)
    assert sum(len(f) for f in freelist_of(idx).free) == 0
    moved = (X[:4] + 0.5).astype(np.float32)
    st = sm.upsert_rows(idx, np.arange(4), moved)
    assert st["upserted"] == 4 and st["live"] == 64 and st["bucket"] == 16
    r = query_knn(moved, idx, device=CPU, k=1)
    assert (r.ids[:, 0].numpy() == np.arange(4)).all()


def test_session_overflow_propagates_on_serial(rng):
    X, _ = _blobs(rng, m=64)
    idx = build_index(X, KNNConfig(backend="serial", query_bucket=16,
                                   corpus_tile=64, bucket_headroom=0.0),
                      device=CPU)
    with pytest.raises(BucketOverflowError, match="tile stack is full"):
        ServeSession(idx, device=CPU).upsert(np.arange(10**6, 10**6 + 200),
                                             rng.standard_normal((200, 16)))


def test_post_churn_recall_matches_fresh_rebuild(rng):
    X, cents = _blobs(rng, m=512)
    idx = _ivf(X)
    dead = np.arange(0, 512, 3)
    sm.delete_rows(idx, dead)
    repl = (cents[rng.integers(0, 8, 128)]
            + rng.standard_normal((128, 16))).astype(np.float32)
    rid = np.arange(10000, 10128)
    sm.upsert_rows(idx, rid, repl)
    live_ids = np.array(sorted(freelist_of(idx).pos))
    rows_by_id = {int(i): X[i] for i in range(512) if i not in set(dead)}
    rows_by_id.update({int(i): r for i, r in zip(rid, repl)})
    live_rows = np.stack([rows_by_id[int(i)] for i in live_ids])
    sm.compact_index(idx, reason="post-churn")
    fresh = build_ivf_index(live_rows, idx.cfg.replace(nprobe=4), device=CPU)
    Q = (cents[rng.integers(0, 8, 64)]
         + rng.standard_normal((64, 16))).astype(np.float32)
    k = 10
    _, got_mut = search_ivf(idx, Q, config=idx.cfg.replace(k=k, nprobe=4), device=CPU)
    _, got_fresh = search_ivf(fresh, Q, config=fresh.cfg.replace(k=k, nprobe=4),
                              device=CPU)
    id_of_pos = {p: int(i) for p, i in enumerate(live_ids)}
    got_fresh_ids = np.vectorize(lambda p: id_of_pos.get(int(p), -1))(got_fresh.numpy())
    X64, Q64 = live_rows.astype(np.float64), Q.astype(np.float64)
    od = (Q64 ** 2).sum(1)[:, None] + (X64 ** 2).sum(1)[None, :] - 2.0 * Q64 @ X64.T
    wider = np.argsort(od, axis=1, kind="stable")[:, :4 * k]
    wide_ids = np.vectorize(lambda p: id_of_pos[int(p)])(wider)
    wide_dists = np.take_along_axis(od, wider, 1)
    r_mut = recall_against_oracle(got_mut.numpy(), wide_dists, wide_ids, k)
    r_fresh = recall_against_oracle(got_fresh_ids, wide_dists, wide_ids, k)
    assert r_mut >= r_fresh - 0.02, (r_mut, r_fresh)


def test_compact_triggers_and_reclaims(rng):
    X, _ = _blobs(rng, m=512)
    idx = _ivf(X, compact_tombstone_fraction=0.2)
    assert should_compact(idx, idx.cfg) is None
    sm.delete_rows(idx, np.arange(0, 200))
    assert should_compact(idx, idx.cfg) == "tombstones"
    st = sm.compact_index(idx, reason="tombstones")
    assert st["live"] == 312 and st["retrained"] and st["reason"] == "tombstones"
    assert freelist_of(idx).tombstones == 0
    assert should_compact(idx, idx.cfg) is None
    assert st["cap_before"] == st["cap_after"]


def test_fill_trigger(rng):
    X, cents = _blobs(rng)
    idx = _ivf(X, compact_fill_threshold=0.5)
    assert should_compact(idx, idx.cfg) == "fill"
    assert should_compact(idx, idx.cfg.replace(compact_fill_threshold=1.0)) is None


def test_compact_preserves_answers(rng):
    X, cents = _blobs(rng, m=512)
    idx = _ivf(X, nprobe=8)
    Q = (cents[rng.integers(0, 8, 32)]
         + rng.standard_normal((32, 16))).astype(np.float32)
    sm.delete_rows(idx, np.arange(100, 150))
    d0, i0 = search_ivf(idx, Q, config=idx.cfg.replace(k=5), device=CPU)
    sm.compact_index(idx, retrain=True)
    d1, i1 = search_ivf(idx, Q, config=idx.cfg.replace(k=5), device=CPU)
    assert torch.equal(i0, i1)
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), rtol=1e-5, atol=1e-4)


def test_compaction_with_retrain_is_deterministic(rng):
    X, _ = _blobs(rng, m=384)
    a, b = _ivf(X), _ivf(X)
    for idx in (a, b):
        sm.delete_rows(idx, np.arange(0, 384, 4))
        sm.compact_index(idx, retrain=True)
    for x, y in zip(sm._store(a)[:3], sm._store(b)[:3]):
        assert torch.equal(x, y)
    assert torch.equal(a.centroids, b.centroids)


def test_cap_growth_clears_the_engine_entries(rng):
    X, _ = _blobs(rng)
    idx = _ivf(X)
    ses = ServeSession(idx, device=CPU)
    ses.warm([20])
    assert idx._cache
    sm.compact_index(idx, retrain=False)  # cap kept: entries kept
    assert idx._cache
    st = sm.compact_index(idx, retrain=False, min_cap=idx.bucket_cap + 40)
    assert st["cap_after"] > st["cap_before"] and not idx._cache
    Q = rng.standard_normal((20, 16)).astype(np.float32)
    got = [r.ids for r in ses.stream([Q])]
    assert np.array_equal(got[0], search_ivf(idx, Q, device=CPU)[1].numpy())


def test_session_overflow_compacts_and_retries(rng):
    X, _ = _blobs(rng)
    idx = _ivf(X, bucket_headroom=0.1)
    ses = ServeSession(idx, device=CPU)
    burst = (np.ones((1, 16)) * 3.0
             + 0.01 * rng.standard_normal((200, 16))).astype(np.float32)
    st = ses.upsert(np.arange(40000, 40200), burst)
    assert st["upserted"] == 200
    assert ses.stats_snapshot()["mutation"]["compactions"] >= 1
    _, i = search_ivf(idx, burst[:4], config=idx.cfg.replace(k=3), device=CPU)
    assert set(i[:, 0].tolist()) <= set(range(40000, 40200))


def test_compactor_tick_compacts_on_trigger(rng):
    X, _ = _blobs(rng, m=512)
    idx = _ivf(X, compact_tombstone_fraction=0.1)
    ses = ServeSession(idx, device=CPU)
    comp = ses.start_compactor(interval_s=3600)  # tick by hand
    try:
        assert comp.tick() is None
        sm.delete_rows(idx, np.arange(0, 200))
        st = comp.tick()
        assert st is not None and st["reason"] == "tombstones"
        snap = comp.snapshot()
        assert snap["compactions"] == 1 and snap["deferred"] == 0
        assert snap["last"] == st
        assert comp.tick(force_reason="manual")["reason"] == "manual"
    finally:
        comp.stop()
    assert not comp._thread.is_alive()


def test_compactor_thread_runs(rng):
    X, _ = _blobs(rng, m=512)
    idx = _ivf(X, compact_tombstone_fraction=0.1)
    ses = ServeSession(idx, device=CPU)
    comp = ses.start_compactor(interval_s=0.02)
    try:
        sm.delete_rows(idx, np.arange(0, 200))
        deadline = time.time() + 30
        while comp.snapshot()["compactions"] == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert comp.snapshot()["compactions"] >= 1
    finally:
        comp.stop(timeout=30)
    assert not comp._thread.is_alive()
    assert freelist_of(idx).tombstones == 0 and idx.live_rows == 312


def test_mutated_index_roundtrips_bit_identically(rng, tmp_path):
    X, cents = _blobs(rng)
    idx = _ivf(X)
    sm.upsert_rows(idx, np.arange(1000, 1032),
                   (cents[rng.integers(0, 8, 32)]
                    + rng.standard_normal((32, 16))).astype(np.float32))
    sm.delete_rows(idx, np.arange(0, 40))
    path = save_ivf_index(idx, str(tmp_path / "mut.npz"))
    back = load_ivf_index(path, device=CPU)
    for name in ("buckets", "bucket_ids", "bucket_sqs", "centroids", "centroid_sqs"):
        assert torch.equal(getattr(idx, name), getattr(back, name)), name
    fa, fb = freelist_of(idx), freelist_of(back)
    assert fa.live == fb.live
    assert [sorted(f) for f in fa.free] == [sorted(f) for f in fb.free]
    sm.upsert_rows(back, [5], rng.standard_normal((1, 16)).astype(np.float32))
    assert back.live_rows == fa.live + (0 if 5 in fa.pos else 1)


def test_legacy_pre_mutation_artifact_loads_with_headroom(rng, tmp_path):
    X, _ = _blobs(rng)
    path = save_ivf_index(_ivf(X), str(tmp_path / "legacy.npz"))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"]).decode())
    meta.pop("live_rows")
    for key in ("bucket_headroom", "mutation_bucket",
                "compact_fill_threshold", "compact_tombstone_fraction"):
        meta["cfg"].pop(key)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    legacy = str(tmp_path / "legacy2.npz")
    with open(legacy, "wb") as f:
        np.savez(f, **arrays)
    back = load_ivf_index(legacy, device=CPU)
    fl = freelist_of(back)
    assert fl.live == 256
    assert sum(len(f) for f in fl.free) == back.partitions * back.bucket_cap - 256
    sm.upsert_rows(back, [7777], rng.standard_normal((1, 16)).astype(np.float32))
    assert back.live_rows == 257


def test_upsert_beats_rebuild_per_batch_10x(rng):
    X, cents = _blobs(rng, m=1024, d=32)
    cfg = KNNConfig(k=5, partitions=16, nprobe=4, query_tile=64,
                    mutation_bucket=64, bucket_headroom=0.5)
    idx = build_ivf_index(X, cfg, device=CPU)
    B = 64
    rows = (cents[rng.integers(0, 8, B)] + rng.standard_normal((B, 32))).astype(np.float32)
    sm.upsert_rows(idx, np.arange(50000, 50000 + B), rows)  # warm
    sm.delete_rows(idx, np.arange(50000, 50000 + B))
    reps = 5
    t0 = time.perf_counter()
    for j in range(reps):
        base = 60000 + j * B
        sm.upsert_rows(idx, np.arange(base, base + B), rows)
        sm.delete_rows(idx, np.arange(base, base + B))
    upsert_s = (time.perf_counter() - t0) / (2 * reps)
    t0 = time.perf_counter()
    build_ivf_index(X, cfg, device=CPU)
    rebuild_s = time.perf_counter() - t0
    assert rebuild_s > 10 * upsert_s, (upsert_s, rebuild_s)


def test_mutation_stats_reset_contract(rng):
    X, _ = _blobs(rng)
    ses = ServeSession(_ivf(X), device=CPU)
    ses.upsert(np.arange(8100, 8104), rng.standard_normal((4, 16)).astype(np.float32))
    ses.delete([8100, 123456], tenant="alice")
    assert ses.stats_snapshot()["mutation"] == {
        "upserts": 4, "deletes": 1, "calls": 2, "compactions": 0}
    ses.reset_stats()
    assert ses.stats_snapshot()["mutation"]["upserts"] == 0
    assert ses.index.live_rows == 259
    assert sm.mutation_stats(ses.index)["live"] == 259


def test_mutation_interleaves_with_dispatch_depth(rng):
    """Mutations between submits at dispatch_depth > 1: in-flight batches
    retire against the store they were dispatched on; every answer equals
    the one-shot search of the store at its dispatch."""
    X, cents = _blobs(rng, m=384)
    idx = _ivf(X, dispatch_depth=3)
    ses = ServeSession(idx, device=CPU)
    ses.warm([20])
    Q = (cents[rng.integers(0, 8, 20)] + rng.standard_normal((20, 16))).astype(np.float32)
    done, want = [], []
    for j in range(6):
        want.append(search_ivf(idx, Q, device=CPU)[1].numpy())
        done += ses.submit(Q)
        ses.upsert(np.arange(70000 + j * 10, 70000 + j * 10 + 10),
                   (cents[j % 8] + 0.01 * rng.standard_normal((10, 16))).astype(np.float32))
        ses.delete(np.arange(70000 + j * 10, 70000 + j * 10 + 5))
    done += ses.drain()
    assert len(done) == 6
    for res, w in zip(done, want):
        assert np.isfinite(res.dists).all()
        assert np.array_equal(res.ids, w)


def test_a_churning_thread_beside_a_depth_2_session(rng):
    """A thread upserts and deletes while the main thread streams batches:
    every batch is finite and none returns an id deleted before it was
    submitted (the switch interval shortened to shake the interleaving)."""
    X, cents = _blobs(rng, m=384)
    idx = _ivf(X, dispatch_depth=2, compact_tombstone_fraction=0.05)
    ses = ServeSession(idx, device=CPU)
    Q = (cents[rng.integers(0, 8, 24)] + rng.standard_normal((24, 16))).astype(np.float32)
    deleted: list[int] = []
    lock = threading.Lock()
    stop = threading.Event()

    def churn():
        crng = np.random.default_rng(11)
        nid = 100000
        while not stop.is_set():
            rows = (cents[crng.integers(0, 8, 16)]
                    + crng.standard_normal((16, 16))).astype(np.float32)
            ses.upsert(np.arange(nid, nid + 16), rows)
            ses.delete(np.arange(nid, nid + 8))
            with lock:
                deleted.extend(range(nid, nid + 8))
            nid += 16

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    worker = threading.Thread(target=churn)
    comp = ses.start_compactor(interval_s=0.01, retrain=False)
    gone_at, done = [], []
    try:
        worker.start()
        for _ in range(40):
            with lock:
                gone_at.append(set(deleted))  # deleted before this submit
            done += ses.submit(Q)
        done += ses.drain()
    finally:
        stop.set()
        worker.join(timeout=60)
        comp.stop(timeout=60)
        sys.setswitchinterval(old)
    assert not worker.is_alive() and not comp._thread.is_alive()
    assert deleted and len(done) == 40
    for res in done:
        assert np.isfinite(res.dists).all()
        assert not gone_at[res.seq] & set(res.ids.ravel().tolist())


# ---------------------------------------------------------------------------
# The mutate CLI against the JAX package's


# ---------------------------------------------------------------------------
# the sharded store: one store on one device, and slices apart


def _apart(index):
    """A sharded index with its slices apart, each a tensor set of its own
    (the layout of a store over distinct cards, here on the one CPU)."""
    return dataclasses.replace(
        index, shard_store=[tuple(None if t is None else t.clone() for t in sl)
                            for sl in index.slices],
        buckets=None, bucket_ids=None, bucket_sqs=None, bucket_scales=None,
        _cache={})


def _sharded_store(index) -> dict:
    names = ("buckets", "bucket_ids", "bucket_sqs")
    return {n: torch.cat([sl[k] for sl in index.slices]).numpy()
            for k, n in enumerate(names)}


def test_s1_sharded_mutation_bit_identical(rng):
    """The reference's case: upserts and deletes on the unsharded index and
    on a one-shard index leave the same store; here also on a one-shard
    store in slices of their own, and all three equal the JAX package's
    one-shard sharded mutation of the same index (norms to 1e-6)."""
    from mpi_knn_tpu.ivf.sharded import shard_ivf_index as jshard
    from mpi_knn_tpu_torch.ivf import shard_ivf_index

    X, cents = _blobs(rng)
    j, _ = _pair(X, nprobe=4)
    a, b, c = (ivf_index_from_reference(_state(j), CPU) for _ in range(3))
    b = shard_ivf_index(b, shards=1)
    c = _apart(shard_ivf_index(c, shards=1))
    js = jshard(j, shards=1)
    ids = np.arange(2000, 2032)
    rows = (cents[rng.integers(0, 8, 32)]
            + rng.standard_normal((32, 16))).astype(np.float32)
    for index, mod in ((a, sm), (b, sm), (c, sm), (js, jsm)):
        mod.upsert_rows(index, ids, rows)
        mod.delete_rows(index, ids[:8])
    want = _store_np(a)
    for got in (_sharded_store(b), _sharded_store(c)):
        for name, w in got.items():
            assert np.array_equal(w, want[name]), name
    # against JAX: rows and ids bit for bit, norms within 1e-6 (its f32
    # norms are summed in another order, as _assert_same_store holds them)
    assert np.array_equal(want["buckets"], np.asarray(js.buckets))
    assert np.array_equal(want["bucket_ids"], np.asarray(js.bucket_ids))
    np.testing.assert_allclose(want["bucket_sqs"], np.asarray(js.bucket_sqs),
                               rtol=1e-6, atol=1e-6)


def test_sharded_mutation_and_compact(rng):
    """The reference's case on four shards whose slices lie apart: deleted
    ids never come back, the upserted rows answer for themselves before
    and after a compaction, which keeps every live row; the store stays the
    one-store index's bit for bit."""
    from mpi_knn_tpu_torch.ivf import search_ivf_sharded, shard_ivf_index

    X, cents = _blobs(rng)
    one = shard_ivf_index(_ivf(X, nprobe=8), shards=4)
    idx = _apart(shard_ivf_index(_ivf(X, nprobe=8), shards=4))
    ids = np.arange(3000, 3032)
    rows = (cents[rng.integers(0, 8, 32)]
            + rng.standard_normal((32, 16))).astype(np.float32)
    probes = rows[16:20] + np.float32(0.1)
    for index in (one, idx):
        sm.upsert_rows(index, ids, rows)
        sm.delete_rows(index, ids[:16])
    d, i, _ = search_ivf_sharded(idx, probes, config=idx.cfg.replace(k=3),
                                 device=CPU)
    assert not set(ids[:16].tolist()) & set(i.ravel().tolist())
    assert set(i[:, 0].tolist()) == set(ids[16:20].tolist())
    for index in (one, idx):
        st = sm.compact_index(index, reason="test")
        assert st["live"] == 256 + 16
    d, i, _ = search_ivf_sharded(idx, probes, config=idx.cfg.replace(k=3),
                                 device=CPU)
    assert set(i[:, 0].tolist()) == set(ids[16:20].tolist())
    for name, got in _sharded_store(idx).items():
        assert np.array_equal(got, _sharded_store(one)[name]), name


def test_4shard_build_with_tombstones_reloads_on_fewer_shards(rng, tmp_path):
    """The reference's case: a four-shard store (slices apart) with
    upserts and tombstones saves as one file that reloads unsharded and
    on one and two shards (the two apart) with the same live rows and the
    same answers, the deleted ids absent."""
    from mpi_knn_tpu_torch.ivf import search_ivf_sharded, shard_ivf_index

    X, cents = _blobs(rng)
    idx = _apart(shard_ivf_index(_ivf(X, nprobe=8), shards=4))
    ids = np.arange(6000, 6016)
    rows = (cents[rng.integers(0, 8, 16)]
            + rng.standard_normal((16, 16))).astype(np.float32)
    sm.upsert_rows(idx, ids, rows)
    sm.delete_rows(idx, ids[:8])
    path = save_ivf_index(idx, str(tmp_path / "shard.npz"))
    plain = load_ivf_index(path, device=CPU)
    d0, i0 = search_ivf(plain, rows[8:12], config=plain.cfg.replace(k=3),
                        device=CPU)
    for s, apart in ((1, False), (2, True)):
        re_ = shard_ivf_index(load_ivf_index(path, device=CPU), shards=s)
        if apart:
            re_ = _apart(re_)
        assert freelist_of(re_).live == 256 + 8
        d, i, _ = search_ivf_sharded(re_, rows[8:12],
                                     config=re_.cfg.replace(k=3), device=CPU)
        assert torch.equal(i, i0)
        assert not set(ids[:8].tolist()) & set(i.ravel().tolist())


@pytest.fixture
def saved(tmp_path):
    """A JAX-built index with headroom, saved to .npz, and a copy for each
    package's CLI."""
    X, _ = _blobs(np.random.default_rng(3), m=384)
    j = jivf.build_ivf_index(X, JaxConfig(**{**BASE, "dtype": "int8"}))
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    jivf.save_ivf_index(j, a)
    jivf.save_ivf_index(j, b)
    return a, b, tmp_path


def _lines(capsys) -> list[dict]:
    return [json.loads(s) for s in capsys.readouterr().out.splitlines() if s]


def _both(capsys, a, b, argv):
    assert port_cli.main(["mutate", "--index", a, *argv, "--device", "cpu"]) == 0
    got = _lines(capsys)
    assert jcli.main(["--index", b, *argv, "--platform", "cpu"]) == 0
    return got, _lines(capsys)


def test_cli_stats_equals_jax(saved, capsys):
    a, b, _ = saved
    got, want = _both(capsys, a, b, ["--stats"])
    assert got == want and got[0]["action"] == "stats" and got[0]["live"] == 384


def test_cli_actions_equal_jax(saved, capsys):
    a, b, tmp = saved
    rows = np.random.default_rng(4).standard_normal((6, 16)).astype(np.float32)
    np.save(tmp / "new.npy", rows)
    steps = (["--upsert-rows", str(tmp / "new.npy"), "--ids", "1000000:1000006"],
             ["--synthetic", "5", "--ids", "2000,2001,2002,2003,2004", "--seed", "3",
              "--delete", "17,42,1000000"],
             ["--compact", "--no-retrain"])
    for argv in steps:
        got, want = _both(capsys, a, b, argv)
        for g in got + want:
            g.pop("wall_s", None)
            g.pop("path", None)
        assert got == want, argv
    assert got[-1]["action"] == "saved" and got[-1]["live"] == 384 + 6 + 5 - 3
    back = load_ivf_index(a, device=CPU)
    assert back.live_rows == got[-1]["live"]
    assert 1000000 not in freelist_of(back).pos and 2004 in freelist_of(back).pos


def test_cli_out_and_compact_with_retrain(saved, capsys):
    a, _, tmp = saved
    out = str(tmp / "v2.npz")
    assert port_cli.main(["mutate", "--index", a, "--delete", "0:100",
                          "--compact", "--out", out, "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert [x["action"] for x in lines] == ["delete", "compact", "saved"]
    assert lines[1]["retrained"] and lines[1]["tombstones_reclaimed"] == 100
    assert lines[2]["path"] == out and lines[2]["tombstones"] == 0
    assert load_ivf_index(out, device=CPU).live_rows == 284
    assert load_ivf_index(a, device=CPU).live_rows == 384  # untouched


def test_cli_overflow_exits_1(tmp_path, capsys):
    X, _ = _blobs(np.random.default_rng(3))
    path = save_ivf_index(_ivf(X, bucket_headroom=0.0), str(tmp_path / "i.npz"))
    burst = np.ones((400, 16), np.float32) * 3.0
    np.save(tmp_path / "b.npy", burst)
    assert port_cli.main(["mutate", "--index", path, "--upsert-rows",
                          str(tmp_path / "b.npy"), "--ids", "5000:5400",
                          "--device", "cpu"]) == 1
    assert _lines(capsys)[-1]["error"] == "headroom-exhausted"


@pytest.mark.parametrize("flag,argv", [
    ("--url", ["--url", "http://127.0.0.1:1", "--compact"]),
    ("--tenant", ["--index", "x.npz", "--tenant", "alice", "--stats"])])
def test_cli_unported_flags_exit_2(flag, argv, capsys):
    # the online mode is ported: what stays refused is an offline action
    # online, and a tenant offline
    assert port_cli.main(["mutate", *argv, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert flag in err and "offline" in err


@pytest.mark.parametrize("argv,words", [
    (["--index", "x.npz"], "nothing to do"),
    (["--index", "x.npz", "--synthetic", "4"], "need --ids"),
    (["--index", "x.npz", "--ids", "1:3"], "no action"),
])
def test_cli_usage_errors_exit_2(argv, words, capsys):
    assert port_cli.main(["mutate", *argv, "--device", "cpu"]) == 2
    assert words in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the hooks of resilience/ and obs/ (tests/test_mutation.py's)


def test_compactor_defers_under_shed(rng):
    from mpi_knn_tpu_torch.obs.metrics import get_registry
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy

    X, _ = _blobs(rng, m=512)
    idx = _ivf(X, compact_tombstone_fraction=0.1)
    ses = ServeSession(idx, resilience=ResiliencePolicy(), device=CPU)
    comp = ses.start_compactor(interval_s=3600)  # tick by hand
    deferred0 = get_registry().counter("compact_deferred_total").value
    try:
        sm.delete_rows(idx, np.arange(0, 200))
        assert should_compact(idx, ses.cfg) == "tombstones"
        assert ses.shed_rung(reason="test") is not None
        assert comp.tick() is None  # compaction is shed first
        snap = comp.snapshot()
        assert snap["deferred"] == 1 and snap["compactions"] == 0
        assert get_registry().counter("compact_deferred_total").value == deferred0 + 1
        ses.restore_rung()
        st = comp.tick()
        assert st is not None and st["reason"] == "tombstones"
        assert comp.snapshot()["compactions"] == 1
    finally:
        comp.stop()


def test_mutation_metrics_and_gauges(rng):
    """The same upserts and deletes on a JAX index and its carried copy
    move both registries' mutation counters by the same amounts and stamp
    the same gauges; the port's exposition parses in both packages."""
    from mpi_knn_tpu.obs import metrics as jmetrics
    from mpi_knn_tpu_torch.obs import metrics as pmetrics

    X, _ = _blobs(rng)
    j, p = _pair(X)
    rows = rng.standard_normal((16, 16)).astype(np.float32)
    regs = (jmetrics.get_registry(), pmetrics.get_registry())
    names = ("mutation_upserts_total", "mutation_deletes_total")
    before = [[r.counter(n).value for n in names] for r in regs]
    jsm.upsert_rows(j, np.arange(8000, 8016), rows)
    jsm.delete_rows(j, np.arange(8000, 8008))
    sm.upsert_rows(p, np.arange(8000, 8016), rows)
    sm.delete_rows(p, np.arange(8000, 8008))
    deltas = [[r.counter(n).value - b for n, b in zip(names, bs)]
              for r, bs in zip(regs, before)]
    assert deltas[0] == deltas[1] == [16, 8]
    text = regs[1].to_prometheus()
    samples = pmetrics.parse_prometheus(text)
    assert samples == jmetrics.parse_prometheus(text)
    assert samples["index_live_rows"] == freelist_of(p).live
    assert 0 < samples["index_max_bucket_fill"] <= 1.0
    for gauge in ("index_live_rows", "index_tombstone_fraction",
                  "index_max_bucket_fill"):
        assert regs[1].gauge(gauge).value == regs[0].gauge(gauge).value, gauge


def test_compactor_thread_runs_and_flight_records(rng, tmp_path):
    from mpi_knn_tpu.obs.spans import validate_flight as jvalidate
    from mpi_knn_tpu_torch.obs.spans import (
        FlightRecorder,
        read_flight,
        set_recorder,
        validate_flight,
    )

    flight = tmp_path / "flight.jsonl"
    set_recorder(FlightRecorder(str(flight), fresh=True))
    try:
        X, _ = _blobs(rng, m=512)
        idx = _ivf(X, compact_tombstone_fraction=0.1)
        ses = ServeSession(idx, device=CPU)
        comp = ses.start_compactor(interval_s=0.05)
        try:
            sm.delete_rows(idx, np.arange(0, 200))
            deadline = time.time() + 30
            while comp.snapshot()["compactions"] == 0 and time.time() < deadline:
                time.sleep(0.05)
            assert comp.snapshot()["compactions"] >= 1
        finally:
            comp.stop()
    finally:
        set_recorder(None)
    records = read_flight(str(flight))
    assert validate_flight(records) == [] and jvalidate(records) == []
    assert any(r.get("name") == "compact" for r in records)
    assert any(r.get("name") == "delete" and r.get("cat") == "mutate"
               for r in records)


def test_cli_cache_dir_mutates_with_the_cache_on(saved, capsys):
    """``--cache-dir`` points the process at the kernel cache; the
    mutation path launches no kernel, so its lines equal the JAX CLI's."""
    from mpi_knn_tpu_torch.serve import aotcache

    a, b, tmp = saved
    try:
        assert port_cli.main(["mutate", "--index", a, "--delete", "17,42",
                              "--cache-dir", str(tmp / "cache"),
                              "--device", "cpu"]) == 0
        assert aotcache.active_cache().dir == tmp / "cache"
    finally:
        aotcache.reset_for_tests()
    got = _lines(capsys)
    assert jcli.main(["--index", b, "--delete", "17,42", "--platform", "cpu"]) == 0
    want = _lines(capsys)
    for g in got + want:
        g.pop("path", None)
    assert got == want
