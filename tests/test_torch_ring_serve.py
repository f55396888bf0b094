"""Ring serving in the port (``backend="ring"`` / ``"ring-overlap"``) on
the CPU: a resident ring index whose shards are staged once and only read,
held against the port's own ``all_knn`` bit for bit, against the JAX
package's ring serving (tie-aware, distances to 1e-5), and its CLI, mirroring
``tests/test_serve.py``'s ring cases.

On the CPU the ranks are logical (``num_devices=4`` on the one CPU) and the
kernels run their plain versions; the transport's dma and grid forms, which
``ring_form`` keeps for cards, are driven here through their plain
versions too. Data are random normal (no distance ties), made with numpy.
"""

import json

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu_torch import KNNConfig, ServeSession, all_knn
from mpi_knn_tpu_torch.backends import ring
from mpi_knn_tpu_torch.serve import (
    build_index,
    engine,
    query_knn,
    ring_query_shapes,
)
from mpi_knn_tpu_torch.serve import cli as serve_cli
from tests.oracle import recall_against_oracle

CPU = "cpu"


def _data(seed, m=200, d=16):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


def _kw(backend, policy="exact", wire=None, **kw):
    kw.setdefault("k", 5)
    kw.setdefault("num_devices", 4)
    kw.setdefault("query_tile", 16)
    kw.setdefault("corpus_tile", 32)
    kw.setdefault("query_bucket", 16)
    if backend == "ring-overlap":
        kw.setdefault("ring_fusion", "fused")
    return dict(backend=backend, precision_policy=policy,
                ring_transfer_dtype=wire, **kw)


def _equal(got, want):
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)


# ring: the blocking schedule (its xla merge); ring-overlap: the fused merge
CONFIGS = [(b, p, w) for b in ("ring", "ring-overlap")
           for p, w in (("exact", None), ("exact", "bfloat16"), ("mixed", None),
                        ("mixed", "bfloat16"), ("mixed", "int8"))]


@pytest.mark.parametrize("backend,policy,wire", CONFIGS)
@pytest.mark.parametrize("rows", [5, 16, 17, 40])
def test_ring_query_knn_equals_all_knn(backend, policy, wire, rows):
    """Batch sizes around the bucket boundaries (16, 32, 64 rows) equal a
    fresh all_knn on the same queries, bit for bit. At least 5 rows, so
    all_knn gives every rank 2 or more: the CPU's BLAS sums a single row's
    product in another order (a matrix-vector product), which the plain
    versions inherit and the card's kernels do not."""
    X, Q = _data(0), _data(1, m=rows)
    kw = _kw(backend, policy, wire)
    idx = build_index(X, device=CPU, **kw)
    _equal(query_knn(Q, idx, device=CPU), all_knn(X, queries=Q, device=CPU, **kw))


@pytest.mark.parametrize("schedule", ["uni", "bidir"])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("backend", ["ring", "ring-overlap"])
def test_ring_query_knn_matches_jax_query_knn(backend, wire, schedule):
    """Against the JAX package's ring serving (its xla merge: this jax
    refuses its fused ring under shard_map on the CPU): ids tie-aware by the
    reference's own distances, distances to 1e-5."""
    X, Q = _data(2), _data(3, m=24)
    kw = _kw(backend, wire=wire, ring_schedule=schedule)
    got = query_knn(Q, build_index(X, device=CPU, **kw), device=CPU)
    jax_kw = {**kw, "ring_fusion": "xla"}
    want = jax_pkg.query_knn(Q, jax_pkg.build_index(X, **jax_kw))
    wd, wi = np.asarray(want.dists), np.asarray(want.ids)
    np.testing.assert_allclose(got.dists.numpy(), wd, rtol=1e-5, atol=1e-5)
    assert recall_against_oracle(got.ids.numpy(), wd, wi, 5) == 1.0


@pytest.mark.parametrize("bucket", [16, 64])
@pytest.mark.parametrize("max_tile_elems", [1 << 28, 256])
def test_ring_query_shapes_match_jax(bucket, max_tile_elems):
    from mpi_knn_tpu.serve.engine import ring_query_shapes as jax_shapes

    X = _data(4)
    kw = _kw("ring-overlap", max_tile_elems=max_tile_elems)
    idx = build_index(X, device=CPU, **kw)
    jidx = jax_pkg.build_index(X, **{**kw, "ring_fusion": "xla"})
    assert idx.c_tile == jidx.c_tile
    assert ring_query_shapes(idx, idx.cfg, bucket) == jax_shapes(jidx, jidx.cfg, bucket)


@pytest.mark.parametrize("form", ["dma", "grid"])
@pytest.mark.parametrize("precision", [None, "default"])
def test_transport_forms_read_the_shards_only(form, precision, monkeypatch):
    """The dma (K4) and grid (K5) forms, whose kernels copy each rank's
    block into its successor's buffer: over a resident index the shards are
    only a source (the rounds after the first write into the bucket's
    landing slots), every batch equals the one-shot ring of that form, and
    the entry's slots are made once."""
    X = _data(5)
    kw = _kw("ring-overlap", matmul_precision=precision,
             ring_fused_rotation="round" if form == "dma" else "grid")
    idx = build_index(X, device=CPU, **kw)
    monkeypatch.setattr(ring, "ring_form", lambda cfg, devices: form)
    before = [tuple(None if t is None else t.clone() for t in s) for s in idx.shards]
    cfg = KNNConfig(**kw)
    for rows in (16, 9, 16):
        Q = _data(6 + rows, m=rows)
        got = query_knn(Q, idx, device=CPU)
        Qc = (Q - X.astype(np.float64).mean(0))
        Xc = (X - X.astype(np.float64).mean(0))
        want = ring.all_knn_ring(Xc, Qc, np.full(rows, -1, np.int32), cfg,
                                 device=CPU, form=form)
        assert torch.equal(got.ids, want[1]) and torch.equal(got.dists, want[0])
    entry = get_entry = engine.get_executable(idx, idx.cfg, 16)
    assert entry.ring_slots is not None and get_entry is engine.get_executable(
        idx, idx.cfg, 16)
    for b, a in zip(before, idx.shards):
        for x, y in zip(b, a):
            assert (x is None) == (y is None)
            assert x is None or torch.equal(x, y)


def test_ring_index_holds_the_wire_once():
    """int8: the shards hold codes and scales, quantized once; the
    resident bytes count every part; the bf16 wire holds bf16 rows."""
    X = _data(7)
    idx8 = build_index(X, device=CPU, **_kw("ring-overlap", "mixed", "int8"))
    assert all(s[0].dtype == torch.int8 and s[2] is not None for s in idx8.shards)
    assert idx8.nbytes_resident == sum(t.numel() * t.element_size()
                                       for s in idx8.shards for t in s if t is not None)
    idx16 = build_index(X, device=CPU, **_kw("ring-overlap", "exact", "bfloat16"))
    assert all(s[0].dtype == torch.bfloat16 for s in idx16.shards)
    assert len(idx16.shards) == 4 and idx16.ring_meta == (None, "ring", 1, 4)


def test_ring_session_builds_nothing_after_warm():
    X = _data(8)
    idx = build_index(X, device=CPU, **_kw("ring-overlap", ring_schedule="bidir"))
    session = ServeSession(idx, device=CPU)
    session.warm([5, 16, 17, 40])
    engine.reset_misses()
    out = list(session.stream([_data(9 + n, m=n) for n in (5, 16, 17, 40, 3)]))
    assert engine.MISSES == 0 and [r.rows for r in out] == [5, 16, 17, 40, 3]


@pytest.mark.parametrize("field,value", [
    ("ring_schedule", "bidir"), ("num_devices", 2), ("ring_transfer_dtype", "bfloat16"),
])
def test_ring_index_freezes_its_ring_fields(field, value):
    idx = build_index(_data(10), device=CPU, **_kw("ring-overlap"))
    with pytest.raises(ValueError, match="corpus-side knobs"):
        query_knn(_data(11, m=4), idx, device=CPU, **{field: value})


def test_blocking_ring_refuses_the_fused_merge_as_all_knn_does():
    with pytest.raises(ValueError, match="blocking schedule"):
        build_index(_data(12), device=CPU, **_kw("ring", ring_fusion="fused"))


def test_query_cli_serves_a_ring_index(tmp_path):
    report = tmp_path / "ring.json"
    rc = serve_cli.main(
        ["--data", "synthetic:256x16c4", "--synthetic", "40", "--batch", "16",
         "--k", "5", "--backend", "ring-overlap", "--devices", "4",
         "--ring-schedule", "bidir", "--ring-transfer-dtype", "int8",
         "--precision-policy", "mixed", "--bucket", "16", "--device", CPU,
         "--report", str(report), "-q"])
    assert rc == 0
    r = json.loads(report.read_text())
    assert r["backend"] == "ring-overlap" and r["queries"] == 40
    assert r["ring_transfer"]["dtype"] == "int8"
    assert r["ring_transfer"]["wire_bytes_per_batch"] > 0
    assert r["resident_bytes"] > 0


def test_query_cli_refuses_the_int8_wire_without_mixed():
    assert serve_cli.main(
        ["--data", "synthetic:64x8c2", "--synthetic", "8", "--backend",
         "ring-overlap", "--devices", "4", "--ring-transfer-dtype", "int8",
         "--device", CPU]) == 2


@pytest.mark.parametrize("backend", ["ring", "ring-overlap"])
@pytest.mark.parametrize("rows", [5, 17, 33])
def test_ring_serving_breaks_ties_as_all_knn_does(backend, rows):
    """Small integers with every corpus row repeated in each of the four
    blocks: exact distance ties at the k-th boundary everywhere, broken by
    the order in which a rank merges the blocks. Each real row sits on the
    rank all_knn gives it (``ring_layout``), so the ids still match bit
    for bit."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 3, (40, 6)).astype(np.float32)
    X = np.concatenate([base] * 4)  # 160 rows, one copy a block
    Q = rng.integers(0, 3, (rows, 6)).astype(np.float32)
    kw = _kw(backend, k=7, corpus_tile=40)
    idx = build_index(X, device=CPU, **kw)
    _equal(query_knn(Q, idx, device=CPU), all_knn(X, queries=Q, device=CPU, **kw))


@pytest.mark.parametrize("rows", [1, 5, 16, 17, 40, 64])
def test_ring_layout_puts_rows_on_all_knns_ranks(rows):
    from mpi_knn_tpu_torch.serve.engine import bucket_shapes, ring_layout

    idx = build_index(_data(14), device=CPU, **_kw("ring-overlap"))
    cfg = idx.cfg
    q_pad, _ = bucket_shapes(idx, cfg, engine.bucket_rows(rows, cfg.query_bucket))
    perm = ring_layout(idx, cfg, rows, q_pad, "cpu")
    assert sorted(perm.tolist()) == list(range(q_pad))
    _, _, q_pad_rows, _ = ring.ring_tiles(cfg, idx.m, rows, 1, 4)
    per_batch, per_bucket = q_pad_rows // 4, q_pad // 4
    assert [p // per_bucket for p in perm[:rows].tolist()] == \
        [i // per_batch for i in range(rows)]
