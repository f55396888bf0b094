"""The port's sharded clustered index (``mpi_knn_tpu_torch/ivf/sharded.py``)
against the JAX package's ``mpi_knn_tpu.ivf.sharded`` on the CPU: the
reference's cases other than lint (``tests/test_ivf_sharded.py``), at
shard counts 1, 2 and 4 (logical ranks on the one CPU device here; JAX's
8-device host mesh there).

An index the JAX package built is carried across (``convert.py``), so both
packages search the same partitions: ids tie-aware against JAX's sharded
search, distances within the f32 error of JAX's products, the per-shard
[routed, dropped, served] stats equal JAX's exactly. Inside the port the
sharded search equals the unsharded one bit for bit at every shard count.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_knn_tpu import KNNConfig as JaxConfig
from mpi_knn_tpu import ivf as jivf
from mpi_knn_tpu_torch import KNNConfig, all_knn, query_knn
from mpi_knn_tpu_torch.convert import ivf_index_from_reference
from mpi_knn_tpu_torch.ivf import (
    ShardedIVFIndex,
    build_ivf_index,
    build_sharded_ivf_index,
    load_ivf_index,
    save_ivf_index,
    search_ivf,
    search_ivf_sharded,
    shard_ivf_index,
    unshard_ivf_index,
)
from mpi_knn_tpu_torch.ivf import sharded as psharded
from mpi_knn_tpu_torch.serve import ServeSession
from tests.oracle import oracle_all_knn, recall_against_oracle
from tests.test_torch_ivf import _assert_same_search, _state

CPU = "cpu"
K = 10
SHARD_COUNTS = (1, 2, 4)


def _clustered(rng, m=1024, d=32, centers=16, spread=0.25):
    cents = rng.standard_normal((centers, d)).astype(np.float32) * 4
    assign = rng.integers(0, centers, size=m)
    return (cents[assign] + rng.standard_normal((m, d)).astype(np.float32)
            * spread * 4).astype(np.float32)


def _pair(X, **cfg):
    """(JAX index, the port's copy of it)."""
    j = jivf.build_ivf_index(X, JaxConfig(**cfg))
    return j, ivf_index_from_reference(_state(j), CPU)


def _np(*ts):
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in ts]


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_parity_with_single_device_at_equal_nprobe(shards, dtype):
    """At a common q_tile the sharded search is bit for bit the unsharded
    one at every shard count; against the JAX package's sharded search the
    ids agree tie-aware, the distances within its f32 error, and the
    exchange stats exactly."""
    X = _clustered(np.random.default_rng(0))
    j, p = _pair(X, k=K, partitions=16, nprobe=4, query_tile=8, dtype=dtype)
    Q = X[:64]
    qids = np.arange(64, dtype=np.int32)
    d0, i0 = search_ivf(p, Q, query_ids=qids, device=CPU)
    sidx = shard_ivf_index(p, shards=shards)
    assert isinstance(sidx, ShardedIVFIndex) and sidx.backend == "ivf-sharded"
    d, i, stats = search_ivf_sharded(sidx, Q, query_ids=qids, device=CPU)
    assert torch.equal(i, i0) and torch.equal(d, d0)
    jd, ji, jstats = jivf.search_ivf_sharded(jivf.shard_ivf_index(j, shards=shards),
                                             Q, query_ids=qids)
    _assert_same_search(p, Q, (d, i), (jd, ji))
    np.testing.assert_array_equal(stats.numpy(), jstats)
    assert stats.shape == (shards, 3)
    assert stats[:, 1].sum() == 0
    assert stats[:, 0].sum() == stats[:, 2].sum() > 0


def test_recall_parity_vs_oracle_across_shard_counts():
    X = _clustered(np.random.default_rng(1), m=2048, d=48, centers=24)
    idx = build_ivf_index(X, KNNConfig(k=K, partitions=32, query_tile=8),
                          device=CPU)
    sample = np.arange(0, 2048, 8)
    want_d, want_i = oracle_all_knn(X, k=K + 5, queries=X[sample],
                                    exclude_self=False)
    for r, s in enumerate(sample):
        want_d[r][want_i[r] == s] = np.inf
    order = np.argsort(want_d, axis=1, kind="stable")
    want_d = np.take_along_axis(want_d, order, axis=1)
    want_i = np.take_along_axis(want_i, order, axis=1)
    _, i0 = search_ivf(idx, X[sample], query_ids=sample.astype(np.int32),
                       device=CPU)
    rec0 = recall_against_oracle(i0.numpy(), want_d, want_i, K)
    assert rec0 >= idx.cfg.recall_target
    for shards in SHARD_COUNTS:
        _, i_s, _ = search_ivf_sharded(shard_ivf_index(idx, shards=shards),
                                       X[sample],
                                       query_ids=sample.astype(np.int32),
                                       device=CPU)
        assert recall_against_oracle(i_s.numpy(), want_d, want_i, K) == rec0


def test_nprobe_equals_partitions_matches_dense_ring_scan():
    X = _clustered(np.random.default_rng(2), m=512, d=32, centers=8)
    idx = build_ivf_index(X, KNNConfig(k=K, partitions=8, nprobe=8,
                                       query_tile=8), device=CPU)
    sidx = shard_ivf_index(idx, shards=4)
    sample = np.arange(0, 512, 4)
    gd, gi, _ = _np(*search_ivf_sharded(sidx, X[sample],
                                        query_ids=sample.astype(np.int32),
                                        device=CPU))
    want = all_knn(X, queries=X[sample], query_ids=sample,
                   config=KNNConfig(k=K, backend="ring", query_tile=64,
                                    corpus_tile=64, num_devices=4),
                   device=CPU)
    wd, wi = want.dists.numpy(), want.ids.numpy()
    np.testing.assert_allclose(gd, wd, rtol=2e-5, atol=1e-3)
    rec = np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                   for a, b in zip(gi, wi)])
    assert rec >= 0.999


def test_sharded_save_loads_on_any_shard_count(tmp_path):
    """A 4-shard build saves its unsharded view; the same file reloads
    unsharded and on 1 and 2 shards to the same answers, and the JAX
    package reloads it to the same ids."""
    X = _clustered(np.random.default_rng(3), m=512, d=24, centers=8)
    sidx4 = build_ivf_index(X, KNNConfig(k=5, partitions=8, nprobe=3,
                                         query_tile=8, ivf_shards=4),
                            device=CPU)
    assert sidx4.backend == "ivf-sharded" and sidx4.shards == 4
    Q = X[::16]
    d4, i4, _ = search_ivf_sharded(sidx4, Q, device=CPU)
    path = save_ivf_index(sidx4, str(tmp_path / "sharded"))
    loaded = load_ivf_index(path, device=CPU)
    assert loaded.cfg.ivf_shards is None and loaded.cfg.ivf_route_cap is None
    dl, il = search_ivf(loaded, Q, device=CPU)
    assert torch.equal(il, i4) and torch.equal(dl, d4)
    for shards in (1, 2):
        d, i, _ = search_ivf_sharded(shard_ivf_index(loaded, shards=shards), Q,
                                     device=CPU)
        assert torch.equal(i, i4) and torch.equal(d, d4)
    plain = unshard_ivf_index(sidx4)
    assert plain.buckets.shape[0] == sidx4.partitions
    assert torch.equal(plain.bucket_ids, loaded.bucket_ids)
    # the JAX package serves the same file sharded
    j = jivf.load_ivf_index(path)
    jd, ji, _ = jivf.search_ivf_sharded(jivf.shard_ivf_index(j, shards=2), Q)
    _assert_same_search(loaded, Q, (d4, i4), (jd, ji), k=5)


def test_uneven_partition_split_pads_with_unreachable_clusters():
    X = _clustered(np.random.default_rng(4), m=600, d=16, centers=10)
    idx = build_ivf_index(X, KNNConfig(k=5, partitions=10, nprobe=3,
                                       query_tile=8), device=CPU)
    sidx = shard_ivf_index(idx, shards=4)  # ceil(10/4) = 3 -> 12 slots
    assert sidx.per_shard == 3 and sidx.buckets.shape[0] == 12
    assert (sidx.bucket_ids[10:] == -1).all()
    assert [s[0].shape[0] for s in sidx.slices] == [3, 3, 3, 3]
    d0, i0 = search_ivf(idx, X[::8], device=CPU)
    d, i, _ = search_ivf_sharded(sidx, X[::8], device=CPU)
    assert torch.equal(i, i0) and torch.equal(d, d0)


# ---------------------------------------------------------------------------
# serving


def _serve_index(seed=5, shards=4, **kw):
    X = _clustered(np.random.default_rng(seed), m=768, d=24, centers=8)
    idx = build_ivf_index(X, KNNConfig(k=6, partitions=8, nprobe=2,
                                       query_tile=8, query_bucket=32, **kw),
                          device=CPU)
    return X, shard_ivf_index(idx, shards=shards)


def test_serve_bit_parity_and_no_builds_after_warm():
    from mpi_knn_tpu_torch.obs.metrics import watch_compiles

    X, sidx = _serve_index()
    sess = ServeSession(sidx, device=CPU)
    sess.warm([32, 64])
    batches = [X[:20], X[20:52], X[52:115]]
    with watch_compiles() as built:
        outs = list(sess.stream(batches))
    assert built == []
    for q, o in zip(batches, outs):
        d1, i1, s1 = search_ivf_sharded(sidx, q, device=CPU)
        assert np.array_equal(o.ids, i1.numpy())
        assert np.array_equal(o.dists, d1.numpy())
    res = query_knn(X[:20], sidx, device=CPU)
    assert np.array_equal(res.ids.numpy(), outs[0].ids)
    per_batch = [o.exchange for o in outs]
    assert all(e is not None and e.shape == (4, 3) for e in per_batch)
    routed = sum(int(e[:, 0].sum()) for e in per_batch)
    assert sess.exchange["shards"] == 4
    assert sess.exchange["routed_total"] == routed > 0
    assert sess.exchange["dropped_total"] == 0
    assert sess.exchange["exchange_bytes_total"] == sum(
        o.exchange_bytes for o in outs) > 0
    assert sum(sess.exchange["served_per_shard"]) == routed
    sess.reset_stats()
    assert sess.exchange["routed_total"] == 0


def test_peak_hbm_bytes_counts_the_exchange_buffers():
    from mpi_knn_tpu_torch.serve.engine import get_executable, index_peak_hbm_bytes

    X, sidx = _serve_index()
    assert index_peak_hbm_bytes(sidx) == 0
    sess = ServeSession(sidx, device=CPU)
    sess.warm([32])
    exec_ = get_executable(sidx, sess.cfg, 32)
    per_tile = psharded.exchange_bytes_per_tile(
        4, exec_.route_cap, sidx.bucket_cap, *psharded.exchange_wire_args(sidx))
    assert exec_.exchange_bytes == (exec_.q_pad // exec_.q_tile) * per_tile
    assert index_peak_hbm_bytes(sidx) >= sidx.nbytes_resident + 2 * 4 * per_tile


def test_exchange_metrics_and_shard_span_attrs(tmp_path):
    from mpi_knn_tpu_torch.obs import metrics as obs_metrics
    from mpi_knn_tpu_torch.obs.spans import (
        FlightRecorder,
        read_flight,
        reconstruct_spans,
        set_recorder,
        validate_flight,
    )

    X, sidx = _serve_index(seed=6, shards=2)
    reg = obs_metrics.get_registry()
    base = reg.counter("serve_exchange_routed_total").value
    base_b = reg.counter("serve_exchange_bytes_total").value
    path = str(tmp_path / "flight.jsonl")
    set_recorder(FlightRecorder(path))
    try:
        sess = ServeSession(sidx, device=CPU)
        sess.warm([32])
        list(sess.stream([X[:32], X[32:64]]))
    finally:
        set_recorder(None)
    assert reg.counter("serve_exchange_routed_total").value > base
    assert reg.counter("serve_exchange_bytes_total").value > base_b
    records = read_flight(path)
    assert validate_flight(records) == []
    spans, events = reconstruct_spans(records)
    batch_spans = [s for s in spans if s["name"] == "batch"]
    assert len(batch_spans) == 2
    assert all(s["attrs"]["shards"] == 2 for s in batch_spans)
    assert all(s["end_attrs"]["dropped"] == 0 for s in batch_spans)
    exch = [e for e in events if e["name"] == "exchange"]
    assert len(exch) == 2
    for e in exch:
        assert len(e["attrs"]["served_per_shard"]) == 2
        assert e["attrs"]["dropped"] == 0


def test_route_cap_overflow_drops_are_counted_never_wrong():
    X = _clustered(np.random.default_rng(7), m=512, d=16, centers=4, spread=0.05)
    j, idx = _pair(X, k=5, partitions=8, nprobe=4, query_tile=8)
    sidx = shard_ivf_index(idx, shards=4, route_cap=2)
    assert sidx.cfg.ivf_route_cap == 2
    d, i, stats = _np(*search_ivf_sharded(sidx, X[:64], device=CPU))
    dropped = int(stats[:, 1].sum())
    assert dropped > 0
    assert int(stats[:, 0].sum()) + dropped == 64 * 4
    assert np.isfinite(d[i >= 0]).all()
    # the JAX package drops the same probes
    _, _, jstats = jivf.search_ivf_sharded(
        jivf.shard_ivf_index(j, shards=4, route_cap=2), X[:64])
    np.testing.assert_array_equal(stats, jstats)
    d_safe, _, stats_safe = _np(*search_ivf_sharded(
        shard_ivf_index(idx, shards=4), X[:64], device=CPU))
    assert int(stats_safe[:, 1].sum()) == 0
    assert (d >= d_safe - 1e-6).all()
    d8, i8, stats8 = _np(*search_ivf_sharded(
        shard_ivf_index(idx, shards=4, route_cap=8), X[:64], device=CPU))
    assert int(stats8[:, 1].sum()) > 0
    assert (i8 >= 0).any(axis=1).all()


def test_total_starvation_is_counted_loss_not_poison():
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy

    rng = np.random.default_rng(8)
    X = (rng.standard_normal((256, 16)) * 0.01).astype(np.float32) + 3.0
    idx = build_ivf_index(X, KNNConfig(k=4, partitions=4, nprobe=1,
                                       query_tile=16, query_bucket=16,
                                       dispatch_depth=1), device=CPU)
    sidx = shard_ivf_index(idx, shards=2, route_cap=1)
    _, i, stats = _np(*search_ivf_sharded(sidx, X[:16], device=CPU))
    assert int(stats[:, 1].sum()) > 0
    assert (i < 0).all(axis=1).any()
    sess = ServeSession(sidx, resilience=ResiliencePolicy(), device=CPU)
    res = sess.submit(X[:16]) + sess.drain()  # must not raise
    assert np.isinf(res[0].dists).all(axis=1).any()
    assert res[0].exchange[:, 1].sum() > 0


def test_ladder_walk_sharded_nprobe_rung():
    from mpi_knn_tpu_torch.data.synthetic import make_blobs
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy, install_faults

    rng = np.random.default_rng(9)
    X, _ = make_blobs(256, 16, num_classes=4, seed=7)
    Q = (X[:16] + rng.normal(scale=0.01, size=(16, 16))).astype(np.float32)
    k = 4
    odists, oids = oracle_all_knn(X, k, queries=Q)
    idx = build_ivf_index(X, KNNConfig(k=k, partitions=4, nprobe=4,
                                       query_tile=16, query_bucket=16,
                                       dispatch_depth=1), device=CPU)
    sidx = shard_ivf_index(idx, shards=2)
    pol = ResiliencePolicy(batch_deadline_s=0.01, degrade_after=1,
                           max_retries=0)
    sess = ServeSession(sidx, resilience=pol, device=CPU)
    assert sess.ladder[1][0] == "nprobe/2" and sess.ladder[1][1].nprobe == 2
    sess.warm([16])
    with install_faults({"serve-batch": ("slow", 0.02)}):
        b1 = sess.submit(Q)[0]
        b2 = sess.submit(Q)[0]
    assert b1.degraded is None and b2.degraded == "nprobe/2"
    assert recall_against_oracle(b1.ids, odists, oids, k) == 1.0
    assert recall_against_oracle(b2.ids, odists, oids, k) >= \
        sess.cfg.recall_target
    assert b2.exchange[:, 0].sum() < b1.exchange[:, 0].sum()


# ---------------------------------------------------------------------------
# live mutation of the sharded store


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_mutation_equals_the_unsharded_store(shards):
    """Upserts, deletes and a compaction through a sharded session leave
    the answers of an unsharded session given the same writes; at S = 1
    the whole store stays bit for bit the unsharded one. The freelist
    counts only real partitions; its sentinel is the padded store's
    total."""
    from mpi_knn_tpu_torch.ivf.mutate import freelist_of

    rng = np.random.default_rng(10)
    X = _clustered(rng, m=600, d=16, centers=10)
    cfg = KNNConfig(k=5, partitions=10, nprobe=3, query_tile=8,
                    query_bucket=32, bucket_headroom=0.5)
    plain = build_ivf_index(X, cfg, device=CPU)
    sidx = shard_ivf_index(build_ivf_index(X, cfg, device=CPU), shards=shards)
    new = (X[:24] + 0.3).astype(np.float32)
    ids = np.arange(10_000, 10_024)
    outs = []
    for index in (plain, sidx):
        sess = ServeSession(index, device=CPU)
        up = sess.upsert(ids, new)
        de = sess.delete([5, 6, 10_003])
        outs.append((up, de, list(sess.stream([new, X[:40]]))))
        sess.compact(retrain=False)
        outs[-1] += (list(sess.stream([new])),)
    (up0, de0, r0, c0), (up1, de1, r1, c1) = outs
    assert up1["live"] == up0["live"] and de1["live"] == de0["live"]
    assert up1["partitions"] == 10
    for a, b in zip(r0 + c0, r1 + c1):
        assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)
    assert 10_003 not in r1[0].ids and 5 not in r1[1].ids
    fl = freelist_of(sidx)
    assert fl.total == sidx.per_shard * shards and fl.partitions == 10
    if shards == 1:
        assert torch.equal(sidx.bucket_ids, plain.bucket_ids)
        assert torch.equal(sidx.buckets, plain.buckets)


def test_mutation_refuses_a_store_over_distinct_devices():
    from mpi_knn_tpu_torch.serve.mutate import upsert_rows

    X = _clustered(np.random.default_rng(11), m=256, d=16, centers=4)
    idx = build_ivf_index(X, KNNConfig(k=3, partitions=4, nprobe=2),
                          device=CPU)
    sidx = shard_ivf_index(idx, shards=2)
    # a store whose slices live apart (as over two cards)
    sidx = dataclasses.replace(sidx, shard_store=sidx.slices, buckets=None,
                               bucket_ids=None, bucket_sqs=None)
    d, i, _ = search_ivf_sharded(sidx, X[:8], device=CPU)
    d0, i0 = search_ivf(idx, X[:8], device=CPU)
    assert torch.equal(i, i0) and torch.equal(d, d0)
    with pytest.raises(ValueError, match="distinct cards"):
        upsert_rows(sidx, [9000], X[:1])


# ---------------------------------------------------------------------------
# config, layout and the CLIs


def test_config_and_layout_validation():
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    with pytest.raises(ValueError, match="ivf_shards"):
        KNNConfig(k=3, ivf_shards=2)
    with pytest.raises(ValueError, match="ivf_shards"):
        KNNConfig(k=3, partitions=4, ivf_shards=0)
    with pytest.raises(ValueError, match="ivf_route_cap"):
        KNNConfig(k=3, partitions=4, ivf_route_cap=8)
    with pytest.raises(ValueError, match="ivf_route_cap"):
        KNNConfig(k=3, partitions=4, ivf_shards=2, ivf_route_cap=0)
    with pytest.raises(ValueError, match="ivf_shards"):
        build_sharded_ivf_index(np.zeros((64, 8), np.float32),
                                KNNConfig(k=3, partitions=4), device=CPU)
    X = _clustered(np.random.default_rng(12), m=256, d=16)
    idx = build_ivf_index(X, KNNConfig(k=5, partitions=4, nprobe=2),
                          device=CPU)
    with pytest.raises(ValueError, match="1-D ring mesh"):
        shard_ivf_index(idx, shards=4, mesh=make_mesh2d(2, 2, device=CPU))
    with pytest.raises(ValueError, match="device"):
        shard_ivf_index(idx, shards=3, mesh=[torch.device(CPU)] * 2)
    sidx = shard_ivf_index(idx, shards=4)
    with pytest.raises(ValueError, match="corpus-side"):
        sidx.compatible_cfg(sidx.cfg.replace(ivf_shards=2))
    assert sidx.compatible_cfg(sidx.cfg.replace(ivf_route_cap=3)).ivf_route_cap == 3
    # the exchange's shapes: q_tile shrinks until the exchange buffer fits
    cfg = KNNConfig(k=10, partitions=256, nprobe=2, ivf_shards=4)
    q_tile, q_pad, rc = psharded.sharded_query_shapes(cfg, 2, 1216, 128,
                                                      10000, 4)
    assert (q_tile, q_pad, rc) == (128, 10240, 256)
    assert psharded.exchange_elems(4, rc, 1216, 128) <= cfg.max_tile_elems


def test_cli_sharded_build_and_serve(tmp_path):
    from mpi_knn_tpu_torch.ivf import cli as ivf_cli
    from mpi_knn_tpu_torch.serve import cli as serve_cli

    path = str(tmp_path / "ring.npz")
    assert ivf_cli.main(["--data", "synthetic:256x16c4", "--partitions", "4",
                         "--k", "3", "--backend", "ring", "--out", path, "-q",
                         "--device", CPU]) == 0
    base = ["--data", "synthetic:256x16c4", "--index-load", path, "--device",
            CPU]
    report = tmp_path / "r.json"
    assert serve_cli.main(base + ["--backend", "ring", "--devices", "2",
                                  "--synthetic", "16", "--batch", "8",
                                  "--bucket", "8", "-q"]) == 0
    assert serve_cli.main(base + ["--backend", "ring", "--devices", "2",
                                  "--route-cap", "4", "--synthetic", "16",
                                  "--batch", "8", "--bucket", "8", "-q",
                                  "--report", str(report)]) == 0
    import json

    doc = json.loads(report.read_text())
    assert doc["backend"] == "ivf-sharded"
    sh = doc["sharded"]
    assert sh["shards"] == 2 and sh["route_cap"] == 4
    assert sh["routed_total"] > 0 and len(sh["served_per_shard"]) == 2
    assert sh["exchange_bytes_total"] > 0
    # refusals: exchange knobs outside the sharded path, ring-overlap
    for argv in (["--devices", "2", "--synthetic", "8"],
                 ["--route-cap", "4", "--synthetic", "8"],
                 ["--backend", "ring-overlap", "--synthetic", "8"]):
        assert serve_cli.main(base + argv) == 2
    assert serve_cli.main(["--data", "synthetic:256x16c4", "--route-cap", "4",
                           "--synthetic", "8", "--device", CPU]) == 2


def test_sharded_writes_save_through_the_unsharded_view(tmp_path):
    """Upsert and delete on a sharded store, then the saved file reloads
    unsharded with the writes in it."""
    from mpi_knn_tpu_torch.serve.mutate import delete_rows, upsert_rows

    X = _clustered(np.random.default_rng(13), m=256, d=16, centers=4)
    sidx = build_sharded_ivf_index(X, KNNConfig(k=3, partitions=4, nprobe=4,
                                                ivf_shards=2,
                                                bucket_headroom=0.5),
                                   device=CPU)
    upsert_rows(sidx, [5000, 5001], X[:2] + 0.5)
    delete_rows(sidx, [7])
    path = save_ivf_index(sidx, str(tmp_path / "m.npz"))
    back = load_ivf_index(path, device=CPU)
    live = set(back.bucket_ids[back.bucket_ids >= 0].tolist())
    assert {5000, 5001} <= live and 7 not in live
