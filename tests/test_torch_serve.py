"""The port's query serving (``mpi_knn_tpu_torch.serve``) on the CPU: held
against the JAX package's serving on the same inputs, against the port's
own ``all_knn`` bit for bit, and the engine's bucket entries, session
semantics, refusals and CLI, mirroring ``tests/test_serve.py``.

On the CPU the port runs the plain versions of the kernels (the CUDA ones
have no CPU form); ``tests/test_torch_cuda.py`` holds the resident-plane
path on the card. Data are random normal (no distance ties), made with
numpy from a seed.
"""

import json

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.serve import bucket_rows as jax_bucket_rows
from mpi_knn_tpu.serve import cli as jax_serve_cli
from mpi_knn_tpu_torch import KNNConfig, ServeSession, all_knn
from mpi_knn_tpu_torch.ops import fused_knn
from mpi_knn_tpu_torch.serve import (
    build_index,
    bucket_rows,
    engine,
    get_executable,
    query_knn,
)
from mpi_knn_tpu_torch.serve import cli as serve_cli
from tests.oracle import recall_against_oracle

CPU = "cpu"
PATHS = [(b, p) for b in ("serial", "pallas") for p in ("exact", "mixed")]


def _data(seed, m=256, d=24):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


def _kw(backend, **kw):
    """Small tiles: c_tile 32 (serial; pallas clamps to 128), so 4k < c_tile
    and the mixed policy really compresses."""
    kw.setdefault("k", 5)
    kw.setdefault("query_tile", 16)
    kw.setdefault("corpus_tile", 32)
    kw.setdefault("query_bucket", 16)
    return dict(backend=backend, **kw)


def _cfg(backend, **kw):
    return KNNConfig(**_kw(backend, **kw))


def _index(X, backend="serial", **kw):
    return build_index(X, _cfg(backend, **kw), device=CPU)


def _equal(got, want):
    assert torch.equal(got.ids, want.ids)
    assert torch.equal(got.dists, want.dists)


# ---------------------------------------------------------------------------
# parity with the JAX package's serving


@pytest.mark.parametrize("backend,policy", PATHS)
def test_query_knn_matches_jax_query_knn(backend, policy):
    X, Q = _data(0), _data(1, m=24)
    kw = _kw(backend, precision_policy=policy)
    got = query_knn(Q, build_index(X, device=CPU, **kw), device=CPU)
    want = jax_pkg.query_knn(Q, jax_pkg.build_index(X, **kw))
    wd, wi = np.asarray(want.dists), np.asarray(want.ids)
    # the frameworks sum in different orders: f32 distances to 1e-5, ids
    # equal up to ties judged by the reference's own distances
    np.testing.assert_allclose(got.dists.numpy(), wd, rtol=1e-5, atol=1e-5)
    assert recall_against_oracle(got.ids.numpy(), wd, wi, 5) == 1.0


@pytest.mark.parametrize("base", [1, 5, 16, 100])
def test_bucket_rows_matches_jax(base):
    for n in (1, 2, 5, 15, 16, 17, 99, 100, 101, 1000, 4097):
        assert bucket_rows(n, base) == jax_bucket_rows(n, base)
    with pytest.raises(ValueError):
        bucket_rows(0, base)


# ---------------------------------------------------------------------------
# parity with the port's one-shot API, bit for bit


@pytest.mark.parametrize("backend,policy", PATHS)
@pytest.mark.parametrize("tensor_queries", [False, True])
def test_query_knn_equals_all_knn(backend, policy, tensor_queries):
    X, Q = _data(2), _data(3, m=24)
    kw = _kw(backend, precision_policy=policy)
    q = torch.from_numpy(Q) if tensor_queries else Q
    got = query_knn(q, build_index(X, device=CPU, **kw), device=CPU)
    _equal(got, all_knn(X, queries=q, device=CPU, **kw))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_query_knn_equals_all_knn_serial_metrics(metric):
    X, Q = _data(4), _data(5, m=24)
    kw = _kw("serial", metric=metric)
    got = query_knn(Q, build_index(X, device=CPU, **kw), device=CPU)
    _equal(got, all_knn(X, queries=Q, device=CPU, **kw))


@pytest.mark.parametrize("backend", ["serial", "pallas"])
def test_tensor_built_index_equals_all_knn_on_that_residency(backend):
    """An index built from a tensor takes the tensor's mean, as all_knn
    does over that residency; host and tensor batches both match it."""
    X, Q = torch.from_numpy(_data(6)), _data(7, m=24)
    kw = _kw(backend)
    idx = build_index(X, device=CPU, **kw)
    for q in (Q, torch.from_numpy(Q)):
        _equal(query_knn(q, idx, device=CPU),
               all_knn(X, queries=q, device=CPU, **kw))


def test_serial_bf16_index_equals_bf16_all_knn():
    X, Q = _data(8), _data(9, m=16)
    kw = _kw("serial", dtype="bfloat16")
    idx = build_index(X, device=CPU, **kw)
    assert idx.nbytes_resident < _index(X).nbytes_resident
    _equal(query_knn(Q, idx, device=CPU),
           all_knn(X, queries=Q, device=CPU, **kw))


def test_on_the_cpu_the_plain_kernels_run():
    """Off the card the pallas index stages nothing and no kernel launches:
    the wrappers take their plain versions for CPU tensors."""
    fused_knn.reset_launch_counts()
    X, Q = _data(10), _data(11, m=24)
    for policy in ("exact", "mixed"):
        idx = build_index(X, device=CPU, **_kw("pallas",
                                               precision_policy=policy))
        assert idx.staged is None and idx.device == torch.device(CPU)
        query_knn(Q, idx, device=CPU)
    assert all(n == 0 for n in fused_knn.LAUNCHES.values())


@pytest.mark.parametrize("staged,policy,k,refused", [
    ("exact", "exact", 5, False),
    ("exact", "mixed", 5, True),
    ("compress", "mixed", 5, False),
    ("compress", "exact", 5, True),
    ("compress", "mixed", 40, True),  # 4k >= c_tile: mixed reads exact
])
def test_a_config_reading_an_unstaged_part_is_refused(staged, policy, k,
                                                      refused):
    """A card index stages the one corpus part its build config reads; a
    query config that reads the other is refused. The rule is judged on
    the parts present, so it is held here with a stand-in staged part."""
    idx = build_index(_data(40), device=CPU, **_kw("pallas"))
    part = (torch.zeros(1),)
    idx.staged = fused_knn.StagedCorpus(**{staged: part})
    cfg = idx.cfg.replace(precision_policy=policy, k=k)
    if refused:
        with pytest.raises(ValueError, match="did not stage at build"):
            idx.compatible_cfg(cfg)
    else:
        assert idx.compatible_cfg(cfg) == cfg


# ---------------------------------------------------------------------------
# bucket entries: built once, zero misses in steady state


@pytest.mark.parametrize("backend", ["serial", "pallas"])
def test_bucket_boundary_sizes(backend):
    X = _data(12)
    kw = _kw(backend)
    idx = build_index(X, device=CPU, **kw)
    Qfull = _data(13, m=40)
    for n in (1, 15, 16, 17, 31, 32, 33):
        got = query_knn(Qfull[:n], idx, device=CPU)
        assert got.ids.shape == (n, 5)
        _equal(got, all_knn(X, queries=Qfull[:n], device=CPU, **kw))


def test_steady_state_serving_builds_nothing():
    X = _data(14)
    idx = _index(X)
    session = ServeSession(idx, device=CPU)
    Qfull = _data(15, m=64)
    session.warm([16, 32, 64])
    assert len(idx._cache) == 3
    engine.reset_misses()
    served = []
    for n in (16, 9, 32, 33, 64, 1, 24):  # every bucket, ragged included
        served.extend(session.submit(Qfull[:n]))
    served.extend(session.drain())
    ragged = query_knn(Qfull[:13], idx, device=CPU)
    assert engine.MISSES == 0 and len(idx._cache) == 3
    assert [r.rows for r in served] == [16, 9, 32, 33, 64, 1, 24]
    want = all_knn(X, queries=Qfull[:24], config=idx.cfg, device=CPU)
    np.testing.assert_array_equal(want.ids.numpy(), served[-1].ids)
    np.testing.assert_array_equal(want.dists.numpy(), served[-1].dists)
    want13 = all_knn(X, queries=Qfull[:13], config=idx.cfg, device=CPU)
    _equal(ragged, want13)


def test_second_batch_of_each_bucket_hits_the_cache():
    X = _data(16, m=192)
    idx = _index(X)
    Qfull = _data(17, m=64)
    for n in (16, 32, 64):
        engine.reset_misses()
        query_knn(Qfull[:n], idx, device=CPU)
        assert engine.MISSES == 1, f"first bucket-{n} batch built nothing?"
        query_knn(Qfull[:n], idx, device=CPU)
        assert engine.MISSES == 1, f"second bucket-{n} batch built an entry"


def test_config_fingerprints_never_collide():
    """Distinct query configs occupy distinct entries at one bucket, each
    serving its own answers; host-only knobs share one."""
    X = _data(18)
    idx = _index(X)
    Q = _data(19, m=16)
    r5 = query_knn(Q, idx, device=CPU)
    r6 = query_knn(Q, idx, device=CPU, k=6)
    r5b = query_knn(Q, idx, device=CPU, topk_method="block")
    rs = query_knn(Q, idx, device=CPU, merge_schedule="stream")
    query_knn(Q, idx, device=CPU, dispatch_depth=3)  # host-only: no entry
    assert len(idx._cache) == 4
    assert {b for b, _ in idx._cache} == {16}
    assert r6.ids.shape == (16, 6)
    assert torch.equal(r5.ids, r6.ids[:, :5])
    assert torch.equal(r5.ids, r5b.ids) and torch.equal(r5.ids, rs.ids)


def test_entry_shapes_cover_the_bucket():
    idx = _index(_data(20))
    for bucket in (16, 32, 128):
        ex = get_executable(idx, idx.cfg, bucket)
        assert ex.q_pad >= bucket and ex.q_pad % ex.q_tile == 0


# ---------------------------------------------------------------------------
# the streaming session


def test_stream_order_latency_and_depth():
    X = _data(21)
    idx = _index(X, dispatch_depth=2)
    session = ServeSession(idx, device=CPU)
    batches = [_data(22 + i, m=n) for i, n in enumerate((16, 16, 10, 16))]
    out = list(session.stream(iter(batches)))
    assert [r.rows for r in out] == [16, 16, 10, 16]
    assert [r.seq for r in out] == [0, 1, 2, 3]
    assert session.queries_served == 58
    assert len(session.latencies) == 4
    assert all(lat > 0 for lat in session.latencies)
    assert not session._inflight
    for q, r in zip(batches, out):
        want = all_knn(X, queries=q, config=idx.cfg, device=CPU)
        np.testing.assert_array_equal(want.ids.numpy(), r.ids)
        assert r.dists_padded.shape == (r.bucket, 5)


def test_stream_depth_bounds_the_batches_in_flight():
    idx = _index(_data(26), dispatch_depth=3)
    session = ServeSession(idx, device=CPU)
    q = _data(27, m=16)
    assert session.submit(q) == [] and session.submit(q) == []
    assert len(session._inflight) == 2
    assert len(session.submit(q)) == 1  # the third retires the first
    assert len(session.drain()) == 2


def test_stream_depth_one_is_synchronous():
    idx = _index(_data(28), dispatch_depth=1)
    session = ServeSession(idx, device=CPU)
    done = session.submit(_data(29, m=16))
    assert len(done) == 1 and done[0].latency_s is not None
    assert not session._inflight


def test_session_reusable_across_streams():
    X = _data(30)
    idx = _index(X)
    session = ServeSession(idx, device=CPU)
    q = _data(31, m=16)
    out1 = list(session.stream([q, _data(32, m=10)]))
    assert session.queries_served == 26 and len(session.latencies) == 2
    engine.reset_misses()
    session.reset_stats()
    assert session.queries_served == 0 and session.latencies == []
    assert session.tenant_stats == {}
    out2 = list(session.stream([q]))
    assert engine.MISSES == 0
    assert session.queries_served == 16 and len(session.latencies) == 1
    assert out2[0].seq == out1[-1].seq + 1
    np.testing.assert_array_equal(out1[0].ids, out2[0].ids)
    np.testing.assert_array_equal(out1[0].dists, out2[0].dists)


def test_reset_mid_flight_lands_batch_in_new_window():
    idx = _index(_data(33), dispatch_depth=4)
    session = ServeSession(idx, device=CPU)
    session.submit(_data(34, m=16), tenant="t")
    assert session._inflight
    session.reset_stats()
    done = session.drain()
    assert len(done) == 1
    assert session.queries_served == 16 and len(session.latencies) == 1
    assert session.tenant_stats["t"]["queries"] == 16


def test_tenant_stats_and_snapshot():
    idx = _index(_data(35))
    session = ServeSession(idx, device=CPU)
    list(session.stream([_data(36, m=16), _data(37, m=8)], tenant="a"))
    session.submit(_data(38, m=16))  # untagged: attributes nothing
    session.drain()
    st = session.tenant_stats
    assert st == {"a": st["a"]} and st["a"]["queries"] == 24
    assert st["a"]["batches"] == 2
    assert st["a"]["latency_sum_s"] >= st["a"]["latency_max_s"] > 0
    snap = session.stats_snapshot()
    assert snap["batches_retired"] == 3 and snap["queries_served"] == 40
    assert snap["tenants"] == ["a"] and snap["peak_hbm_bytes"] is None
    with pytest.raises(ValueError, match="tenant"):
        session.submit(_data(39, m=8), tenant='bad"id')


def test_warm_reports_its_entries():
    idx = _index(_data(40), dispatch_depth=2)
    session = ServeSession(idx, device=CPU)
    rep = session.warm([1, 16, 17, 40])
    assert (rep["cells"], rep["raw_cells"], rep["deduped"]) == (3, 4, 1)
    assert (rep["built"], rep["reused"]) == (3, 0)
    assert all(e.slots == 2 for e in idx._cache.values())
    assert session.warm([16])["reused"] == 1


# ---------------------------------------------------------------------------
# refusals: what the engine cannot honor fails loudly, in the JAX words


def test_refuses_pallas_cosine():
    with pytest.raises(ValueError, match="cosine"):
        _index(_data(41), "pallas", metric="cosine")


def test_refuses_pallas_non_f32():
    with pytest.raises(ValueError, match="float32"):
        _index(_data(42), "pallas", dtype="bfloat16")


def test_refuses_corpus_side_config_changes():
    idx = _index(_data(43))
    with pytest.raises(ValueError, match="corpus-side"):
        query_knn(_data(44, m=8), idx, device=CPU, corpus_tile=64)
    with pytest.raises(ValueError, match="corpus-side"):
        query_knn(_data(44, m=8), idx, device=CPU, backend="pallas")


def test_refuses_mixed_over_compressed_index():
    idx = _index(_data(45), dtype="bfloat16")
    with pytest.raises(ValueError, match="mixed"):
        query_knn(_data(46, m=8), idx, device=CPU, precision_policy="mixed")


@pytest.mark.parametrize("backend", ["ring", "ring-overlap"])
def test_refuses_unported_ring_serving_by_name(backend):
    with pytest.raises(ValueError, match="not yet ported.*ROADMAP"):
        _index(_data(47), backend, num_devices=2)


def test_refuses_live_mutation_by_name():
    session = ServeSession(_index(_data(48)), device=CPU)
    with pytest.raises(ValueError, match="mutation.*not yet ported"):
        session.upsert([0], _data(49, m=1))
    with pytest.raises(ValueError, match="mutation.*not yet ported"):
        session.delete([0])


def test_refuses_a_device_other_than_the_index():
    idx = _index(_data(50))
    with pytest.raises(ValueError, match="index lives on"):
        query_knn(_data(51, m=8), idx, device="meta")


def test_config_serve_knob_validation():
    with pytest.raises(ValueError, match="query_bucket"):
        KNNConfig(query_bucket=0)
    with pytest.raises(ValueError, match="dispatch_depth"):
        KNNConfig(dispatch_depth=0)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("argv", [
    ["--data", "synthetic:64x8c2"],  # no query stream
    ["--data", "synthetic:64x8c2", "--synthetic", "8", "--backend", "pallas",
     "--metric", "cosine"],  # engine refusal
    ["--data", "synthetic:64x8c2", "--synthetic", "8", "--dtype", "bfloat16",
     "--precision-policy", "mixed"],  # config refusal
    ["--data", "synthetic:64x8c2", "--synthetic", "8", "--backend",
     "ring-overlap"],  # ring serving not ported
    ["--data", "synthetic:64x8c2", "--synthetic", "0"],
    ["--data", "synthetic:64x8c2", "--synthetic", "8", "--batch", "0"],
    ["--data", "synthetic:64x8c2", "--synthetic", "8", "--tenant", 'a"b'],
    ["--data", "synthetic:64x8c2", "--queries", "q.mat"],  # no such file
])
def test_query_cli_refusals_exit_2(argv):
    assert serve_cli.main([*argv, "--device", CPU]) == 2


@pytest.mark.parametrize("flag,value", [
    ("--index-load", "i.npz"), ("--nprobe", "4"), ("--route-cap", "8"),
    ("--devices", "4"), ("--ring-schedule", "bidir"),
    ("--ring-transfer-dtype", "int8"), ("--batch-deadline-ms", "5"),
    ("--retries", "2"), ("--degrade-after", "2"), ("--no-nan-sentinel", None),
    ("--flight-record", "f.jsonl"), ("--metrics-out", "m.json"),
    ("--profile-batches", "4"), ("--profile-dir", "p"), ("--cache-dir", "c"),
])
def test_query_cli_unported_flags_exit_2(flag, value, capsys):
    argv = ["--data", "synthetic:64x8c2", "--synthetic", "8", "--device",
            CPU, flag] + ([value] if value is not None else [])
    assert serve_cli.main(argv) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_query_cli_end_to_end(tmp_path, capsys):
    report = tmp_path / "serve.json"
    rc = serve_cli.main(
        ["--data", "synthetic:128x16c4", "--synthetic", "40", "--batch", "16",
         "--bucket", "16", "--k", "3", "--backend", "pallas", "--tenant",
         "t1", "--report", str(report), "--device", CPU]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "batch 2: rows=8 bucket=16 latency=" in out
    doc = json.loads(report.read_text())
    assert doc["queries"] == 40 and doc["batches"] == 3
    assert doc["backend"] == "pallas" and doc["executables_compiled"] == 1
    assert doc["throughput_qps"] > 0 and doc["latency_p50_ms"] is not None
    assert doc["tenants"]["t1"]["queries"] == 40
    assert doc["peak_hbm_bytes"] is None and doc["device_profile"] is None


def test_query_cli_reached_from_the_package_main(tmp_path):
    from mpi_knn_tpu_torch.cli import main

    Q = _data(52, m=20, d=8)
    np.save(tmp_path / "q.npy", Q)
    report = tmp_path / "r.json"
    assert main(["query", "--data", "synthetic:64x8c2", "--queries",
                 str(tmp_path / "q.npy"), "--batch", "8", "--k", "2",
                 "--device", CPU, "--report", str(report), "-q"]) == 0
    assert json.loads(report.read_text())["queries"] == 20


def test_report_keys_equal_the_jax_serving_summary(tmp_path):
    argv = ["--data", "synthetic:128x16c4", "--synthetic", "24", "--batch",
            "16", "--bucket", "16", "--k", "3", "--backend", "serial",
            "--tenant", "t", "-q"]
    mine, ref = tmp_path / "port.json", tmp_path / "jax.json"
    assert serve_cli.main([*argv, "--device", CPU, "--report", str(mine)]) == 0
    assert jax_serve_cli.main([*argv, "--report", str(ref)]) == 0
    got, want = json.loads(mine.read_text()), json.loads(ref.read_text())
    assert set(got) == set(want)
    assert set(got["tenants"]["t"]) == set(want["tenants"]["t"])
    for key in ("corpus", "shape", "backend", "k", "queries", "batches"):
        assert got[key] == want[key]
