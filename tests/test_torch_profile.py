"""The profile surface of the port (``obs/kineto.py``, ``obs/
attribution.py``, ``ServeSession.profile``, ``query --profile-batches``)
against the JAX package's ``obs/xplane.py`` / ``obs/attribution.py``.

One event list is written twice: as an XPlane wire fixture for the
reference's ``parse_xplane_bytes`` and as a Kineto (Chrome trace) JSON for
the port's ``parse_trace_bytes``; both parsers must give the same events,
and both ``analyze`` / ``attribute_trace`` the same reports, key for key.
"""

import gzip
import json

import numpy as np
import pytest

from mpi_knn_tpu.obs import attribution as jax_attribution
from mpi_knn_tpu.obs import xplane as jax_xplane
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch.obs import attribution, kineto

CPU = "cpu"
PLANE = "/device:GPU:0"

# (name, start ns, duration ns): flat device events, XLA-style names so both
# packages' categories agree; async collective start/done pairs, a dma wait
EVENTS = [
    ("fusion.1", 1_000, 4_000), ("dot.2", 5_500, 2_000),
    ("all-reduce-start.3", 6_000, 500), ("all-reduce-done.3", 9_000, 700),
    ("copy.4", 10_000, 1_250), ("sort.5", 12_000, 3_000),
    ("custom-call.6", 15_500, 250), ("dma-wait.7", 16_000, 1_000),
    ("fusion.1", 18_000, 4_000), ("collective-permute.8", 19_000, 2_500),
]
HOST = [("python-op", 500, 800), ("dispatch", 2_000, 300)]


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _field(no: int, payload) -> bytes:
    if isinstance(payload, int):
        return _varint(no << 3) + _varint(payload)
    if isinstance(payload, str):
        payload = payload.encode()
    return _varint(no << 3 | 2) + _varint(len(payload)) + payload


def _plane(name: str, line: str, events) -> bytes:
    names = sorted({n for n, _, _ in events})
    meta = b"".join(_field(4, _field(1, i + 1) + _field(2, _field(1, i + 1)
                                                        + _field(2, n)))
                    for i, n in enumerate(names))
    evs = b"".join(_field(4, _field(1, names.index(n) + 1)
                          + _field(2, s * 1000) + _field(3, d * 1000))
                   for n, s, d in events)
    return _field(2, name) + meta + _field(3, _field(2, line) + _field(3, 0)
                                          + evs)


def xplane_fixture() -> bytes:
    return (_field(1, _plane(PLANE, "stream 7", EVENTS))
            + _field(1, _plane("/host:CPU", "thread 1", HOST)))


def kineto_fixture() -> dict:
    ev = [{"ph": "X", "cat": "kernel", "name": n, "pid": 0, "tid": 7,
           "ts": s / 1000, "dur": d / 1000,
           "args": {"device": 0, "stream": 7, "correlation": i}}
          for i, (n, s, d) in enumerate(EVENTS)]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 9, "tid": 1,
            "ts": s / 1000, "dur": d / 1000, "args": {}} for n, s, d in HOST]
    # records that are not operations, and the window's primer (torch's
    # spin kernel, utils/timing.profile_trace): left out by the parser
    ev += [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 0.5, "dur": 0.5,
            "name": "at::cuda::(anonymous namespace)::spin_kernel(long)",
            "args": {"device": 0, "stream": 7}},
           {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": 9,
            "tid": 1, "ts": 0.0, "dur": 100.0},
           {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
           {"ph": "i", "name": "Iteration Start", "pid": 9, "ts": 0.0}]
    return {"schemaVersion": 1, "traceEvents": ev}


def _key(e):
    return (e["plane"], e["name"], e["start_ps"], e["dur_ps"])


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_parse_and_analyze_equal_the_reference(gz, tmp_path):
    raw = json.dumps(kineto_fixture()).encode()
    if gz:
        raw = gzip.compress(raw)
    port = kineto.parse_trace_bytes(raw)
    ref = jax_xplane.parse_xplane_bytes(xplane_fixture())
    assert sorted(map(_key, port)) == sorted(map(_key, ref))
    assert kineto.analyze(port) == jax_xplane.analyze(ref)
    # attribute_trace over a directory of each
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    name = "w.pt.trace.json" + (".gz" if gz else "")
    (tmp_path / "port" / name).write_bytes(raw)
    (tmp_path / "ref" / "w.xplane.pb").write_bytes(xplane_fixture())
    got = attribution.attribute_trace(str(tmp_path / "port"))
    want = jax_attribution.attribute_trace(str(tmp_path / "ref"))
    assert got == want
    assert got["plane"] == PLANE and got["dma_wait_ms"] == 0.001
    assert got["busy_total_ms"] == pytest.approx(sum(got["busy_ms"].values()),
                                                 abs=1e-9)
    assert 0.0 <= got["overlap_fraction"] <= 1.0


@pytest.mark.parametrize("raw", [
    b'{"traceEvents": [{"ph": "X", "cat": "kernel", "na',  # truncated
    b"\x00\x01garbage\xff",
    b"\x1f\x8b\x08\x00garbage",  # a broken gzip stream
    b'{"traceEvents": 7}',
    b'{"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k", "ts": "1",'
    b' "dur": 1}]}',
    b'{"traceEvents": [{"ph": "X", "cat": "cpu_op", "name": "k", "ts": 1,'
    b' "dur": -1}]}',
], ids=["truncated", "garbage", "bad-gzip", "no-list", "ts-string",
        "negative-dur"])
def test_malformed_traces_raise_parse_error(raw, tmp_path):
    with pytest.raises(kineto.ParseError):
        kineto.parse_trace_bytes(raw)
    assert issubclass(kineto.ParseError, ValueError)
    # attribute_trace names the casualty, never a zero split
    (tmp_path / "bad.json").write_bytes(raw)
    out = attribution.attribute_trace(str(tmp_path))
    assert "error" in out and out["casualties"][0]["file"].endswith("bad.json")


def test_the_reference_parser_refuses_alike():
    """The XPlane parser's own refusal, for the record: the two ParseErrors
    are the same kind of error."""
    with pytest.raises(jax_xplane.ParseError):
        jax_xplane.parse_xplane_bytes(xplane_fixture()[:-3])
    assert attribution.attribute_trace("/nonexistent-dir") == {
        "error": "no trace .json under /nonexistent-dir"}


def test_nested_host_events_count_self_time():
    """aten::linear ⊃ aten::matmul ⊃ aten::mm: the host plane takes self
    time, so the categories sum to the outermost span, not past it."""
    ev = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 1, "tid": 1,
           "ts": s, "dur": d}
          for n, s, d in (("aten::linear", 0.0, 10.0), ("aten::t", 1.0, 1.0),
                          ("aten::matmul", 3.0, 6.0), ("aten::mm", 4.0, 4.0),
                          ("aten::topk", 12.0, 2.0))]
    parsed = kineto.parse_trace_bytes(json.dumps({"traceEvents": ev}).encode())
    rep = kineto.analyze(parsed)["/host:CPU"]
    assert rep["top_ops_ms"] == {"aten::mm": 0.004, "aten::linear": 0.003,
                                 "aten::matmul": 0.002, "aten::topk": 0.002,
                                 "aten::t": 0.001}
    assert sum(rep["busy_ms_by_category"].values()) == pytest.approx(0.012)


def _abutting_trace(n: int, extra=()) -> bytes:
    """A device stream of ``n`` kernels, each starting where the one before
    ends, at a torch.profiler trace's timestamps (``ts`` ≈ 1.46e12 µs, three
    decimals), the bin minimum and an SGEMM in turn; ``extra`` (ts, dur)
    pairs are planted on the same stream. Written as JSON numbers, as
    Kineto writes them."""
    from decimal import Decimal

    ts, out = Decimal("1460000000000.123"), []
    durs = (Decimal("75.211"), Decimal("6.489"))
    rows = []
    for i in range(n):
        rows.append((("sgemm", "warp_chunks_kernel")[i % 2], ts, durs[i % 2]))
        ts += durs[i % 2]
    rows += [("planted", Decimal(a), Decimal(b)) for a, b in extra]
    for name, t, d in rows:
        out.append('{"ph": "X", "cat": "kernel", "name": "%s", "ts": %s, '
                   '"dur": %s, "args": {"device": 0, "stream": 7}}' % (name, t, d))
    return ('{"traceEvents": [' + ", ".join(out) + "]}").encode()


def test_abutting_events_at_trace_timestamps_parse_without_overlap():
    """C.14: 3540 abutting kernels at ts ≈ 1.46e12 µs parse to integer
    picoseconds exactly, so their durations sum to their union on the
    stream and no two overlap. The float parse the port used before reads
    the same events as overlapping (a float64 steps by 244 ps there)."""
    raw = _abutting_trace(3540)
    events = kineto.parse_trace_bytes(raw)
    summed, union = kineto.stream_busy_ps(events, PLANE)
    assert summed == union == 1770 * (75_211_000 + 6_489_000)
    assert kineto.stream_overlaps(events, PLANE) == []
    for a, b in zip(events, events[1:]):
        assert a["start_ps"] + a["dur_ps"] == b["start_ps"]
    floats = [(int(round(float(e["ts"]) * 1e6)), int(round(float(e["dur"]) * 1e6)))
              for e in json.loads(raw)["traceEvents"]]
    assert sum(max(0, s0 + d0 - s1)
               for (s0, d0), (s1, _) in zip(floats, floats[1:])) > 0


@pytest.mark.parametrize("planted", ["duplicate", "inside"])
def test_a_duplicate_or_nested_event_still_fails_the_union(planted):
    """The double-count gate still sees what it is for: an event recorded
    twice, or one whole event inside another on its stream, makes the
    durations exceed the union, and ``stream_overlaps`` names the pair."""
    extra = {"duplicate": [("1460000000000.123", "75.211")],
             "inside": [("1460000000010.5", "2.25")]}[planted]
    events = kineto.parse_trace_bytes(_abutting_trace(8, extra))
    summed, union = kineto.stream_busy_ps(events, PLANE)
    assert summed - union == {"duplicate": 75_211_000, "inside": 2_250_000}[planted]
    pairs = kineto.stream_overlaps(events, PLANE)
    assert len(pairs) == 1 and "planted" in (pairs[0][1], pairs[0][3])
    assert pairs[0][0] == "stream 7"


def test_trace_times_must_be_finite_numbers():
    bad = b'{"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k", ' \
          b'"ts": NaN, "dur": 1.5, "args": {}}]}'
    with pytest.raises(kineto.ParseError, match="not finite"):
        kineto.parse_trace_bytes(bad)


@pytest.mark.parametrize("name,cat", [
    ("(anonymous namespace)::fused_knn_tiles_kernel(CUtensorMap_st, "
     "(anonymous namespace)::ExactEpi<knn::wg::TileItems>)", "matmul"),
    ("void knn::wg::stage_split_kernel<knn::F32Rows>(knn::F32Rows, int)",
     "copy"),
    ("void (anonymous namespace)::warp_chunks_kernel<float>(Args<float>)",
     "sort-topk"),
    ("round_dma_kernel_wgmma(RoundWg)", "matmul"),
    ("Memcpy PtoP (Device -> Device)", "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "copy"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32_cublas",
     "matmul"),
    ("void at::native::radixSortKVInPlace<2, -1>(at::cuda::TensorInfo)",
     "sort-topk"),
    ("aten::addmm", "matmul"),
    ("fusion.3", "matmul"),
    ("custom-call.1", "other"),
])
def test_kernel_table_and_torch_names(name, cat):
    assert kineto.categorize(name) == cat


def test_kernel_symbols():
    assert kineto.kernel_symbol(
        "(anonymous namespace)::fused_knn_tiles_kernel(CUtensorMap_st, "
        "(anonymous namespace)::ExactEpi<knn::wg::TileItems>)"
    ) == "fused_knn_tiles_kernel"
    assert kineto.kernel_symbol(
        "void knn::stage_tf32_kernel<knn::RingCols<0, false, false> >("
        "knn::RingCols<0, false, false>, int, int, float*)"
    ) == "stage_tf32_kernel"
    # every hand kernel of the table belongs to one counter family or is a
    # test hook / a second pass
    family = {s for syms, _ in kineto.KERNEL_FAMILIES for s in syms}
    hooks = {"exact_tile_dots_kernel", "split_tile_dots_kernel",
             "bf16_tile_dots_kernel", "mma_rate_kernel", "wgmma_rate_kernel",
             "merge_lists_kernel"}
    assert set(kineto.KERNEL_CATEGORIES) == family | hooks


def test_launch_mismatches_hold_the_trace_to_the_counters():
    def kern(name):
        return {"plane": PLANE, "line": "stream 7", "name": name,
                "start_ps": 0, "dur_ps": 1}

    events = ([kern("(anonymous namespace)::fused_knn_tiles_kernel(X)")]
              + [kern("void knn::wg::stage_split_kernel<R>(R)")] * 3
              + [kern("void (anonymous namespace)::warp_chunks_kernel<float>(A)")]
              + [kern("void (anonymous namespace)::merge_lists_kernel<float>(A)")])
    counters = {"fused_knn_tiles": 1, "stage_tf32_split": 1,
                "stage_tf32_split[ring]": 2, "approx_min_k": 1}
    assert kineto.launch_mismatches(events, counters) == []
    miss = kineto.launch_mismatches(events, {**counters, "fused_knn_tiles": 2})
    assert miss == [{"symbols": ["fused_knn_tiles_kernel"],
                     "counters": ["fused_knn_tiles"], "trace": 1, "counted": 2}]


# ---------------------------------------------------------------------------
# ServeSession.profile and the CLIs on the CPU


def _session(rng, **kw):
    from mpi_knn_tpu_torch.serve import ServeSession, build_index

    X = rng.standard_normal((96, 12)).astype(np.float32)
    cfg = KNNConfig(backend="serial", k=3, query_tile=16, corpus_tile=32,
                    query_bucket=16, dispatch_depth=1, **kw)
    return ServeSession(build_index(X, cfg, device=CPU), device=CPU)


def test_profile_device_time_split_sums_to_busy_total(tmp_path):
    rng = np.random.default_rng(0)
    sess = _session(rng)
    sess.warm([16])
    Q = rng.standard_normal((16, 12)).astype(np.float32)
    want = [r.ids for r in sess.stream([Q, Q])]
    served = sess.queries_served
    out = sess.profile([Q, Q], trace_dir=str(tmp_path / "prof"))
    assert out["batches_profiled"] == 2
    assert out["trace_dir"] == str(tmp_path / "prof")
    assert out["plane"] == "/host:CPU" and out["busy_total_ms"] > 0
    assert set(out["busy_ms"]) <= {"matmul", "sort-topk", "collective",
                                   "copy", "other", "dma-wait"}
    assert all(v >= 0 for v in out["busy_ms"].values())
    assert out["busy_total_ms"] == pytest.approx(sum(out["busy_ms"].values()),
                                                 abs=1e-6)
    assert out["dma_wait_ms"] == 0.0 and out["overlap_fraction"] is None
    # the window built nothing, launched no kernel (the CPU runs the plain
    # versions), and served the two batches through the session
    assert out["compiles_in_window"] == [] and out["kernel_launches"] == {}
    assert sess.queries_served == served + 32
    assert out["wall_ms"] > 0
    assert all(np.array_equal(w, want[0]) for w in want)


def test_profile_builds_an_unserved_bucket_before_the_trace(tmp_path):
    from mpi_knn_tpu_torch.obs.spans import (
        FlightRecorder,
        read_flight,
        reconstruct_spans,
        set_recorder,
    )

    rng = np.random.default_rng(1)
    path = str(tmp_path / "flight.jsonl")
    set_recorder(FlightRecorder(path, fresh=True))
    try:
        sess = _session(rng)
        sess.warm([16])
        # 48 rows pad to bucket 64, which warm() never built
        Q = rng.standard_normal((48, 12)).astype(np.float32)
        out = sess.profile([Q], trace_dir=str(tmp_path / "trace"))
    finally:
        set_recorder(None)
    spans, _ = reconstruct_spans(read_flight(path))
    prof = next(s for s in spans if s["name"] == "profile")
    compiles = [s for s in spans if s["name"] == "compile"]
    assert any(s["attrs"]["bucket"] == 64 for s in compiles)
    assert all(s["ts"] + s["dur_s"] <= prof["ts"] for s in compiles)
    assert out["compiles_in_window"] == []


def test_query_cli_profile_batches_reports_device_time(tmp_path, capsys):
    from mpi_knn_tpu_torch.serve import cli as serve_cli

    report = tmp_path / "r.json"
    tdir = tmp_path / "trace"
    assert serve_cli.main(["--data", "synthetic:128x16c4", "--synthetic", "40",
                           "--batch", "16", "--bucket", "16", "--k", "3",
                           "--backend", "serial", "--profile-batches", "2",
                           "--profile-dir", str(tdir), "--report", str(report),
                           "--device", CPU, "-q"]) == 0
    doc = json.loads(report.read_text())["device_time"]
    assert doc["batches_profiled"] == 2 and doc["trace_dir"] == str(tdir)
    assert (tdir / "trace.json").exists()
    assert doc["busy_total_ms"] == pytest.approx(sum(doc["busy_ms"].values()),
                                                 abs=1e-6)
    base = ["--data", "synthetic:64x8c2", "--synthetic", "8", "--device", CPU]
    assert serve_cli.main(base + ["--profile-dir", str(tdir)]) == 2
    assert "--profile-dir without --profile-batches" in capsys.readouterr().err
    assert serve_cli.main(base + ["--profile-batches", "0"]) == 2
    assert "--profile-batches must be >= 1" in capsys.readouterr().err


def test_run_cli_profile_trace_is_attributable(tmp_path):
    from mpi_knn_tpu_torch.cli import main

    tdir = tmp_path / "run-trace"
    assert main(["--data", "synthetic:256x16c4", "--k", "5", "--loo",
                 "--device", CPU, "--profile", str(tdir), "-q"]) == 0
    out = attribution.attribute_trace(str(tdir))
    assert "error" not in out and out["busy_total_ms"] > 0
    assert out["plane"] == "/host:CPU"
    assert out["busy_ms"].get("matmul", 0) > 0  # aten::mm, self time


def test_lazy_exports():
    import mpi_knn_tpu_torch.obs as obs

    assert obs.attribute_trace is attribution.attribute_trace
    assert obs.ParseError is kineto.ParseError
    assert obs.parse_trace is kineto.parse_trace
    assert obs.pick_device_plane({"/host:CPU": {"busy_ms_by_category": {}}}) \
        == "/host:CPU"
