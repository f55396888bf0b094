"""The port's observability layer (``mpi_knn_tpu_torch/obs/``) against the
JAX package's ``mpi_knn_tpu.obs`` on the CPU.

- metrics: the same seeded observations give equal registry snapshots and
  the same Prometheus text in both packages; each package's strict parser
  reads the other's exposition; the validations refuse the same inputs;
  snapshots load across packages, a doctor verdict unwrapped;
- the port's compile capture (nvcc builds and serving entry builds, the
  reference's ``jax_compiles_total`` counterpart) through
  ``watch_compiles`` and the shared registry;
- spans: the same span sequence gives files that both packages'
  ``validate_flight`` accept with 0 problems and that the reference's
  ``reconstruct_spans`` rebuilds the same way; the ring rotation, the torn
  tail, the open span of a killed process, the Chrome export;
- the serving session's flight record: batches, retries and the rung walk
  reconstruct; poisoned, exhausted and failed-build batches close their
  spans; a SIGKILLed worker leaves its open batch span;
- the ``metrics`` subcommand, and the reference's refusals.
"""

import json
import math
import os
import textwrap

import numpy as np
import pytest

from mpi_knn_tpu.obs import metrics as jm
from mpi_knn_tpu.obs import spans as js
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch import cli as port_cli
from mpi_knn_tpu_torch.obs import cli as pcli
from mpi_knn_tpu_torch.obs import metrics as pm
from mpi_knn_tpu_torch.obs import spans as ps
from mpi_knn_tpu_torch.resilience import ResiliencePolicy, install_faults
from mpi_knn_tpu_torch.resilience.ladder import FULL_RUNG
from mpi_knn_tpu_torch.serve import ServeSession, build_index

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_recorder():
    """The span helpers are process-global: a test that installs a recorder
    never leaks it into the next test's serving."""
    yield
    ps.set_recorder(None)


def _observe(mod, seed: int):
    """A seeded sequence of observations into a fresh registry of ``mod``
    (either package's metrics module)."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    reg.counter("req_total", help="requests").inc(float(rng.integers(1, 9)))
    for t in ("a", "b"):
        reg.counter("serve_tenant_queries_total", help="rows per tenant",
                    labels={"tenant": t}).inc(float(rng.integers(1, 100)))
    reg.gauge("serve_ladder_rung", help="rung").set(float(rng.integers(0, 3)))
    reg.gauge("depth").add(float(rng.standard_normal()))
    h = reg.histogram("serve_batch_latency_seconds", help="latency")
    for v in rng.exponential(0.02, size=50):
        h.observe(float(v))
    return reg


def _cfg(**kw):
    kw.setdefault("k", 4)
    kw.setdefault("query_tile", 16)
    kw.setdefault("corpus_tile", 32)
    kw.setdefault("query_bucket", 16)
    kw.setdefault("dispatch_depth", 1)
    return KNNConfig(backend="serial", **kw)


def _index(rng, m=96, d=12, **kw):
    X = rng.standard_normal((m, d)).astype(np.float32)
    return build_index(X, _cfg(**kw), device=CPU)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# metrics against the reference


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_observations_give_equal_snapshots_and_exposition(seed):
    want, got = _observe(jm, seed), _observe(pm, seed)
    assert got.snapshot() == want.snapshot()
    text = got.to_prometheus()
    assert text == want.to_prometheus()
    # each package's strict parser reads the other's exposition
    assert pm.parse_prometheus(want.to_prometheus()) == jm.parse_prometheus(text)


@pytest.mark.parametrize("q", [0, 25, 50, 90, 99, 100])
def test_histogram_percentiles_equal_the_reference(q):
    rng = np.random.default_rng(5)
    hs = [mod.Histogram("h", buckets=(0.001, 0.01, 0.1, 1.0)) for mod in (jm, pm)]
    for v in rng.exponential(0.05, size=200):
        for h in hs:
            h.observe(float(v))
    assert hs[0].percentile(q) == hs[1].percentile(q)
    assert math.isnan(pm.Histogram("e").percentile(50))


@pytest.mark.parametrize("bad", [
    lambda mod: mod.Counter("c").inc(-1.0),
    lambda mod: mod.Counter("c").inc(math.nan),
    lambda mod: mod.Gauge("g").set(math.inf),
    lambda mod: mod.Gauge("g").add(math.nan),
    lambda mod: mod.Histogram("h").observe(math.nan),
    lambda mod: mod.Histogram("h", buckets=()),
    lambda mod: mod.Histogram("h", buckets=(2.0, 1.0)),
    lambda mod: mod.Histogram("h").percentile(101),
    lambda mod: mod.sample_name("9bad"),
    lambda mod: mod.sample_name("ok", {"t": 'a"b'}),
    lambda mod: mod.sample_name("ok", {"bad:label": "x"}),
    lambda mod: mod.MetricsRegistry().histogram("h", labels={"t": "a"}),
], ids=["neg", "nan", "gauge-inf", "gauge-nan", "hist-nan", "no-buckets",
        "unsorted", "q101", "name", "quote", "label-colon", "hist-labels"])
def test_validation_refuses_what_the_reference_refuses(bad):
    for mod in (jm, pm):
        with pytest.raises(ValueError):
            bad(mod)


def test_registry_kind_collisions_raise_as_in_the_reference():
    for mod in (jm, pm):
        reg = mod.MetricsRegistry()
        c = reg.counter("x")
        assert reg.counter("x") is c
        with pytest.raises(ValueError):
            reg.gauge("x")
        reg.counter("fam", labels={"t": "a"})
        with pytest.raises(ValueError):
            reg.gauge("fam")  # one family, one kind, across label sets
        reg.histogram("lat", buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            reg.histogram("lat", buckets=(1.0, 3.0))
    assert pm.sample_name("n", {"b": 1, "a": "x"}) == \
        jm.sample_name("n", {"b": 1, "a": "x"}) == 'n{a="x",b="1"}'


@pytest.mark.parametrize("bad", ["", "9leading 1", "name&bad 1",
                                 "name not-a-number", "dup 1\ndup 2",
                                 'unterminated{le="x 1'])
def test_parse_prometheus_rejects_what_the_reference_rejects(bad):
    for mod in (jm, pm):
        with pytest.raises(ValueError):
            mod.parse_prometheus(bad)


def test_snapshots_load_across_packages_and_a_verdict_unwraps(tmp_path):
    p, j = tmp_path / "port.json", tmp_path / "jax.json"
    p.write_text(json.dumps(_observe(pm, 3).snapshot()))
    j.write_text(json.dumps(_observe(jm, 3).snapshot()))
    assert pm.load_snapshot(str(j)) == jm.load_snapshot(str(p))
    verdict = tmp_path / "verdict.json"
    verdict.write_text(json.dumps({"ok": True, "metrics":
                                   _observe(pm, 3).snapshot()}))
    assert pm.load_snapshot(str(verdict)) == jm.load_snapshot(str(verdict))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"hello": "world"}))
    for mod in (jm, pm):
        with pytest.raises(ValueError):
            mod.load_snapshot(str(bad))


def test_watch_compiles_counts_both_kinds_and_feeds_the_registry():
    reg = pm.get_registry()
    n0 = reg.counter("nvcc_builds_total").value
    e0 = reg.counter("serve_entry_builds_total").value
    with pm.watch_compiles() as outer:
        pm.record_compile("nvcc", 12.5)
        with pm.watch_compiles() as inner:
            pm.record_compile("entry", 0.002)
    pm.record_compile("entry", 0.001)  # outside every scope
    assert outer == ["nvcc", "entry"] and inner == ["entry"]
    assert reg.counter("nvcc_builds_total").value == n0 + 1
    assert reg.counter("serve_entry_builds_total").value == e0 + 2
    assert reg.histogram("nvcc_build_seconds",
                         buckets=pm.COMPILE_BUCKETS_S).count >= 1
    with pytest.raises(ValueError):
        pm.record_compile("xla", 1.0)
    assert not any(n.startswith("jax_") for n in reg.snapshot()["metrics"])


def test_steady_state_serving_builds_nothing_by_the_registry(rng):
    sess = ServeSession(_index(rng), device=CPU)
    sess.warm([16, 32])
    sizes = (5, 16, 17, 32, 9)
    reg = pm.get_registry()
    batches0 = reg.counter("serve_batches_total").value
    lat0 = reg.histogram("serve_batch_latency_seconds").count
    with pm.watch_compiles() as builds:
        for rows in sizes:
            sess.submit(rng.standard_normal((rows, 12)).astype(np.float32))
        sess.drain()
    assert builds == []
    assert reg.counter("serve_batches_total").value == batches0 + 5
    assert reg.histogram("serve_batch_latency_seconds").count == lat0 + 5


# ---------------------------------------------------------------------------
# spans against the reference


def _write_sequence(mod, path, seed):
    """The same seeded span sequence through either package's recorder."""
    rng = np.random.default_rng(seed)
    rec = mod.FlightRecorder(path, fresh=True)
    for b in range(4):
        with rec.span("batch", cat="serve", seq=b, rung=FULL_RUNG) as sid:
            with rec.span("compile", cat="compile", bucket=16):
                pass
            if rng.random() < 0.5:
                rec.event("retry", cat="retry", seq=b, retries=1)
        assert isinstance(sid, int)
    rec.begin("batch", cat="serve", seq=4)  # left open: the kill diagnosis
    rec.close()


def _shape(spans_events):
    spans, events = spans_events
    return ([(s["name"], s["cat"], s["attrs"], s["dur_s"] is None,
              s["end_attrs"]) for s in spans],
            [(e["name"], e["cat"], e.get("attrs")) for e in events])


@pytest.mark.parametrize("seed", [0, 1])
def test_same_spans_give_files_both_validators_accept(tmp_path, seed):
    p, j = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    _write_sequence(ps, p, seed)
    _write_sequence(js, j, seed)
    for path in (p, j):
        for reader in (ps, js):
            recs = reader.read_flight(path)
            assert ps.validate_flight(recs) == [] and js.validate_flight(recs) == []
    assert _shape(js.reconstruct_spans(js.read_flight(p))) == \
        _shape(js.reconstruct_spans(js.read_flight(j)))
    summary = ps.summarize_flight(ps.read_flight(p))
    assert summary["open_spans"] == [
        {"name": "batch", "cat": "serve", "attrs": {"seq": 4}}]
    assert summary == {**js.summarize_flight(js.read_flight(p))}
    trace = ps.to_chrome_trace(ps.read_flight(p))
    assert trace == js.to_chrome_trace(js.read_flight(p))
    assert [e["ph"] for e in trace["traceEvents"]].count("B") == 1


def test_validate_flight_refuses_what_the_reference_refuses():
    ok_b = {"ev": "B", "span": 1, "parent": None, "name": "a", "cat": "",
            "ts": 1.0, "pid": 1, "tid": 1}
    cases = [
        [{"ev": "Z", "ts": 1.0}],
        [{"ev": "B", "span": 1, "name": "a", "ts": -5.0, "pid": 1}],
        [ok_b, {"ev": "E", "span": 1, "ts": 2.0, "dur_s": -0.1}],
        [ok_b, {"ev": "E", "span": 1, "ts": 2.0, "dur_s": math.nan}],
        [{"ev": "E", "span": 9, "ts": 1.0, "dur_s": 0.1}],
        [{"ev": "B", "span": 2, "parent": 99, "name": "b", "ts": 1.0, "pid": 1}],
        [ok_b, dict(ok_b)],
        [{"ev": "I", "cat": "", "ts": 1.0, "pid": 1}],
        [{"ev": "?", "raw": "garbage"}],
    ]
    for records in cases:
        got = ps.validate_flight(records)
        assert got and got == js.validate_flight(records)


def test_ring_rotation_and_the_rotated_prefix(tmp_path):
    path = str(tmp_path / "ring.jsonl")
    rec = ps.FlightRecorder(path, max_bytes=4096)
    for i in range(400):
        with rec.span("batch", cat="serve", i=i, pad="x" * 64):
            pass
    rec.close()
    assert os.path.getsize(path) <= 4096 and os.path.getsize(path + ".1") <= 4096
    records = ps.read_flight(path)
    assert records[0]["ev"] == "R"
    assert ps.validate_flight(records) == [] and js.validate_flight(records) == []
    with pytest.raises(ValueError):
        ps.FlightRecorder(str(tmp_path / "tiny"), max_bytes=100)


def test_torn_tail_skipped_interior_garbage_reported(tmp_path):
    p = tmp_path / "f.jsonl"
    p.write_text('{"ev":"I","name":"a","cat":"","ts":1.0,"pid":1}\n'
                 "interior-garbage\n"
                 '{"ev":"I","name":"b","cat":"","ts":2.0,"pid":1}\n'
                 '{"ev":"B","span":3,"name":"torn-by-the-ki')
    records = ps.read_flight(str(p))
    assert records == js.read_flight(str(p))
    assert any("unparseable" in pb for pb in ps.validate_flight(records))


def test_span_helpers_noop_without_recorder_and_env_arms_them(tmp_path,
                                                             monkeypatch):
    monkeypatch.delenv(ps.RECORDER_ENV, raising=False)
    ps.event("nothing")
    assert ps.begin_span("x") is None
    ps.end_span(None)
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(ps.RECORDER_ENV, path)
    with ps.span("from-env", cat="serve"):
        pass
    ps.get_recorder().close()
    assert [s["name"] for s in js.reconstruct_spans(js.read_flight(path))[0]] == [
        "from-env"]


# ---------------------------------------------------------------------------
# the serving session's flight record


def test_flight_reconstructs_batches_retries_and_rung_walk(rng, tmp_path):
    path = str(tmp_path / "flight.jsonl")
    ps.set_recorder(ps.FlightRecorder(path, fresh=True))
    idx = _index(rng, m=128, d=16)
    pol = ResiliencePolicy(max_retries=3, backoff_base_s=0.01,
                           batch_deadline_s=0.25, degrade_after=1,
                           min_bucket=8)
    sess = ServeSession(idx, resilience=pol, device=CPU)
    sess.warm([8])
    Q = rng.standard_normal((8, 16)).astype(np.float32)
    with install_faults({"serve-batch": ("transient", 2)}):
        sess.submit(Q)  # batch 0: retried twice, then served
    with install_faults({"serve-batch": ("slow", 0.5)}):
        sess.submit(Q)  # batch 1: breaches the deadline, a rung is shed
    sess.submit(Q)  # batch 2: at the shed rung
    ps.set_recorder(None)

    records = ps.read_flight(path)
    assert ps.validate_flight(records) == [] and js.validate_flight(records) == []
    spans, events = js.reconstruct_spans(records)
    assert any(s["name"] == "index-build" and s["cat"] == "index" for s in spans)
    assert any(s["name"] == "compile" and s["cat"] == "compile" for s in spans)
    batches = sorted((s for s in spans if s["name"] == "batch"),
                     key=lambda s: s["attrs"]["seq"])
    assert [b["attrs"]["seq"] for b in batches] == [0, 1, 2]
    for b, lat in zip(batches, sess.latencies):
        assert b["end_attrs"]["latency_s"] == lat
    assert batches[0]["end_attrs"]["retries"] == 2
    assert batches[1]["end_attrs"]["deadline_breached"] is True
    assert batches[0]["attrs"]["rung"] == FULL_RUNG
    assert batches[2]["attrs"]["rung"] == sess.ladder[1][0]
    retry = next(e for e in events if e["name"] == "retry")
    assert retry["attrs"] == {"seq": 0, "retries": 2, "backoffs": [0.01, 0.02]}
    degrade = next(e for e in events if e["name"] == "degrade")
    assert degrade["attrs"]["after_batch"] == 1
    assert degrade["attrs"]["rung"] == batches[2]["attrs"]["rung"]
    assert any(e["name"] == "beat" for e in events)


def test_poisoned_exhausted_and_failed_build_batches_close_their_spans(
        rng, tmp_path, monkeypatch):
    from mpi_knn_tpu_torch.resilience import PoisonedResultError, RetryExhausted
    from mpi_knn_tpu_torch.serve import engine

    path = str(tmp_path / "flight.jsonl")
    ps.set_recorder(ps.FlightRecorder(path, fresh=True))
    sess = ServeSession(_index(rng),
                        resilience=ResiliencePolicy(max_retries=1,
                                                    backoff_base_s=0.01),
                        device=CPU)
    sess.warm([16])
    Q = rng.standard_normal((16, 12)).astype(np.float32)
    with install_faults({"serve-nan": "nan"}):
        with pytest.raises(PoisonedResultError):
            sess.submit(Q)
    with install_faults({"serve-batch": ("transient", 5)}):
        with pytest.raises(RetryExhausted):
            sess.submit(Q)

    def boom(*a, **k):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(engine, "_new_entry", boom)
    with pytest.raises(RuntimeError):
        sess.submit(rng.standard_normal((40, 12)).astype(np.float32))
    monkeypatch.undo()
    sess.submit(Q)  # the session serves on
    sess.drain()
    ps.set_recorder(None)

    records = ps.read_flight(path)
    assert ps.validate_flight(records) == [] and js.validate_flight(records) == []
    spans, _ = js.reconstruct_spans(records)
    batches = [s for s in spans if s["name"] == "batch"]
    assert len(batches) == 4 and all(s["dur_s"] is not None for s in batches)
    errors = [s["end_attrs"].get("error") for s in batches]
    assert errors == ["poisoned-result", "RetryExhausted", "RuntimeError", None]
    comp = [s for s in spans if s["name"] == "compile"]
    assert any(s["end_attrs"].get("error") == "RuntimeError" for s in comp)
    assert ps.summarize_flight(records)["open_spans"] == []


def test_flight_record_survives_sigkill_of_worker_mid_stream(tmp_path):
    from mpi_knn_tpu_torch.resilience import run_supervised
    from mpi_knn_tpu_torch.resilience.worker import python_worker_argv

    script = textwrap.dedent("""
        import os, signal, threading
        import numpy as np
        from mpi_knn_tpu_torch import KNNConfig
        from mpi_knn_tpu_torch.serve import ServeSession, build_index

        rng = np.random.default_rng(0)
        X = rng.standard_normal((96, 8)).astype(np.float32)
        cfg = KNNConfig(backend="serial", k=3, query_tile=16,
                        corpus_tile=32, query_bucket=16, dispatch_depth=1)
        sess = ServeSession(build_index(X, cfg, device="cpu"), device="cpu")
        sess.warm([16])
        Q = rng.standard_normal((16, 8)).astype(np.float32)
        sess.submit(Q)
        sess.submit(Q)
        # batch 2 hangs at the fault site; the timer SIGKILLs this
        # process mid-batch: no cleanup, no atexit
        threading.Timer(1.0, lambda: os.kill(os.getpid(), signal.SIGKILL)).start()
        sess.submit(Q)
    """)
    flight = str(tmp_path / "flight.jsonl")
    env = dict(os.environ, TKNN_FAULTS="serve-batch=hang:3")
    res = run_supervised(python_worker_argv("-c", script), env=env, cwd=REPO,
                         beat_timeout_s=None, wall_timeout_s=120.0,
                         flight_path=flight)
    assert res.status == "crashed", res.stderr_tail
    assert res.flight is not None and res.flight["records"] > 0
    assert any(s["name"] == "batch" for s in res.flight["open_spans"])
    spans, _ = js.reconstruct_spans(js.read_flight(flight))
    batches = sorted((s for s in spans if s["name"] == "batch"),
                     key=lambda s: s["attrs"]["seq"])
    assert [b["attrs"]["seq"] for b in batches] == [0, 1, 2]
    assert [b["dur_s"] is None for b in batches] == [False, False, True]


# ---------------------------------------------------------------------------
# the metrics subcommand


def _snapshot_file(tmp_path):
    p = tmp_path / "snap.json"
    p.write_text(json.dumps(_observe(pm, 4).snapshot()))
    return str(p)


def test_metrics_cli_renders_and_checks_a_snapshot(tmp_path, capsys):
    from mpi_knn_tpu.obs import cli as jcli

    snap = _snapshot_file(tmp_path)
    assert pcli.main([snap]) == 0
    got = capsys.readouterr().out
    assert jcli.main([snap]) == 0
    assert got == capsys.readouterr().out
    assert pcli.main([snap, "--check"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert pcli.main([snap, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out) == pm.load_snapshot(snap)
    assert port_cli.main(["metrics", snap]) == 0  # routed by the run CLI
    assert "req_total" in capsys.readouterr().out


def test_metrics_cli_flight_modes(tmp_path, capsys):
    path = str(tmp_path / "f.jsonl")
    _write_sequence(ps, path, 0)
    assert pcli.main(["--flight", path]) == 0
    assert json.loads(capsys.readouterr().out)["open_spans"][0]["name"] == "batch"
    assert pcli.main(["--flight", path, "--validate"]) == 0
    assert json.loads(capsys.readouterr().out)["problems"] == 0
    out = str(tmp_path / "trace.json")
    assert pcli.main(["--flight", path, "--validate", "--chrome", out]) == 0
    capsys.readouterr()
    assert json.loads(open(out).read())["traceEvents"]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"ev":"E","span":5,"ts":1.0,"dur_s":0.1}\n')
    assert pcli.main(["--flight", str(bad), "--validate"]) == 1
    capsys.readouterr()


@pytest.mark.parametrize("argv,rc", [
    ([], 2),
    (["--validate", "SNAP"], 2),
    (["--chrome", "x.json", "SNAP"], 2),
    (["--flight", "FLIGHT", "--check"], 2),
    (["--flight", "FLIGHT", "--format", "json"], 2),
    (["SNAP", "--flight", "FLIGHT"], 2),
    (["MISSING"], 1),
])
def test_metrics_cli_refusals_equal_the_reference(tmp_path, capsys, argv, rc):
    from mpi_knn_tpu.obs import cli as jcli

    flight = str(tmp_path / "f.jsonl")
    _write_sequence(ps, flight, 1)
    subs = {"SNAP": _snapshot_file(tmp_path), "FLIGHT": flight,
            "MISSING": str(tmp_path / "missing.json")}
    argv = [subs.get(a, a) for a in argv]
    assert pcli.main(argv) == rc
    assert jcli.main(argv) == rc
    capsys.readouterr()
