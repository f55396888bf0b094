"""The port's serving front end over a real session on the CPU, held
against the JAX package's.

- Parity: a JAX ``ServeSession`` behind the reference ``Frontend`` and a
  port ``ServeSession(device="cpu")`` behind the port's, on one small
  corpus (the config carried across by ``convert.config_from_reference``),
  answer the same concurrent HTTP requests alike: per-ticket ids agree up
  to distance ties (``tests/oracle.py::recall_against_oracle``) and
  distances are allclose in f32. ``/healthz`` has the same keys (and the
  same index facts), ``/metrics`` re-parses strictly with the same
  families, and the 400 / 404 / 409 / 429 / 503 answers and the session's
  ``tenants=`` checks match.
- The reference's own cases, run against the port: the HTTP shell
  (``tests/test_frontend_server.py``), coalesced serving against a real
  session (``tests/test_frontend_serve.py``) and the overload walk
  (``tests/test_frontend_overload.py``).

Every server binds port 0 and is stopped in a fixture or a ``finally``;
every HTTP call and every wait has a timeout.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from mpi_knn_tpu import frontend as ref_frontend
from mpi_knn_tpu import resilience as ref_resilience
from mpi_knn_tpu import serve as ref_serve
from mpi_knn_tpu.config import KNNConfig as RefConfig
from mpi_knn_tpu_torch.convert import config_from_reference
from mpi_knn_tpu_torch.frontend import (
    Frontend,
    FrontendHTTPServer,
    Rejection,
    SLOPolicy,
    loadgen,
)
from mpi_knn_tpu_torch.obs.metrics import (
    get_registry,
    parse_prometheus,
    watch_compiles,
)
from mpi_knn_tpu_torch.obs.spans import (
    FlightRecorder,
    read_flight,
    reconstruct_spans,
    set_recorder,
    validate_flight,
)
from mpi_knn_tpu_torch.resilience import ResiliencePolicy
from mpi_knn_tpu_torch.resilience.faults import install_faults
from mpi_knn_tpu_torch.serve import ServeSession, build_index, query_knn
from tests.oracle import recall_against_oracle

CPU = "cpu"
DIM = 16
TIMEOUT = 30


def _post(url, path, data, headers):
    req = urllib.request.Request(
        url + path, data=data, headers=headers, method="POST"
    )
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, json.loads(resp.read())


def _status(url, path, data=None, headers=None):
    """(status, JSON body) of one call, HTTP errors included."""
    try:
        if data is None:
            with urllib.request.urlopen(url + path, timeout=TIMEOUT) as r:
                return r.status, json.loads(r.read())
        return _post(url, path, data, headers or {})
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ---------------------------------------------------------------------------
# parity with the reference: one corpus, two servers


@pytest.fixture(scope="module")
def pair():
    """{"port": (server, frontend, index), "ref": (...)}: the same corpus
    and config behind both packages' front ends (ephemeral ports)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1024, DIM)).astype(np.float32)
    ref_cfg = RefConfig(k=4, backend="serial", query_bucket=64,
                        corpus_tile=256, query_tile=64, bucket_headroom=0.25,
                        mutation_bucket=32)
    slo = dict(max_batch_rows=64, max_wait_s=0.002, max_queue_rows=8192)
    ref_index = ref_serve.build_index(X, ref_cfg)
    ref_fe = ref_frontend.Frontend(
        ref_serve.ServeSession(ref_index,
                               resilience=ref_resilience.ResiliencePolicy()),
        ref_frontend.SLOPolicy(**slo),
    ).start()
    port_index = build_index(
        X, config_from_reference(dataclasses.asdict(ref_cfg)), device=CPU)
    port_fe = Frontend(
        ServeSession(port_index, resilience=ResiliencePolicy(), device=CPU),
        SLOPolicy(**slo),
    ).start()
    servers = {}
    try:
        servers["ref"] = (ref_frontend.FrontendHTTPServer(ref_fe, port=0).start(),
                          ref_fe, ref_index)
        servers["port"] = (FrontendHTTPServer(port_fe, port=0).start(),
                           port_fe, port_index)
        yield servers, X
    finally:
        for srv, fe, _ in servers.values():
            srv.stop()
        ref_fe.stop()
        port_fe.stop()


def _oracle(X, Q, k):
    """f64 distances of each query to the centered corpus: the k + 4
    nearest, ties to the lower id, the zero rule applied."""
    mu = X.astype(np.float64).mean(axis=0)
    c, q = X.astype(np.float64) - mu, Q.astype(np.float64) - mu
    d = (q * q).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * q @ c.T
    d = np.maximum(d, 0.0)
    d[d <= 1e-6 * ((q * q).sum(1)[:, None] + (c * c).sum(1)[None])] = np.inf
    ids = np.argsort(d, axis=1, kind="stable")[:, :k + 4]
    return np.take_along_axis(d, ids, 1), ids


def test_concurrent_answers_match_the_reference(pair):
    """Tenants post ragged requests concurrently (raw f32 and JSON) to both
    servers; each request's answer agrees with the reference's in ids up to
    ties and in f32 distances."""
    servers, X = pair
    rng = np.random.default_rng(7)
    reqs = [(f"tenant-{i % 4}", rng.normal(size=(rows, DIM)).astype(np.float32),
             i % 2 == 0)
            for i, rows in enumerate([1, 5, 16, 33, 7, 16, 64, 2, 31, 16, 9, 3])]
    answers = {"ref": [None] * len(reqs), "port": [None] * len(reqs)}

    def send(which, i):
        tenant, q, raw = reqs[i]
        if raw:
            body, ctype = q.astype("<f4").tobytes(), "application/octet-stream"
        else:
            body, ctype = json.dumps({"queries": q.tolist()}).encode(), \
                "application/json"
        answers[which][i] = _post(servers[which][0].url, "/query", body,
                                  {"Content-Type": ctype, "X-Tenant": tenant})

    threads = [threading.Thread(target=send, args=(w, i), daemon=True)
               for w in ("ref", "port") for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    for i, (_, q, _) in enumerate(reqs):
        (rs, rdoc), (ps, pdoc) = answers["ref"][i], answers["port"][i]
        assert rs == ps == 200 and rdoc["rows"] == pdoc["rows"] == q.shape[0]
        od, oi = _oracle(X, q, 4)
        assert recall_against_oracle(np.asarray(pdoc["ids"]), od, oi, 4) == 1.0
        assert recall_against_oracle(np.asarray(rdoc["ids"]), od, oi, 4) == 1.0
        np.testing.assert_allclose(
            np.asarray(pdoc["dists"], np.float32),
            np.asarray(rdoc["dists"], np.float32), rtol=1e-5, atol=1e-4)


def test_healthz_keys_and_facts_match_the_reference(pair):
    """Same keys, and the same index facts and posture values. Both read
    their planner's shipped device profile for the device they serve on:
    "cpu-test" on the CPU, the same name and figures on both sides."""
    servers, _ = pair
    port = loadgen.probe_server(servers["port"][0].url)
    ref = loadgen.probe_server(servers["ref"][0].url)
    assert set(port) == set(ref)
    assert port["device_profile"]["name"] == ref["device_profile"]["name"] \
        == "cpu-test"
    # the figures; each side's _doc names its own sources
    assert {k: v for k, v in port["device_profile"].items() if k != "_doc"} \
        == {k: v for k, v in ref["device_profile"].items() if k != "_doc"}
    for key in ("ok", "ready", "dim", "k", "backend", "max_batch_rows",
                "rung", "ladder", "warming"):
        assert port[key] == ref[key], key
    assert isinstance(port["peak_hbm_bytes"], int) and port["peak_hbm_bytes"] > 0


def test_metrics_families_match_the_reference(pair):
    servers, _ = pair
    q = json.dumps({"queries": np.zeros((3, DIM)).tolist()}).encode()
    for which in ("ref", "port"):
        _post(servers[which][0].url, "/query", q,
              {"Content-Type": "application/json", "X-Tenant": "scraped"})
    families = {}
    for which in ("ref", "port"):
        text = loadgen.fetch_metrics(servers[which][0].url)
        samples = parse_prometheus(text)  # strict: malformed lines raise
        assert samples['serve_tenant_queries_total{tenant="scraped"}'] >= 3
        families[which] = {ln.split()[2] for ln in text.splitlines()
                           if ln.startswith("# TYPE ")}
    want = {"frontend_requests_total", "frontend_batches_total",
            "frontend_batch_fill_rows", "frontend_queue_rows",
            "serve_batches_total", "serve_queries_total",
            "serve_batch_latency_seconds", "serve_tenant_queries_total",
            "serve_tenant_batches_total"}
    assert want <= families["port"] and want <= families["ref"]


def _error_calls(dim):
    hdr = {"Content-Type": "application/json"}
    return [
        ("/query", b"not json", hdr),
        ("/query", json.dumps({"queries": [[1.0, 2.0]]}).encode(), hdr),
        ("/query", b"\x00" * 7, {"Content-Type": "application/octet-stream"}),
        ("/query", b"", hdr),
        ("/elsewhere", b"{}", hdr),
        ("/upsert", json.dumps({"ids": [1], "rows": [[0.0] * (dim + 1)]}).encode(),
         hdr),
        ("/upsert", json.dumps({"ids": [1, 2], "rows": [[0.0] * dim]}).encode(),
         hdr),
        ("/delete", b"{}", hdr),
    ]


def test_error_answers_match_the_reference(pair):
    """400 (malformed bodies) and 404 (unknown routes) alike on both."""
    servers, _ = pair
    for path, body, hdr in _error_calls(DIM):
        got = _status(servers["port"][0].url, path, body, hdr)
        want = _status(servers["ref"][0].url, path, body, hdr)
        assert got[0] == want[0] and got[0] in (400, 404), (path, body)
        assert "error" in got[1]
    assert _status(servers["port"][0].url, "/nope")[0] == 404


def test_seq_gap_409_and_position_match_the_reference(pair):
    """The X-Mutation-Seq contract on both: a gap is 409 seq-gap, a 400
    consumes its position, the next in-order seq applies, a duplicate is
    acknowledged without applying."""
    servers, _ = pair
    hdr = {"Content-Type": "application/json"}
    row = json.dumps({"ids": [9001], "rows": [[0.5] * DIM]}).encode()
    story = {}
    for which in ("ref", "port"):
        url = servers[which][0].url
        a0 = _status(url, "/healthz")[1]["applied_seq"]
        steps = [
            _status(url, "/upsert", row, {**hdr, "X-Mutation-Seq": str(a0 + 5)}),
            _status(url, "/upsert", b"not json",
                    {**hdr, "X-Mutation-Seq": str(a0 + 1)}),
            _status(url, "/upsert", row, {**hdr, "X-Mutation-Seq": str(a0 + 2)}),
            _status(url, "/upsert", row, {**hdr, "X-Mutation-Seq": str(a0 + 2)}),
            _status(url, "/delete", json.dumps({"ids": [9001]}).encode(),
                    {**hdr, "X-Mutation-Seq": str(a0 + 3)}),
        ]
        story[which] = [(s, d.get("error"), d.get("applied_seq", 0) - a0,
                         d.get("duplicate", False),
                         d.get("upserted", d.get("deleted"))) for s, d in steps]
    assert story["port"] == story["ref"]
    assert [s[0] for s in story["port"]] == [409, 400, 200, 200, 200]
    assert story["port"][3][3] is True  # the duplicate applied nothing


def test_rate_limit_429_matches_the_reference(pair):
    """A throttled tenant sees 429 with the same structured body and a
    Retry-After header on both."""
    servers, _ = pair
    slo = dict(max_batch_rows=64, max_wait_s=0.002, max_queue_rows=8192,
               max_tenant_qps=0.25, burst=1)
    fronts = {
        "ref": ref_frontend.Frontend(
            ref_serve.ServeSession(servers["ref"][2]),
            ref_frontend.SLOPolicy(**slo)),
        "port": Frontend(ServeSession(servers["port"][2], device=CPU),
                         SLOPolicy(**slo)),
    }
    body = json.dumps({"queries": np.zeros((1, DIM)).tolist()}).encode()
    hdr = {"Content-Type": "application/json", "X-Tenant": "hot"}
    got = {}
    for which, fe in fronts.items():
        fe.start()
        cls = (ref_frontend.FrontendHTTPServer if which == "ref"
               else FrontendHTTPServer)
        srv = cls(fe, port=0).start()
        try:
            first = _status(srv.url, "/query", body, hdr)
            req = urllib.request.Request(srv.url + "/query", data=body,
                                         headers=hdr, method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=TIMEOUT)
            doc = json.loads(ei.value.read())
            got[which] = (first[0], ei.value.code, doc["error"], doc["tenant"],
                          float(ei.value.headers["Retry-After"]) > 0)
        finally:
            srv.stop()
            fe.stop()
    assert got["port"] == got["ref"] == (200, 429, "rate", "hot", True)


def test_warming_and_stopping_are_structured_503s():
    """A front end whose buckets are not built yet refuses with 503
    "warming" (and its progress), one that is stopping with 503
    "shutting-down", and its /healthz answers 503, as the reference's."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(256, DIM)).astype(np.float32)
    ref_cfg = RefConfig(k=3, backend="serial", query_bucket=32, corpus_tile=128,
                        query_tile=32)
    slo = dict(max_batch_rows=32, max_wait_s=0.002, max_queue_rows=1024)
    port_fe = Frontend(ServeSession(build_index(
        X, config_from_reference(dataclasses.asdict(ref_cfg)), device=CPU),
        device=CPU), SLOPolicy(**slo))
    ref_fe = ref_frontend.Frontend(ref_serve.ServeSession(
        ref_serve.build_index(X, ref_cfg)), ref_frontend.SLOPolicy(**slo))
    q = np.zeros((4, DIM), np.float32)
    outs = [fe.submit("t", q) for fe in (port_fe, ref_fe)]  # never started
    assert [(o.status, o.reason) for o in outs] == [(503, "warming")] * 2
    assert "entries ready" in outs[0].detail
    port_fe.start()
    srv = FrontendHTTPServer(port_fe, port=0).start()
    try:
        port_fe.stop()
        body = q.astype("<f4").tobytes()
        status, doc = _status(srv.url, "/query", body,
                              {"Content-Type": "application/octet-stream"})
        assert (status, doc["error"]) == (503, "shutting-down")
        status, doc = _status(srv.url, "/healthz")
        assert status == 503 and doc["ok"] is False
    finally:
        srv.stop()


def test_tenant_composition_checks_match_the_reference():
    """``submit(tenants=)``: a composition that does not sum to the rows, or
    an id a metrics label cannot carry, raises ValueError in both, before
    anything is dispatched; a good one splits the per-tenant stats."""
    rng = np.random.default_rng(2)
    X = rng.normal(size=(256, DIM)).astype(np.float32)
    ref_cfg = RefConfig(k=3, backend="serial", query_bucket=16, corpus_tile=128,
                        query_tile=16)
    port = ServeSession(build_index(
        X, config_from_reference(dataclasses.asdict(ref_cfg)), device=CPU),
        device=CPU)
    ref = ref_serve.ServeSession(ref_serve.build_index(X, ref_cfg))
    q = np.zeros((8, DIM), np.float32)
    for bad, words in (((("a", 4), ("b", 3)), "mis-attribute"),
                       ((("a", 4), ('b"x', 4)), "tenant"),
                       ((("", 8),), "tenant"),
                       ((("a\n", 8),), "tenant")):
        for ses in (port, ref):
            with pytest.raises(ValueError, match=words):
                ses.submit(q, tenants=bad)
    assert port._seq == 0 and not port._inflight
    comp = (("a", 3), ("b", 5), ("a", 0))
    for ses in (port, ref):
        ses.submit(q, tenants=comp)
        (res,) = ses.drain()
        assert res.tenants == comp
    for t in ("a", "b"):
        for key in ("queries", "batches"):
            assert port.tenant_stats[t][key] == ref.tenant_stats[t][key]
    assert port.tenant_stats["a"] == {**port.tenant_stats["a"], "queries": 3,
                                      "batches": 1}


# ---------------------------------------------------------------------------
# the reference's cases: the HTTP shell (tests/test_frontend_server.py)


@pytest.fixture(scope="module")
def served():
    """(server, frontend, index): one live loopback server of the port."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1024, DIM)).astype(np.float32)
    index = build_index(
        X,
        config_from_reference(dataclasses.asdict(RefConfig(
            k=4, backend="serial", query_bucket=64, corpus_tile=256,
            query_tile=64))),
        device=CPU,
    )
    fe = Frontend(
        ServeSession(index, resilience=ResiliencePolicy(), device=CPU),
        SLOPolicy(max_batch_rows=64, max_wait_s=0.002,
                  max_queue_rows=8192),
    ).start()
    srv = FrontendHTTPServer(fe, port=0).start()
    try:
        yield srv, fe, index
    finally:
        srv.stop()
        fe.stop()


def test_json_query_roundtrip(served):
    srv, fe, index = served
    q = np.arange(2 * DIM, dtype=np.float32).reshape(2, DIM)
    status, doc = _post(
        srv.url, "/query",
        json.dumps({"queries": q.tolist()}).encode(),
        {"Content-Type": "application/json", "X-Tenant": "json-tenant"},
    )
    ref = query_knn(q, index, device=CPU)
    assert status == 200 and doc["rows"] == 2
    assert doc["ids"] == ref.ids.tolist()
    assert np.allclose(np.asarray(doc["dists"], np.float32), ref.dists.numpy())
    assert fe.session.tenant_stats["json-tenant"]["queries"] >= 2


def test_raw_f32_query_bit_identical(served):
    """The octet-stream body (little-endian f32 rows at the index dim)
    returns the same ids as the one-shot path for the same queries."""
    srv, _, index = served
    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, DIM)).astype("<f4")
    status, doc = _post(
        srv.url, "/query", q.tobytes(),
        {"Content-Type": "application/octet-stream", "X-Tenant": "raw"},
    )
    ref = query_knn(np.asarray(q, np.float32), index, device=CPU)
    assert status == 200 and doc["ids"] == ref.ids.tolist()
    assert np.asarray(doc["dists"], np.float32).tobytes() == \
        ref.dists.numpy().tobytes()


def test_malformed_bodies_are_400(served):
    srv, _, _ = served
    for data, ctype in [
        (b"not json", "application/json"),
        (json.dumps({"queries": [[1.0, 2.0]]}).encode(),
         "application/json"),  # wrong dim
        (b"\x00" * 7, "application/octet-stream"),  # not whole f32 rows
        (b"", "application/json"),  # empty body
    ]:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url, "/query", data, {"Content-Type": ctype})
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read())


def test_unknown_routes_are_404(served):
    srv, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(srv.url + "/nope", timeout=10)
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv.url, "/elsewhere", b"{}",
              {"Content-Type": "application/json"})
    assert ei.value.code == 404


def test_healthz_reports_serving_posture(served):
    srv, _, index = served
    doc = loadgen.probe_server(srv.url)
    assert doc["ok"] is True
    assert doc["dim"] == DIM and doc["k"] == index.cfg.k
    assert doc["backend"] == "serial"
    assert doc["rung"] == "full" and doc["ladder"][0] == "full"
    assert doc["max_batch_rows"] == 64
    assert doc["uptime_s"] >= 0


def test_metrics_exposition_reparses_strictly(served):
    """GET /metrics round-trips through parse_prometheus (the labeled
    per-tenant counters included) and carries the serving counters."""
    srv, _, index = served
    q = np.zeros((3, DIM), np.float32)
    _post(srv.url, "/query",
          json.dumps({"queries": q.tolist()}).encode(),
          {"Content-Type": "application/json", "X-Tenant": "scraped"})
    text = loadgen.fetch_metrics(srv.url)
    samples = parse_prometheus(text)  # strict: malformed lines raise
    assert samples["serve_batches_total"] >= 1
    assert samples['serve_tenant_queries_total{tenant="scraped"}'] >= 3
    assert "frontend_queue_rows" in samples
    # one TYPE header per base family even with many tenant labels
    type_lines = [
        ln for ln in text.splitlines()
        if ln.startswith("# TYPE serve_tenant_queries_total ")
    ]
    assert len(type_lines) == 1


def test_rate_limit_is_429_on_the_wire(served):
    """A throttled tenant sees HTTP 429 with the structured body and a
    Retry-After header (the scheduler's Rejection, translated)."""
    srv, fe, _ = served
    throttled = Frontend(
        ServeSession(fe.session.index, device=CPU),
        SLOPolicy(max_batch_rows=64, max_wait_s=0.002,
                  max_queue_rows=8192, max_tenant_qps=0.25, burst=1),
    ).start()
    srv2 = FrontendHTTPServer(throttled, port=0).start()
    try:
        body = json.dumps(
            {"queries": np.zeros((1, DIM)).tolist()}
        ).encode()
        hdr = {"Content-Type": "application/json", "X-Tenant": "hot"}
        status, _ = _post(srv2.url, "/query", body, hdr)
        assert status == 200
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv2.url, "/query", body, hdr)
        assert ei.value.code == 429
        doc = json.loads(ei.value.read())
        assert doc["error"] == "rate" and doc["tenant"] == "hot"
        assert float(ei.value.headers["Retry-After"]) > 0
        assert doc["retry_after_s"] > 0
    finally:
        srv2.stop()
        throttled.stop()


def test_http_loadgen_end_to_end(served):
    """The open-loop HTTP load generator against the live server: all
    requests served, per-tenant fairness, sane latency fields."""
    srv, _, _ = served
    rep = loadgen.run_http(
        srv.url, tenants=3, qps=60.0, n_requests=6, rows=8,
    )
    assert rep["errors"] == 0 and rep["rejected"] == 0
    assert sum(rep["per_tenant"].values()) == 18
    assert set(rep["per_tenant"].values()) == {6}
    assert rep["p50_ms"] is not None and rep["p99_ms"] is not None
    assert rep["achieved_qps_rows"] > 0
    assert rep["offered_qps_total"] == pytest.approx(180.0)


def test_mutation_seq_gap_is_409_and_refusals_consume_position(served):
    """The gapless-mark wire contract: a seq past applied+1 is refused 409
    (nothing applied, mark unchanged), a deterministic 400 refusal
    CONSUMES its in-order seq, and the next in-order seq applies."""
    srv, _fe, _index = served
    with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
        a0 = json.loads(r.read())["applied_seq"]
    hdr = {"Content-Type": "application/json"}
    row = json.dumps({"ids": [9001], "rows": [[0.0] * DIM]}).encode()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv.url, "/upsert", row,
              {**hdr, "X-Mutation-Seq": str(a0 + 5)})
    assert ei.value.code == 409
    assert json.loads(ei.value.read())["error"] == "seq-gap"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv.url, "/upsert", b"not json",
              {**hdr, "X-Mutation-Seq": str(a0 + 1)})
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["applied_seq"] == a0 + 1
    with urllib.request.urlopen(srv.url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["applied_seq"] == a0 + 1
    status, doc = _post(srv.url, "/delete",
                        json.dumps({"ids": [3]}).encode(),
                        {**hdr, "X-Mutation-Seq": str(a0 + 2)})
    assert status == 200 and doc["applied_seq"] == a0 + 2


# ---------------------------------------------------------------------------
# the reference's cases: coalesced serving (tests/test_frontend_serve.py)

SDIM = 32
BUCKET = 128


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2048, SDIM)).astype(np.float32)
    cfg = config_from_reference(dataclasses.asdict(RefConfig(
        k=5, backend="serial", query_bucket=BUCKET, corpus_tile=512,
        query_tile=BUCKET)))
    return build_index(X, cfg, device=CPU)


def _frontend(index, **slo_kw):
    session = ServeSession(index, resilience=ResiliencePolicy(), device=CPU)
    kw = dict(max_batch_rows=BUCKET, max_wait_s=0.002,
              max_queue_rows=65536)
    kw.update(slo_kw)
    return Frontend(session, SLOPolicy(**kw)).start()


def test_coalesced_results_bit_identical_to_sequential(index):
    """Requests of ragged sizes from several tenants, coalesced into
    shared batches, return BIT-identical results to the same queries
    served alone."""
    fe = _frontend(index)
    rng = np.random.default_rng(1)
    reqs = [
        (f"tenant-{i % 5}", rng.normal(size=(rows, SDIM)).astype(np.float32))
        for i, rows in enumerate([1, 5, 16, 33, 7, 16, 64, 2, 31, 16])
    ]
    tickets = [(q, fe.submit(t, q)) for t, q in reqs]
    try:
        for q, ticket in tickets:
            assert not isinstance(ticket, Rejection)
            dists, ids = ticket.result(timeout=60)
            ref = query_knn(q, index, device=CPU)
            assert np.array_equal(ids, ref.ids.numpy())
            assert np.array_equal(dists, ref.dists.numpy())
    finally:
        fe.stop()


def test_per_tenant_attribution_and_batch_spans(index, tmp_path):
    """A coalesced batch feeds tenant_stats per tenant, the labeled
    registry counters, and stamps its tenant composition on the batch
    flight span."""
    flight = tmp_path / "flight.jsonl"
    set_recorder(FlightRecorder(str(flight), fresh=True))
    try:
        fe = _frontend(index)
        rng = np.random.default_rng(2)
        tickets = [
            fe.submit(t, rng.normal(size=(8, SDIM)).astype(np.float32))
            for t in ("alice", "bob", "alice")
        ]
        for t in tickets:
            t.result(timeout=60)
        fe.stop()
        st = fe.session.tenant_stats
        assert st["alice"]["queries"] == 16 and st["bob"]["queries"] == 8
        assert st["alice"]["batches"] >= 1
        assert st["alice"]["latency_sum_s"] > 0
        reg = get_registry()
        assert reg.counter(
            "serve_tenant_queries_total", labels={"tenant": "alice"}
        ).value >= 16
    finally:
        set_recorder(None)
    records = read_flight(str(flight))
    assert validate_flight(records) == []
    spans, events = reconstruct_spans(records)
    batch_spans = [s for s in spans if s["name"] == "batch"]
    assert batch_spans, "no batch spans in the flight record"
    comps = [s["attrs"].get("tenants") for s in batch_spans]
    assert any(c and "alice" in c for c in comps)
    served_rows = {}
    for c in comps:
        for t, n in (c or {}).items():
            served_rows[t] = served_rows.get(t, 0) + n
    assert served_rows == {"alice": 16, "bob": 8}
    assert any(e.get("name") == "coalesce" for e in events)


def test_rate_limited_tenant_gets_structured_429(index):
    fe = _frontend(index, max_tenant_qps=0.5, burst=1)
    q = np.zeros((4, SDIM), np.float32)
    try:
        first = fe.submit("limited", q)
        second = fe.submit("limited", q)
        assert not isinstance(first, Rejection)
        assert isinstance(second, Rejection)
        assert second.reason == "rate" and second.status == 429
        assert second.retry_after_s > 0
        # an unrelated tenant is not throttled by it
        assert not isinstance(fe.submit("other", q), Rejection)
        first.result(timeout=60)
    finally:
        fe.stop()


def test_stop_flushes_admitted_requests(index):
    """Shutdown serves what was admitted: a request parked far below the
    fill threshold with a huge wait budget still completes."""
    fe = _frontend(index, max_wait_s=300.0)
    q = np.ones((3, SDIM), np.float32)
    ticket = fe.submit("parked", q)
    assert not ticket.done()
    fe.stop()
    dists, ids = ticket.result(timeout=1)
    ref = query_knn(q, index, device=CPU)
    assert np.array_equal(ids, ref.ids.numpy())


@pytest.fixture
def one_cpu_thread():
    """torch's CPU kernels on one thread for a timed test: the test runner
    puts several worker processes on the host's cores, and each one's
    intra-op thread pool would otherwise oversubscribe them, so a latency
    bound would measure the contention, not the front end."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_acceptance_coalescing_throughput_fairness_zero_builds(index,
                                                              one_cpu_thread):
    """The reference's acceptance gate, on the CPU: 8 concurrent tenant
    streams through the open-loop load generator; coalesced serving
    sustains >= 2x the row throughput of per-stream depth-1 sequential
    dispatch under ONE p99 bound; every stream fully served (max/min
    served ratio 1); and no entry built and no nvcc run across the
    coalesced run (``watch_compiles``: the port's compiles)."""
    P99_BOUND_MS = 500.0
    tenants, n_requests, rows = 8, 12, 16

    seq_session = ServeSession(
        index, config=index.cfg.replace(dispatch_depth=1), device=CPU
    )
    seq_session.submit(np.zeros((BUCKET, SDIM), np.float32))
    seq_session.drain()
    seq_session.reset_stats()
    seq = loadgen.run_sequential_baseline(
        seq_session, tenants=tenants, n_requests=n_requests, rows=rows,
        lo=-1.0, hi=1.0,
    )
    assert seq["achieved_qps_rows"] > 0

    fe = _frontend(index)
    try:
        with watch_compiles() as compiles:
            rep = loadgen.run_inprocess(
                fe, tenants=tenants, qps=5000.0, n_requests=n_requests,
                rows=rows, lo=-1.0, hi=1.0,
            )
        assert compiles == [], (
            f"coalesced serving built {compiles} in steady state: the "
            "front end must only fill warm buckets"
        )
    finally:
        fe.stop()

    assert rep["rejected"] == 0 and rep["errors"] == 0
    assert sum(rep["per_tenant"].values()) == tenants * n_requests
    served_n = rep["per_tenant"]
    assert max(served_n.values()) / min(served_n.values()) == 1.0
    assert rep["achieved_qps_rows"] >= 2.0 * seq["achieved_qps_rows"], (
        f"coalesced {rep['achieved_qps_rows']} rows/s vs sequential "
        f"{seq['achieved_qps_rows']} rows/s"
    )
    assert seq["p99_ms"] <= P99_BOUND_MS
    assert rep["p99_ms"] <= P99_BOUND_MS, (
        f"coalesced p99 {rep['p99_ms']}ms over the {P99_BOUND_MS}ms bound "
        f"(sequential p99 {seq['p99_ms']}ms)"
    )


def test_tenant_composition_must_sum_to_rows(index):
    session = ServeSession(index, device=CPU)
    q = np.zeros((8, SDIM), np.float32)
    with pytest.raises(ValueError, match="mis-attribute"):
        session.submit(q, tenants=(("a", 4), ("b", 3)))


# ---------------------------------------------------------------------------
# the reference's case: overload (tests/test_frontend_overload.py)


def _counter(name) -> float:
    return get_registry().counter(name).value


def test_injected_slow_batches_shed_then_recover(tmp_path):
    """An injected slow-batch fault grows the coalescer queue, the
    scheduler walks the ladder down, offered load stops, the queue drains
    and the ladder walks back up: asserted from the metrics registry and
    the flight record."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, DIM)).astype(np.float32)
    idx = build_index(X, config_from_reference(dataclasses.asdict(RefConfig(
        k=4, backend="serial", query_bucket=32, corpus_tile=256,
        query_tile=32))), device=CPU)
    flight = tmp_path / "flight.jsonl"
    set_recorder(FlightRecorder(str(flight), fresh=True))
    deg0 = _counter("serve_degradations_total")
    res0 = _counter("serve_restorations_total")
    shed0 = _counter("frontend_overload_sheds_total")
    rec0 = _counter("frontend_overload_recoveries_total")
    try:
        session = ServeSession(idx, resilience=ResiliencePolicy(), device=CPU)
        assert len(session.ladder) >= 2  # something to shed into
        fe = Frontend(session, SLOPolicy(
            max_batch_rows=32,
            max_wait_s=0.002,
            max_queue_rows=100_000,
            shed_queue_rows=128,
            shed_hold_s=0.05,
            recover_hold_s=0.05,
        )).start()
        try:
            with install_faults({"serve-batch": ("slow", 0.06)}):
                tickets = []
                t_end = time.monotonic() + 0.7
                while time.monotonic() < t_end:
                    for ti in range(4):
                        out = fe.submit(
                            f"tenant-{ti}",
                            np.zeros((16, DIM), np.float32),
                        )
                        if not isinstance(out, Rejection):
                            tickets.append(out)
                    time.sleep(0.02)
                deadline = time.monotonic() + 60
                while (
                    fe.session.rung != "full"
                    or fe.scheduler.coalescer.pending_rows
                ) and time.monotonic() < deadline:
                    time.sleep(0.05)
            for t in tickets:
                t.result(timeout=60)  # nothing admitted was dropped
        finally:
            fe.stop()

        assert _counter("serve_degradations_total") > deg0
        assert _counter("frontend_overload_sheds_total") > shed0
        assert _counter("serve_restorations_total") > res0
        assert _counter("frontend_overload_recoveries_total") > rec0
        assert get_registry().gauge("serve_ladder_rung").value == 0.0
        assert fe.session.rung == "full"
        assert any(
            d["reason"] == "queue-overload" for d in session.degradations
        )
        assert any(
            r["reason"] == "queue-recovered" for r in session.restorations
        )
    finally:
        set_recorder(None)

    records = read_flight(str(flight))
    assert validate_flight(records) == []
    _, events = reconstruct_spans(records)
    names = [e.get("name") for e in events]
    assert "frontend-shed" in names and "frontend-recover" in names
    degrades = [e for e in events if e.get("name") == "degrade"]
    restores = [e for e in events if e.get("name") == "restore"]
    assert degrades and restores
    assert degrades[0]["attrs"]["reason"] == "queue-overload"
    assert degrades[0]["attrs"]["rung"] in (
        label for label, _ in session.ladder
    )
    assert restores[-1]["attrs"]["rung"] == "full"
    assert restores[-1]["attrs"]["reason"] == "queue-recovered"
    assert names.index("degrade") < names.index("restore")


# ---------------------------------------------------------------------------
# the subcommands


@pytest.mark.parametrize("argv,words", [
    (["serve", "--backend", "ivf-sharded"], "invalid choice"),
    (["serve", "--route-cap", "4"], "unrecognized arguments"),
    (["serve", "--platform", "tpu"], "invalid choice"),
    (["serve", "--max-wait-ms", "-1", "--platform", "cpu"], "max-wait-ms"),
    (["serve", "--shed-hold-ms", "10", "--platform", "cpu"], "inert"),
    (["loadgen"], "--url / --targets"),
    (["loadgen", "--url", "http://127.0.0.1:9", "--qps", "0"], "--qps"),
    (["router"], "--replicas / --spawn"),
    (["router", "--replicas", "http://a", "--cache-dir", "/tmp/x"], "--spawn"),
])
def test_front_end_subcommands_refuse_what_they_cannot_honor(argv, words,
                                                             capsys):
    """``serve`` / ``loadgen`` / ``router`` are ported (no "not yet ported"
    refusal); what stays refused exits 2 naming why: the sharded clustered
    backend and its route cap (not ported), a platform the port has no
    device for, and the reference's own usage errors."""
    from mpi_knn_tpu_torch.cli import main

    try:
        rc = main(argv)
    except SystemExit as e:  # argparse's own refusal
        rc = e.code
    err = capsys.readouterr().err
    assert rc == 2 and words in err and "not yet ported" not in err


def test_serve_loadgen_and_a_graceful_stop_as_processes(tmp_path):
    """``serve --platform cpu`` binds port 0 and publishes its URL through
    the ready file; ``loadgen`` drives it with zero errors; SIGTERM stops it
    cleanly and writes the metrics snapshot, whose exposition re-parses."""
    import signal
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    ready, metrics = tmp_path / "s.url", tmp_path / "m.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_knn_tpu_torch", "serve", "--data",
         "synthetic:1024x16c4", "--k", "4", "--backend", "serial", "--bucket",
         "32", "--corpus-tile", "256", "--port", "0", "--ready-file",
         str(ready), "--metrics-out", str(metrics), "--platform", "cpu", "-q"],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not ready.exists() and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read()
            time.sleep(0.1)
        url = ready.read_text().strip()
        while not loadgen.probe_server(url)["ready"]:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        report = tmp_path / "r.json"
        out = subprocess.run(
            [sys.executable, "-m", "mpi_knn_tpu_torch", "loadgen", "--url", url,
             "--tenants", "3", "--qps", "40", "--requests", "6", "--rows", "8",
             "--report", str(report), "-q"],
            cwd=repo, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        doc = json.loads(report.read_text())
        assert doc["rows"][0]["errors"] == 0
        assert sum(doc["rows"][0]["per_tenant"].values()) == 18
        assert doc["health"]["backend"] == "serial"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    from mpi_knn_tpu_torch.obs.metrics import to_prometheus

    snap = json.loads(metrics.read_text())
    assert parse_prometheus(to_prometheus(snap))["frontend_requests_total"
                                                 '{tenant="tenant-0"}'] == 6
