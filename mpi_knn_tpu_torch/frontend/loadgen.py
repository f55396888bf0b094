"""Open-loop multi-tenant load generation: throughput-vs-latency curves
for the serving front end (the JAX package's ``frontend/loadgen.py``).

Open loop is the honest protocol for a throughput-vs-p99 curve: each
tenant stream issues requests on a FIXED arrival schedule (request i of a
``qps``-rate stream is due at ``i / qps``), never waiting for responses,
so when the server falls behind, latency GROWS instead of the generator
politely slowing down to match (the closed-loop coordination artifact
that makes overloaded servers look fine). Per-request latency is measured
from the request's SCHEDULED arrival to completion, so queueing delay
(including the generator itself getting behind schedule) is inside the
number, not hidden beside it.

Two transports, one report shape:

- :func:`run_inprocess` drives a :class:`~mpi_knn_tpu_torch.frontend.
  server.Frontend` directly (no sockets): ``submit`` is a non-blocking
  enqueue, so ONE thread per tenant sustains true open-loop arrivals, and
  the pump's ticket fulfillment stamps completion times.
- :func:`run_http` drives one or more running servers over HTTP (the
  ``loadgen`` subcommand), exercising the full network path. The default
  transport (``connect="reuse"``) is a fixed pool of worker threads per
  tenant, each holding ONE persistent keep-alive connection and draining
  a shared open-loop queue: the schedule never waits on a response, and
  queue wait is inside the latency because it is measured from the
  scheduled arrival. ``connect="per-request"`` (a fresh TCP connect and
  thread per request) is kept as the comparison anchor: it understates
  q/s and inflates p50 at high offered load. ``targets=[url, ...]``
  spreads tenants round-robin over endpoints (the router drill's
  multi-replica direct baseline).

:func:`run_sequential_baseline` is the comparison anchor: the same
requests served one at a time at dispatch depth 1 (each lone request
padding to its own bucket), the "no front end" number the coalesced curve
must beat (>= 2x at an equal p99 bound).

Report row shape (both transports)::

    {tenants, offered_qps_per_tenant, offered_qps_total, requests,
     rows_per_request, wall_s, achieved_qps_rows, achieved_rps,
     p50_ms, p99_ms, rejected, errors, per_tenant: {t: served}}

No torch import at module load.
"""

from __future__ import annotations

import http.client
import json
import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np

from mpi_knn_tpu_torch.frontend.scheduler import Rejection


def synth_queries(dim: int, rows: int, *, lo: float = 0.0, hi: float = 1.0,
                  seed: int = 0):
    """One synthetic request payload (uniform in the corpus range — the
    serve CLI's synthetic-stream convention)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(rows, dim)).astype(np.float32)


def _percentiles_ms(lat_s: list) -> tuple:
    if not lat_s:
        return None, None
    a = np.asarray(lat_s)
    return (
        round(float(np.percentile(a, 50)) * 1e3, 3),
        round(float(np.percentile(a, 99)) * 1e3, 3),
    )


def _report(*, tenants, qps, rows, n_requests, wall_s, lat_s, rejected,
            errors, served_rows, per_tenant, connect=None, targets=None,
            by_status=None) -> dict:
    p50, p99 = _percentiles_ms(lat_s)
    out = {
        "tenants": tenants,
        "offered_qps_per_tenant": qps,
        "offered_qps_total": round(qps * tenants, 3),
        "requests": n_requests,
        "rows_per_request": rows,
        "wall_s": round(wall_s, 4),
        "achieved_rps": round(len(lat_s) / wall_s, 2) if wall_s > 0 else None,
        "achieved_qps_rows": round(served_rows / wall_s, 1)
        if wall_s > 0 else None,
        "p50_ms": p50,
        "p99_ms": p99,
        "rejected": rejected,
        "errors": errors,
        "per_tenant": dict(sorted(per_tenant.items())),
    }
    if connect is not None:
        out["connect"] = connect
    if targets is not None:
        out["targets"] = len(targets)
    if by_status is not None:
        # status -> count over every response, 200s included (status 0 =
        # transport failure): the drill's "zero 5xx beyond structured
        # 503s" assertion reads this, not the lumped error count
        out["by_status"] = {
            str(k): v for k, v in sorted(by_status.items())
        }
    return out


# ---------------------------------------------------------------------------
# in-process transport


def run_inprocess(frontend, *, tenants: int, qps: float, n_requests: int,
                  rows: int, lo: float = 0.0, hi: float = 1.0,
                  seed: int = 0, timeout_s: float = 60.0) -> dict:
    """Open-loop load against an in-process ``Frontend``: ``tenants``
    streams × ``n_requests`` requests each at ``qps`` per stream.
    Payloads are seeded per (tenant, request) so reruns offer identical
    queries."""
    dim = frontend.session.index.dim
    t0 = time.monotonic()
    tickets = []  # (tenant, scheduled_s, ticket-or-None(rejected))
    lock = threading.Lock()

    def stream(ti: int):
        tenant = f"tenant-{ti}"
        for i in range(n_requests):
            due = t0 + i / qps
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            q = synth_queries(
                dim, rows, lo=lo, hi=hi, seed=seed + ti * 100003 + i
            )
            out = frontend.submit(tenant, q)
            with lock:
                tickets.append(
                    (tenant, due, None if isinstance(out, Rejection) else out)
                )

    threads = [
        threading.Thread(target=stream, args=(ti,), daemon=True)
        for ti in range(tenants)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()

    lat_s, rejected, errors, served_rows = [], 0, 0, 0
    per_tenant: dict[str, int] = {}
    deadline = time.monotonic() + timeout_s
    for tenant, due, ticket in tickets:
        if ticket is None:
            rejected += 1
            continue
        try:
            _, ids = ticket.result(timeout=max(0.0, deadline - time.monotonic()))
        except Exception:
            errors += 1
            continue
        lat_s.append(ticket.done_s - due)
        served_rows += int(ids.shape[0])
        per_tenant[tenant] = per_tenant.get(tenant, 0) + 1
    wall = (
        max(t.done_s for _, _, t in tickets if t is not None and t.done_s)
        - t0
        if any(t is not None and t.done_s for _, _, t in tickets)
        else time.monotonic() - t0
    )
    return _report(
        tenants=tenants, qps=qps, rows=rows, n_requests=n_requests,
        wall_s=wall, lat_s=lat_s, rejected=rejected, errors=errors,
        served_rows=served_rows, per_tenant=per_tenant,
    )


def run_sequential_baseline(session, *, tenants: int, n_requests: int,
                            rows: int, lo: float = 0.0, hi: float = 1.0,
                            seed: int = 0) -> dict:
    """The no-front-end anchor: the SAME request population served one
    request at a time, dispatch depth 1 (submit → retire before the next
    request — per-stream sequential dispatch). Each lone request pads to
    its own bucket, so the padded rows burned per request are exactly
    what coalescing exists to reclaim. The caller passes a depth-1
    session over the same index (``dispatch_depth=1``) so the comparison
    isolates coalescing, not pipelining."""
    dim = session.index.dim
    lat_s, served_rows = [], 0
    per_tenant: dict[str, int] = {}
    t0 = time.monotonic()
    for ti in range(tenants):
        tenant = f"tenant-{ti}"
        for i in range(n_requests):
            q = synth_queries(
                dim, rows, lo=lo, hi=hi, seed=seed + ti * 100003 + i
            )
            t1 = time.monotonic()
            done = session.submit(q, tenants=((tenant, rows),))
            done += session.drain()
            lat_s.append(time.monotonic() - t1)
            served_rows += sum(r.rows for r in done)
            per_tenant[tenant] = per_tenant.get(tenant, 0) + 1
    wall = time.monotonic() - t0
    return _report(
        tenants=tenants, qps=float("inf"), rows=rows,
        n_requests=n_requests, wall_s=wall, lat_s=lat_s, rejected=0,
        errors=0, served_rows=served_rows, per_tenant=per_tenant,
    )


# ---------------------------------------------------------------------------
# HTTP transport


def probe_server(url: str, timeout_s: float = 10.0) -> dict:
    """GET /healthz — the index facts (dim, k) a generator needs."""
    with urllib.request.urlopen(
        url.rstrip("/") + "/healthz", timeout=timeout_s
    ) as resp:
        return json.loads(resp.read())


def fetch_metrics(url: str, timeout_s: float = 10.0) -> str:
    """GET /metrics — the raw Prometheus exposition text."""
    with urllib.request.urlopen(
        url.rstrip("/") + "/metrics", timeout=timeout_s
    ) as resp:
        return resp.read().decode()


def _post_query(url: str, tenant: str, q: np.ndarray,
                timeout_s: float) -> tuple:
    """(status, rows_served): one POST /query round trip (raw f32 body —
    no JSON float inflation on the wire)."""
    req = urllib.request.Request(
        url.rstrip("/") + "/query",
        data=np.ascontiguousarray(q, dtype="<f4").tobytes(),
        headers={
            "Content-Type": "application/octet-stream",
            "X-Tenant": tenant,
        },
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            doc = json.loads(resp.read())
            return resp.status, int(doc.get("rows", 0))
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, 0
    except (urllib.error.URLError, OSError, TimeoutError, ValueError):
        # connection refused/reset, socket timeout, truncated body: the
        # exact failures an OVERLOADED server produces — they must land
        # in the report's error count, not kill the worker thread and
        # vanish from achieved/p99 (a load tool that loses its failures
        # under load flatters exactly what it exists to expose)
        return 0, 0


def _conn_open(target: str, timeout_s: float):
    """A connected keep-alive HTTPConnection with Nagle disabled: the
    request headers and the raw-f32 body go out as separate sends, and
    Nagle + delayed-ACK would stall every second send ~40ms — a
    per-request tax that would swamp the very reuse win this transport
    exists to measure."""
    import socket

    u = urllib.parse.urlsplit(target)
    conn = http.client.HTTPConnection(
        u.hostname, u.port or 80, timeout=timeout_s
    )
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


def _post_query_conn(conn, tenant: str, q: np.ndarray) -> tuple:
    """(status, rows_served) over a persistent connection — raises the
    transport errors (the caller owns stale-connection retry); non-200
    statuses come back as values, http.client never raises on them."""
    conn.request(
        "POST", "/query",
        body=np.ascontiguousarray(q, dtype="<f4").tobytes(),
        headers={
            "Content-Type": "application/octet-stream",
            "X-Tenant": tenant,
        },
    )
    resp = conn.getresponse()
    data = resp.read()  # always drain: keep-alive needs the body consumed
    if resp.status == 200:
        return resp.status, int(json.loads(data).get("rows", 0))
    return resp.status, 0


def run_http(url: str | None = None, *, targets=None, tenants: int,
             qps: float, n_requests: int, rows: int, lo: float = 0.0,
             hi: float = 1.0, seed: int = 0, timeout_s: float = 30.0,
             connect: str = "reuse", connections: int = 4) -> dict:
    """Open-loop load over HTTP against ``url`` or ``targets`` (tenant
    ``i`` drives ``targets[i % len(targets)]`` — round-robin tenant
    pinning, so a multi-replica direct baseline keeps each tenant's
    coalescing locality just like the router's affinity does).

    ``connect="reuse"`` (default): per tenant, an issuer thread enqueues
    requests at their scheduled arrivals and ``connections`` worker
    threads — each holding one persistent keep-alive connection — drain
    the queue. A request that finds every connection busy waits in the
    queue, and that wait is inside its latency (measured from the
    scheduled arrival): the open-loop contract survives the fixed pool.
    A stale keep-alive connection (server closed between requests) is
    reopened and the request retried once; a failure on a FRESH
    connection is counted, never retried.

    ``connect="per-request"``: the legacy transport — a fresh TCP
    connect and a worker thread per request (unbounded concurrency,
    per-connect overhead on every request)."""
    if targets is None:
        if url is None:
            raise ValueError("run_http needs url or targets")
        targets = [url]
    targets = [t.rstrip("/") for t in targets]
    if connect not in ("reuse", "per-request"):
        raise ValueError(f"unknown connect mode {connect!r}")
    dim = int(probe_server(targets[0])["dim"])
    t0 = time.monotonic()
    lock = threading.Lock()
    lat_s: list[float] = []
    stats = {"rejected": 0, "errors": 0, "served_rows": 0}
    by_status: dict[int, int] = {}
    per_tenant: dict[str, int] = {}

    def record(tenant: str, due: float, status: int, served: int) -> None:
        done = time.monotonic()
        with lock:
            by_status[status] = by_status.get(status, 0) + 1
            if status == 200:
                lat_s.append(done - due)
                stats["served_rows"] += served
                per_tenant[tenant] = per_tenant.get(tenant, 0) + 1
            elif status == 429:
                stats["rejected"] += 1
            else:
                stats["errors"] += 1

    def conn_worker(target: str, tenant: str, jobs) -> None:
        conn, fresh = None, True
        while True:
            item = jobs.get()
            if item is None:
                break
            due, q = item
            status, served = 0, 0
            for _attempt in range(2):
                try:
                    if conn is None:
                        conn, fresh = _conn_open(target, timeout_s), True
                    status, served = _post_query_conn(conn, tenant, q)
                    fresh = False
                    break
                except (OSError, http.client.HTTPException, ValueError,
                        TimeoutError):
                    if conn is not None:
                        try:
                            conn.close()
                        except OSError:
                            pass
                    conn = None
                    if fresh:
                        # a fresh connection failed: that is the server
                        # (refused/reset/timeout under overload) — count
                        # it, don't retry into the same failure
                        break
                    # stale keep-alive (server closed between requests):
                    # reconnect and retry this one request — queries are
                    # idempotent, and without the retry every server-side
                    # idle close would masquerade as a load failure
            record(tenant, due, status, served)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    workers: list[threading.Thread] = []
    tenant_jobs: dict[int, queue.Queue] = {}
    if connect == "reuse":
        for ti in range(tenants):
            jobs: queue.Queue = queue.Queue()
            tenant_jobs[ti] = jobs
            target = targets[ti % len(targets)]
            for c in range(connections):
                w = threading.Thread(
                    target=conn_worker,
                    args=(target, f"tenant-{ti}", jobs),
                    name=f"loadgen-conn-{ti}-{c}", daemon=True,
                )
                workers.append(w)
                w.start()

    def fire(target: str, tenant: str, due: float, q) -> None:
        status, served = _post_query(target, tenant, q, timeout_s)
        record(tenant, due, status, served)

    def stream(ti: int):
        tenant = f"tenant-{ti}"
        target = targets[ti % len(targets)]
        for i in range(n_requests):
            due = t0 + i / qps
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            q = synth_queries(
                dim, rows, lo=lo, hi=hi, seed=seed + ti * 100003 + i
            )
            if connect == "reuse":
                tenant_jobs[ti].put((due, q))
            else:
                w = threading.Thread(
                    target=fire, args=(target, tenant, due, q),
                    daemon=True,
                )
                with lock:
                    workers.append(w)
                w.start()

    issuers = [
        threading.Thread(target=stream, args=(ti,), daemon=True)
        for ti in range(tenants)
    ]
    for th in issuers:
        th.start()
    for th in issuers:
        th.join()
    for jobs in tenant_jobs.values():
        for _ in range(connections):
            jobs.put(None)
    for w in list(workers):
        w.join(timeout_s)
    wall = time.monotonic() - t0
    return _report(
        tenants=tenants, qps=qps, rows=rows, n_requests=n_requests,
        wall_s=wall, lat_s=lat_s, rejected=stats["rejected"],
        errors=stats["errors"], served_rows=stats["served_rows"],
        per_tenant=per_tenant, connect=connect, targets=targets,
        by_status=by_status,
    )


def sweep(run_one, qps_levels) -> list:
    """Offered-QPS sweep: ``run_one(qps) -> report`` at each level —
    the throughput-vs-p50/p99 curve, lowest load first."""
    return [run_one(q) for q in sorted(qps_levels)]
