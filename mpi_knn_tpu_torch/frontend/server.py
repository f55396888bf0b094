"""The thin shells around the pure front end (the JAX package's
``frontend/server.py``): a threaded dispatch pump binding the scheduler to
one ``ServeSession``, and a stdlib HTTP server.

Layering (the testability contract): ``coalesce.py`` and ``scheduler.py``
are pure state machines with injected clocks; everything with behavior
worth asserting lives there and in the serving engine. THIS module only
adds the two unavoidable impurities, each as thin as it can be made:

- :class:`Frontend`: threads and real time. Client threads enqueue
  through ``submit`` (admission under one lock, O(us)); ONE pump thread
  polls the scheduler, stacks each coalesced batch, drives the session
  (the session has one dispatching caller by design: the pump), and
  scatters retired results back to per-request tickets.
- :class:`FrontendHTTPServer`: sockets. ``POST /query`` (JSON or raw
  little-endian f32 rows, tenant id in ``X-Tenant``), ``POST /upsert`` /
  ``/delete`` (``X-Mutation-Seq``), ``GET /metrics`` (the obs Prometheus
  exposition, the exact text ``parse_prometheus`` re-parses), ``GET
  /healthz`` (liveness and serving posture: rung, queue, uptime, and the
  index facts a load generator needs to shape requests). Handlers
  translate: 429 from a :class:`Rejection`, 400 from malformed payloads,
  200 with per-row results otherwise.

Why one pump thread: the engine's dispatch-ahead pipeline
(``dispatch_depth``) already provides the useful concurrency on the
device side; a second submitting thread would only interleave
``submit``/``drain`` nondeterministically. The pump wakes on new work
(condition variable) or the oldest request's coalescing deadline:
idle-spinning would burn a core, sleeping a fixed quantum would add it to
every light-load latency.

On a card, the pump makes the index's card its thread's current device
before its first dispatch. Mutations run on the HTTP handler threads,
each on its own current stream; the index's mutation lock and
``engine.order_stream`` put every batch and every mutation in the order
they took the lock, so an upsert answered 200 is seen by the next batch
the pump dispatches.

No torch import at module load (the session object carries everything).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from mpi_knn_tpu_torch.frontend.scheduler import (
    FrontendScheduler,
    Rejection,
    SLOPolicy,
)
from mpi_knn_tpu_torch.obs import metrics as obs_metrics
from mpi_knn_tpu_torch.obs import spans as obs_spans




class FrontendError(RuntimeError):
    """The pump died (or the session raised) with requests outstanding;
    carried to every waiting ticket so no client blocks forever."""


class Ticket:
    """One admitted request's rendezvous: the submitting thread waits on
    ``result``; the pump fulfills (or fails) it at retire."""

    __slots__ = ("request", "_event", "_dists", "_ids", "_error", "done_s")

    def __init__(self, request):
        self.request = request
        self._event = threading.Event()
        self._dists = None
        self._ids = None
        self._error = None
        self.done_s = None  # time.monotonic() at fulfill (loadgen's clock)

    def _fulfill(self, dists, ids) -> None:
        self._dists, self._ids = dists, ids
        self.done_s = time.monotonic()
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self.done_s = time.monotonic()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """(dists, ids) for this request's rows — blocks until the
        coalesced batch carrying it retires. Raises the serving error on
        failure, TimeoutError on timeout."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request seq={self.request.seq} not served within "
                f"{timeout}s (tenant={self.request.tenant!r})"
            )
        if self._error is not None:
            raise self._error
        return self._dists, self._ids


class Frontend:
    """Bind a :class:`FrontendScheduler` to one ``ServeSession`` with a
    dispatch pump thread. ``session`` should be constructed with a
    ``ResiliencePolicy`` (even the default one) when shedding is wanted:
    the degradation ladder is built at session construction, and a
    policy-less session has only its full rung to serve."""

    def __init__(self, session, policy: SLOPolicy,
                 clock=time.monotonic):
        self.session = session
        self.policy = policy
        self._clock = clock
        self.scheduler = FrontendScheduler(
            policy,
            on_shed=lambda: session.shed_rung(reason="queue-overload"),
            on_recover=lambda: session.restore_rung(
                reason="queue-recovered"
            ),
        )
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._tickets: dict[int, Ticket] = {}  # request seq -> ticket
        self._dispatched = []  # CoalescedBatch FIFO awaiting retire
        self._stop = False
        self._crashed: BaseException | None = None
        # highest router-stamped mutation sequence number applied here:
        # the router fans mutations out with X-Mutation-Seq and reads this
        # back from /healthz to track per-replica lag; seq <= applied is a
        # replayed duplicate and must not re-apply, and seq > applied + 1
        # is a GAP and must not apply either (409): applying over a hole
        # would advance the mark past a mutation this replica never saw,
        # losing it silently; the router's in-order replay is the only
        # path that moves a lagging replica
        self._applied_seq = 0
        self.started_s = time.monotonic()
        # the shipped device profile of the session's device, read once
        from mpi_knn_tpu_torch.analysis.cost import detected_profile

        self._profile_facts: dict | None = detected_profile(
            getattr(session.index, "device", None))
        # start-up readiness: set once the warm-up (every rung's entries
        # and the first dispatch of each bucket) has finished. While
        # unset, admission is PER BUCKET: a request whose row bucket's
        # entries are built serves, the rest get a structured 503
        # "warming" with the progress counters.
        self._serving_ready = threading.Event()
        self._warm_thread: threading.Thread | None = None
        self._pump = threading.Thread(
            target=self._run, name="frontend-pump", daemon=True
        )

    # -- lifecycle --------------------------------------------------------

    def start(self, warm_sizes=None, background: bool = False,
              warm_parallel: int | None = None) -> "Frontend":
        """Start the pump; ``warm_sizes`` (row counts) builds those
        buckets' entries at EVERY ladder rung first (``ServeSession.warm``,
        across ``warm_parallel`` threads, None = auto), so neither the
        first batch nor a shed rung builds into live traffic. One real
        zero-batch dispatch then runs per size through the one-shot
        ``query_knn`` path: the first dispatch of a bucket pays one-time
        costs (the kernel libraries' load, each kernel's first launch, the
        caching allocator's first blocks), and those belong in startup,
        not in the first client's latency. ``query_knn`` shares the
        entries but feeds no session window stats and no serving counters,
        so the warm-up is invisible to /metrics. The mutation path is
        warmed too (``serve/mutate.warm_mutation``) where the index takes
        live mutation.

        ``background=True`` is the bind-the-port-first start: the pump
        starts IMMEDIATELY and the warm-up runs on a daemon thread, so the
        HTTP server can listen while entries are still being built. Until
        the warm-up finishes, ``submit`` admits per bucket
        (``session.coalesced_ready``): traffic whose whole coalescable
        bucket span is built serves at once, the rest get a structured 503
        "warming" rejection carrying the ready/total progress that
        ``/healthz`` also reports.

        The default warm set is the full bucket LADDER from the config's
        base bucket up to the fill target: a coalesced batch can land in
        any power-of-two bucket in that span (a ragged deadline dispatch,
        a lull), and per-bucket admission during warming is only safe when
        the span a request could reach is entirely built."""
        if warm_sizes is None:
            base = self.session.cfg.query_bucket
            top = self.policy.max_batch_rows
            sizes, b = [], base
            while b < top:
                sizes.append(b)
                b *= 2
            sizes.append(top)
        else:
            sizes = list(warm_sizes)

        def _warm():
            try:
                if sizes:
                    from mpi_knn_tpu_torch.serve.engine import query_knn

                    self.session.warm(sizes, parallel=warm_parallel)
                    index = self.session.index
                    for n in sizes:
                        query_knn(
                            np.zeros((n, index.dim), np.float32),
                            index, self.session.cfg, device=index.device,
                        )
                # the mutation path too: a cold first upsert would pay its
                # lazy work while HOLDING the mutation lock, stalling batch
                # dispatch exactly once, at the worst time
                from mpi_knn_tpu_torch.serve.mutate import (
                    supports_mutation,
                    warm_mutation,
                )

                if supports_mutation(self.session.index):
                    warm_mutation(self.session.index, self.session.cfg)
            finally:
                # a failed warm releases the gate anyway: the same failure
                # will re-raise loudly on the dispatch path (where the
                # pump's error machinery fails tickets), whereas a stuck
                # gate would 503 every client forever
                self._serving_ready.set()

        if background:
            self._pump.start()
            self._warm_thread = threading.Thread(
                target=_warm, name="frontend-warm", daemon=True
            )
            self._warm_thread.start()
        else:
            _warm()
            self._pump.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Flush: every admitted request is served before the pump exits
        (admission stops immediately)."""
        with self._lock:
            self._stop = True
            self._work.notify()
        self._pump.join(timeout)

    # -- client side ------------------------------------------------------

    def submit(self, tenant: str, queries):
        """Admit one request (non-blocking): a :class:`Ticket` to wait
        on, or the scheduler's structured :class:`Rejection`."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError(
                f"queries must be (rows, dim), got shape {queries.shape}"
            )
        if not self._serving_ready.is_set() and not \
                self.session.coalesced_ready(
                    queries.shape[0], self.policy.max_batch_rows
                ):
            # per-bucket admission while warming: traffic whose entries
            # are built serves immediately; the rest are refused with the
            # warming progress, not queued behind a build that would blow
            # their deadline anyway. The progress copy goes through
            # warm_snapshot(), under the session's own lock
            ws = self.session.warm_snapshot()
            return Rejection(
                tenant=str(tenant), reason="warming",
                detail=(
                    f"bucket for {queries.shape[0]} rows not built yet "
                    f"({ws['ready']}/{ws['total']} entries ready)"
                ),
                retry_after_s=0.5,
                status=503,
            )
        with self._lock:
            if self._stop or self._crashed is not None:
                return Rejection(
                    tenant=str(tenant), reason="shutting-down",
                    detail="front end is stopping", retry_after_s=0.0,
                    status=503,
                )
            out = self.scheduler.submit(
                tenant, queries, queries.shape[0], self._clock()
            )
            if isinstance(out, Rejection):
                return out
            ticket = Ticket(out)
            self._tickets[out.seq] = ticket
            self._work.notify()
            return ticket

    def upsert(self, tenant: str, ids, rows, seq: int | None = None):
        """Admit and execute one tenant's upsert: 429-governed through the
        scheduler's shared per-tenant budget, then run synchronously on
        this (handler) thread; the index's mutation lock serializes it
        with the pump's batch dispatch (and ``engine.order_stream`` with
        its stream), so no ticket machinery is needed. Returns the
        mutation stats dict, or a structured :class:`Rejection`.

        ``seq`` is the router's per-index mutation sequence number: a seq
        at or below the high-water mark is a replayed duplicate,
        acknowledged without re-applying (and without charging the
        tenant's mutation budget), so the router's rejoin replay can
        safely overlap live fan-out; a seq past ``applied + 1`` is a gap,
        refused with a 409-status rejection (the router replays the hole
        forward in order)."""
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        with self._lock:
            if self._stop or self._crashed is not None:
                return Rejection(
                    tenant=str(tenant), reason="shutting-down",
                    detail="front end is stopping", retry_after_s=0.0,
                    status=503,
                )
            gate = self._seq_gate(tenant, seq, self._applied_seq)
            if gate is not None:
                return gate
            rej = self.scheduler.admit_mutation(
                tenant, rows.shape[0], self._clock()
            )
        if rej is not None:
            return rej
        out = self.session.upsert(ids, rows, tenant=str(tenant))
        return self._note_applied(out, seq)

    def delete(self, tenant: str, ids, seq: int | None = None):
        """Admit and execute one tenant's delete: the upsert path's 429
        governance (and seq duplicate/gap gating) over the tombstone
        scatter."""
        ids = np.asarray(ids).reshape(-1)
        with self._lock:
            if self._stop or self._crashed is not None:
                return Rejection(
                    tenant=str(tenant), reason="shutting-down",
                    detail="front end is stopping", retry_after_s=0.0,
                    status=503,
                )
            gate = self._seq_gate(tenant, seq, self._applied_seq)
            if gate is not None:
                return gate
            rej = self.scheduler.admit_mutation(
                tenant, max(1, ids.shape[0]), self._clock()
            )
        if rej is not None:
            return rej
        out = self.session.delete(ids, tenant=str(tenant))
        return self._note_applied(out, seq)

    @staticmethod
    def _seq_gate(tenant: str, seq: int | None, applied: int):
        """The stream-order gate, pure in ``applied`` (callers read the
        mark under ``_lock`` and pass it in): None means the seq is
        consumable (exactly ``applied + 1``, or unsequenced); a dict is
        the duplicate acknowledgment; a 409 :class:`Rejection` means the
        seq would leave a GAP. 409 is outside the router's deterministic
        set, so the leg stays unacknowledged and the probe loop replays
        the hole forward in order."""
        if seq is None:
            return None
        if seq <= applied:
            return {"duplicate": True, "applied_seq": applied}
        if seq > applied + 1:
            return Rejection(
                tenant=str(tenant), reason="seq-gap",
                detail=(
                    f"seq {seq} skips ahead of applied_seq "
                    f"{applied}; refusing to apply out of order"
                ),
                retry_after_s=0.5, status=409,
            )
        return None

    def _note_applied(self, out: dict, seq: int | None) -> dict:
        """Advance the mutation high-water mark AFTER the session applied
        the mutation (never on admission: a crash between admit and apply
        must leave the seq unacknowledged so replay re-sends it)."""
        if seq is not None:
            with self._lock:
                if seq > self._applied_seq:
                    self._applied_seq = seq
                out["applied_seq"] = self._applied_seq
        return out

    def _note_refused(self, seq: int | None) -> dict | None:
        """A DETERMINISTIC refusal (400/507) consumed its seq: the stream
        position advances exactly as an apply would, because a replay
        could only repeat the refusal (a position that did not advance
        would make this replica 409 every later seq forever: the stream
        has no skip marker). Returns the position facts for the refusal
        body, ``{"gap": True, ...}`` when the seq cannot be consumed in
        order (the handler must answer 409 seq-gap instead of its
        refusal), or None for an unsequenced mutation."""
        if seq is None:
            return None
        with self._lock:
            if seq > self._applied_seq + 1:
                return {"gap": True, "applied_seq": self._applied_seq}
            if seq > self._applied_seq:
                self._applied_seq = seq
            return {"applied_seq": self._applied_seq}

    def stats(self) -> dict:
        """The health/posture snapshot ``GET /healthz`` serves.

        Session state comes through the session's own locked snapshots
        (``warm_snapshot`` / ``stats_snapshot``), taken BEFORE the
        frontend lock: handler threads never read the session's window
        while the pump mutates it at retire, and keeping the two critical
        sections disjoint keeps the lock graph free of a Frontend ->
        Session edge from this path."""
        ses = self.session
        warm = ses.warm_snapshot()
        posture = ses.stats_snapshot()
        with self._lock:
            return {
                # a stopping frontend FAILS its health check on purpose: a
                # router must pull a draining replica out of rotation
                # before its socket goes away
                "ok": self._crashed is None and not self._stop,
                # start-up posture: entries ready/total while warming, and
                # whether the warm-up is done
                "ready": self._serving_ready.is_set() and not self._stop,
                "warming": {
                    "ready": warm["ready"],
                    "total": warm["total"],
                    "done": self._serving_ready.is_set(),
                },
                "uptime_s": round(time.monotonic() - self.started_s, 3),
                "queue_rows": self.scheduler.coalescer.pending_rows,
                "queue_requests": self.scheduler.coalescer.pending_requests,
                "admitted": self.scheduler.admitted,
                "rejected": self.scheduler.rejected,
                "rung": posture["rung"],
                "ladder": [label for label, _ in ses.ladder],
                "sheds": len(self.scheduler.sheds),
                "recoveries": len(self.scheduler.recoveries),
                "batches_retired": posture["batches_retired"],
                "queries_served": posture["queries_served"],
                "tenants": posture["tenants"],
                # live-mutation posture: the session window's
                # upsert/delete/compaction counts
                "mutation": posture.get("mutation", {}),
                # router mutation high-water mark: the probe loop reads
                # per-replica lag from here
                "applied_seq": self._applied_seq,
                # what a load generator needs to shape requests
                "dim": ses.index.dim,
                "k": ses.cfg.k,
                "backend": ses.index.backend,
                "max_batch_rows": self.policy.max_batch_rows,
                # the device bytes of the index and its largest built
                # entry (engine.index_peak_hbm_bytes): an operator sizing
                # a box reads it here next to dim/k/backend
                "peak_hbm_bytes": posture.get("peak_hbm_bytes", 0),
                # the declared roofline inputs of this hardware: the
                # shipped device profile the planner predicted q/s under
                # (analysis/cost.py), null off the profile map — never a
                # guessed device
                "device_profile": self._profile_facts,
            }

    # -- pump -------------------------------------------------------------

    def _run(self) -> None:
        try:
            device = getattr(self.session.index, "device", None)
            if getattr(device, "type", None) == "cuda":
                import torch

                torch.cuda.set_device(device)
            while True:
                with self._lock:
                    stopping = self._stop
                    batches = self.scheduler.poll(
                        self._clock(), flush=stopping
                    )
                for b in batches:
                    self._dispatch(b)
                if not batches:
                    # nothing formed: retire in-flight work so results
                    # are not held hostage to the NEXT batch arriving
                    # (dispatch-ahead depth > 1 would otherwise strand
                    # the last batch of a lull in the pipeline)
                    if self._dispatched:
                        for res in self.session.drain():
                            self._scatter(res)
                    with self._lock:
                        if self._stop and not (
                            self._dispatched
                            or self.scheduler.coalescer.pending_rows
                        ):
                            return
                        wake = self.scheduler.next_wake_s()
                        timeout = (
                            0.05 if wake is None
                            else max(0.0, wake - self._clock())
                        )
                        if not self._stop:
                            self._work.wait(timeout=min(timeout, 0.05))
        except BaseException as e:  # noqa: BLE001 — fail tickets, re-raise
            with self._lock:
                self._crashed = e
                err = FrontendError(
                    f"frontend pump died: {type(e).__name__}: {e}"
                )
                for t in self._tickets.values():
                    if not t.done():
                        t._fail(err)
                self._tickets.clear()
                self._dispatched.clear()
            raise

    def _dispatch(self, batch) -> None:
        q = np.concatenate([r.queries for r in batch.parts], axis=0)
        self._metrics().histogram(
            "frontend_batch_fill_rows",
            help="coalesced rows per dispatched batch",
            buckets=_FILL_BUCKETS,
        ).observe(batch.rows)
        self._metrics().counter(
            "frontend_batches_total",
            help="coalesced batches dispatched",
            labels={"reason": batch.reason},
        ).inc()
        obs_spans.event(
            "coalesce", cat="frontend", rows=batch.rows,
            requests=len(batch.parts), reason=batch.reason,
            oldest_wait_ms=round(batch.oldest_wait_s * 1e3, 3),
        )
        self._dispatched.append(batch)
        for res in self.session.submit(q, tenants=batch.composition()):
            self._scatter(res)

    def _scatter(self, res) -> None:
        batch = self._dispatched.pop(0)
        dists, ids = res.dists, res.ids  # one D2H, padding stripped
        with self._lock:
            for req, start, stop in batch.slices():
                t = self._tickets.pop(req.seq, None)
                if t is not None:
                    t._fulfill(dists[start:stop], ids[start:stop])

    def _metrics(self):
        return obs_metrics.get_registry()


# ---------------------------------------------------------------------------
# HTTP layer

# fill histogram: powers of two around common bucket grids
_FILL_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _tuned_server_class():
    """``ThreadingHTTPServer`` tuned for a load-bearing loopback tier:

    - the stdlib's accept backlog of 5 DROPS connection bursts (an
      open-loop generator or a router opening its pool refused at the
      kernel) — raised to 128;
    - Nagle + delayed-ACK stalls the headers/body response pair ~40ms
      per request on KEEP-ALIVE connections (fresh connections hide it
      behind Linux quickack) — NODELAY is set on the accepted socket
      here, because ``disable_nagle_algorithm`` is a *handler* knob and
      the handler classes are per-caller closures;
    - ``server_close`` SEVERS live keep-alive connections: a threaded
      stdlib server otherwise leaves handler threads serving pooled
      connections after shutdown, so a "stopped" server keeps answering
      its old peers — a zombie a router would keep probing forever
      while its replacement listens unvisited on the same port. A real
      process's sockets die with it; an in-process stop must match.
    """
    import socket

    from http.server import ThreadingHTTPServer

    class TunedHTTPServer(ThreadingHTTPServer):
        request_queue_size = 128
        daemon_threads = True

        def __init__(self, *args, **kwargs):
            self._live_socks: set = set()
            self._live_lock = threading.Lock()
            ThreadingHTTPServer.__init__(self, *args, **kwargs)

        def get_request(self):
            sock, addr = ThreadingHTTPServer.get_request(self)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._live_lock:
                self._live_socks.add(sock)
            return sock, addr

        def shutdown_request(self, request):
            with self._live_lock:
                self._live_socks.discard(request)
            ThreadingHTTPServer.shutdown_request(self, request)

        def server_close(self):
            ThreadingHTTPServer.server_close(self)
            with self._live_lock:
                socks = list(self._live_socks)
                self._live_socks.clear()
            for s in socks:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

        def handle_error(self, request, client_address):
            import sys

            # a peer that went away mid-request (severed connection,
            # killed client) is routine for a load-bearing tier, not a
            # traceback; anything else still gets the stdlib report
            if isinstance(sys.exc_info()[1],
                          (ConnectionError, TimeoutError, OSError)):
                return
            ThreadingHTTPServer.handle_error(
                self, request, client_address
            )

    return TunedHTTPServer

TENANT_HEADER = "X-Tenant"
DEFAULT_TENANT = "default"
# the router's per-index mutation sequence number
SEQ_HEADER = "X-Mutation-Seq"


def _http_handler(frontend: Frontend, request_timeout_s: float,
                  quiet: bool = True):
    """The BaseHTTPRequestHandler subclass bound to one frontend —
    built by closure (stdlib handlers have no constructor channel)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, status: int, doc: dict) -> None:
            body = (json.dumps(doc) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _text(self, status: int, text: str, ctype: str) -> None:
            body = text.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # noqa: A003
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _read_queries(self):
            """(rows, dim) f32 from the request body: JSON
            ``{"queries": [[...], ...]}`` or raw little-endian f32 rows
            at the index dim (``application/octet-stream``)."""
            n = int(self.headers.get("Content-Length") or 0)
            if n <= 0:
                raise ValueError("empty request body")
            raw = self.rfile.read(n)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            dim = frontend.session.index.dim
            if ctype == "application/octet-stream":
                if len(raw) % (4 * dim):
                    raise ValueError(
                        f"raw f32 body of {len(raw)} bytes is not a "
                        f"whole number of dim={dim} rows"
                    )
                return np.frombuffer(raw, dtype="<f4").reshape(-1, dim)
            doc = json.loads(raw)
            q = np.asarray(doc["queries"], dtype=np.float32)
            if q.ndim != 2 or q.shape[1] != dim:
                raise ValueError(
                    f"queries shape {q.shape} does not match index "
                    f"dim {dim}"
                )
            return q

        def _reject(self, out: Rejection) -> None:
            self.send_response(out.status)
            body = (json.dumps({
                "error": out.reason,
                "detail": out.detail,
                "tenant": out.tenant,
                "retry_after_s": out.retry_after_s,
            }) + "\n").encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After",
                             str(max(0.0, out.retry_after_s)))
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            n = int(self.headers.get("Content-Length") or 0)
            if n <= 0:
                raise ValueError("empty request body")
            return json.loads(self.rfile.read(n))

        def _refuse_mutation(self, status: int, doc: dict, seq) -> None:
            """Send a DETERMINISTIC refusal (400/507): the seq is
            consumed (the router acks these — a replay could only
            repeat them, so the stream position must move past), unless
            it would leave a gap, which downgrades the answer to a 409
            the router never acks."""
            note = frontend._note_refused(seq)
            if note is not None and note.pop("gap", False):
                self._json(409, {"error": "seq-gap", **note})
                return
            if note is not None:
                doc = {**doc, **note}
            self._json(status, doc)

        def _do_mutation(self, tenant: str) -> None:
            """POST /upsert {"ids": [...], "rows": [[...]]} and
            POST /delete {"ids": [...]} — tenant-attributed (X-Tenant),
            429-governed through the scheduler's shared budget,
            dispatched synchronously (the mutation lock serializes with
            batch dispatch). Headroom overflow on the serial layout
            surfaces as 507 (no re-cluster pass to absorb it); clustered
            layouts compact-and-retry inside the session."""
            from mpi_knn_tpu_torch.ivf.mutate import BucketOverflowError

            seq = None
            try:
                seq_h = self.headers.get(SEQ_HEADER)
                seq = None if seq_h is None else int(seq_h)
                doc = self._read_json()
                ids = doc["ids"]
                if self.path == "/upsert":
                    dim = frontend.session.index.dim
                    rows = np.asarray(doc["rows"], dtype=np.float32)
                    if rows.ndim != 2 or rows.shape[1] != dim:
                        raise ValueError(
                            f"rows shape {rows.shape} does not match "
                            f"index dim {dim}"
                        )
                    if len(ids) != rows.shape[0]:
                        raise ValueError(
                            f"{len(ids)} ids but {rows.shape[0]} rows"
                        )
            except (ValueError, KeyError, TypeError) as e:
                self._refuse_mutation(400, {"error": str(e)}, seq)
                return
            try:
                if self.path == "/upsert":
                    out = frontend.upsert(tenant, ids, rows, seq=seq)
                else:
                    out = frontend.delete(tenant, ids, seq=seq)
            except BucketOverflowError as e:
                self._refuse_mutation(
                    507, {"error": "headroom-exhausted",
                          "detail": str(e)}, seq,
                )
                return
            except ValueError as e:
                self._refuse_mutation(400, {"error": str(e)}, seq)
                return
            except Exception as e:  # noqa: BLE001 — serving error
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if isinstance(out, Rejection):
                self._reject(out)
                return
            self._json(200, out)

        def do_POST(self):  # noqa: N802 — stdlib handler convention
            tenant = self.headers.get(TENANT_HEADER, DEFAULT_TENANT)
            if self.path in ("/upsert", "/delete"):
                self._do_mutation(tenant)
                return
            if self.path != "/query":
                self._json(404, {"error": f"no such route {self.path}"})
                return
            try:
                q = self._read_queries()
            except (ValueError, KeyError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            out = frontend.submit(tenant, q)
            if isinstance(out, Rejection):
                self._reject(out)
                return
            try:
                dists, ids = out.result(timeout=request_timeout_s)
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
                return
            except Exception as e:  # serving error (sentinel, …)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {
                "rows": int(ids.shape[0]),
                "dists": [[float(v) for v in row] for row in dists],
                "ids": ids.tolist(),
            })

        def do_GET(self):  # noqa: N802
            if self.path == "/metrics":
                self._text(
                    200, obs_metrics.get_registry().to_prometheus(),
                    "text/plain; version=0.0.4",
                )
            elif self.path == "/healthz":
                st = frontend.stats()
                self._json(200 if st["ok"] else 503, st)
            else:
                self._json(404, {"error": f"no such route {self.path}"})

    return Handler


class FrontendHTTPServer:
    """``ThreadingHTTPServer`` wrapper: bind, serve in a thread, expose
    the bound address (``--port 0`` picks an ephemeral port)."""

    def __init__(self, frontend: Frontend, host: str = "127.0.0.1",
                 port: int = 0, request_timeout_s: float = 30.0,
                 quiet: bool = True):
        self.frontend = frontend
        self._httpd = _tuned_server_class()(
            (host, port), _http_handler(frontend, request_timeout_s, quiet)
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="frontend-http",
            daemon=True,
        )

    @property
    def address(self) -> tuple:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "FrontendHTTPServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10.0)
