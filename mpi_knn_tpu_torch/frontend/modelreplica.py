"""A torch-free stand-in replica with a DETERMINISTIC service model: the
router's test harness on hosts whose cores cannot host real replica
parallelism (the JAX package's ``frontend/modelreplica.py``).

Real ``serve`` processes time-slice a host of few cores, so aggregate
throughput behind the router could not exceed one replica's there. A
:class:`ModelReplica` replaces the serving session with ``lanes`` service
lanes of a fixed ``service_s`` each (capacity = lanes / service_s
requests/s, spent SLEEPING, which one core can run several of
concurrently), while speaking the real serve front end's HTTP surface
verbatim: ``POST /query`` (raw f32 or JSON), ``POST /upsert`` /
``/delete`` with the ``X-Mutation-Seq`` contract (duplicate suppression
AND the gapless-mark 409 refusal), ``GET /healthz`` with ``ready`` /
``applied_seq`` / ``queue_rows``, keep-alive throughout. So the router,
loadgen, and the scaling / affinity / convergence tests exercise the full
wire protocol; only the distance math is modeled.

Failure injection for membership tests: :meth:`fail` turns /healthz into
``ok: false`` (probe failures, then eviction) without dropping the
socket; :meth:`drop_mutations` fails only the mutation route (503) while
health stays green (the transient fan-out-leg failure that must leave a
replica lagging, never gapped); :meth:`kill` is the SIGKILL analogue: it
stops the listener AND severs every open keep-alive connection, so
in-flight requests die with transport errors exactly as a killed
process's would; :meth:`stop` is the graceful shutdown; :meth:`cold_reload`
resets the mutation state to a given baseline (the quarantine-exit path).

No torch import (that is the point).
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np

from mpi_knn_tpu_torch.frontend.server import (
    DEFAULT_TENANT,
    SEQ_HEADER,
    TENANT_HEADER,
)


class ModelReplica:
    """One modeled replica: an HTTP server whose query handler sleeps
    ``service_s`` on one of ``lanes`` serialized service lanes
    (``lanes=0`` = unlimited — a pure-transport server for connection-
    reuse benchmarks)."""

    def __init__(self, *, dim: int = 16, k: int = 4,
                 service_s: float = 0.0, lanes: int = 1,
                 warm_delay_s: float = 0.0, host: str = "127.0.0.1",
                 port: int = 0):
        self.dim = dim
        self.k = k
        self.service_s = service_s
        self._lanes = (
            threading.Semaphore(lanes) if lanes > 0 else None
        )
        self._lock = threading.Lock()
        self._applied_seq = 0
        self._mutations: list[tuple] = []  # (seq, path, tenant, ids)
        self._queries = 0
        self._waiting = 0
        self._failing = False
        self._drop_mutations = False
        self.started_s = time.monotonic()
        self.warm_delay_s = warm_delay_s
        from mpi_knn_tpu_torch.frontend.server import _tuned_server_class

        self._httpd = _tuned_server_class()(
            (host, port), _model_handler(self)
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="model-replica",
            daemon=True,
        )

    # -- lifecycle / injection --------------------------------------------

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ModelReplica":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10.0)

    def kill(self) -> None:
        """SIGKILL analogue: stop accepting and sever every open
        connection mid-flight — peers see transport failures, never an
        orderly close. (The tuned server severs live connections in
        ``server_close``, so a kill under load IS a stop under load —
        the alias keeps the drill's intent readable.)"""
        self.stop()

    def fail(self, failing: bool = True) -> None:
        """Make /healthz report ``ok: false`` (and queries 503) — the
        soft-death a router must evict on without a socket error."""
        with self._lock:
            self._failing = failing

    def drop_mutations(self, dropping: bool = True) -> None:
        """Make mutations fail 503 while /healthz stays ok — the
        TRANSIENT single-leg fan-out failure (a wedged apply, a dropped
        packet) that must leave this replica lagging-but-in-rotation,
        never applying later seqs over the hole."""
        with self._lock:
            self._drop_mutations = dropping

    def cold_reload(self, applied_seq: int = 0) -> None:
        """Reset the mutation state to ``applied_seq`` — a reload from
        an artifact current as of that seq (0 = the original)."""
        with self._lock:
            self._applied_seq = applied_seq
            self._mutations = []

    # -- state the tests assert -------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "applied_seq": self._applied_seq,
                "mutations": list(self._mutations),
                "queries": self._queries,
            }

    # -- handler backend ---------------------------------------------------

    def stats(self) -> dict:
        ready = (
            time.monotonic() - self.started_s >= self.warm_delay_s
        )
        with self._lock:
            return {
                "ok": not self._failing,
                "ready": ready and not self._failing,
                "warming": {"ready": 1 if ready else 0, "total": 1,
                            "done": ready},
                "uptime_s": round(
                    time.monotonic() - self.started_s, 3
                ),
                "queue_rows": self._waiting,
                "applied_seq": self._applied_seq,
                "queries_served": self._queries,
                "dim": self.dim,
                "k": self.k,
                "backend": "model",
                "max_batch_rows": 1024,
            }

    def serve_query(self, rows: int) -> dict:
        """Burn one service slot: queue on a lane, sleep the modeled
        batch time, return a shaped (all-zero) result."""
        with self._lock:
            if self._failing:
                return {"error": "failing"}
            self._waiting += 1
        try:
            if self._lanes is not None:
                with self._lanes:
                    if self.service_s > 0:
                        time.sleep(self.service_s)
            elif self.service_s > 0:
                time.sleep(self.service_s)
        finally:
            with self._lock:
                self._waiting -= 1
                self._queries += 1
        return {
            "rows": rows,
            "dists": [[0.0] * self.k] * rows,
            "ids": [list(range(self.k))] * rows,
        }

    def apply_mutation(self, path: str, tenant: str, ids,
                       seq: int | None) -> dict:
        with self._lock:
            if self._failing or self._drop_mutations:
                return {"error": "failing"}
            if seq is not None and seq <= self._applied_seq:
                return {"duplicate": True,
                        "applied_seq": self._applied_seq}
            if seq is not None and seq > self._applied_seq + 1:
                # the gapless-mark rule (the serve front end's 409):
                # applying over a hole would lose the missed seq —
                # refuse, stay lagging, let the router replay in order
                return {"error": "seq-gap", "status": 409,
                        "applied_seq": self._applied_seq}
            self._mutations.append((seq, path, tenant, list(ids)))
            if seq is not None and seq > self._applied_seq:
                self._applied_seq = seq
            out = {
                "upserts" if path == "/upsert" else "deletes": len(ids),
            }
            if seq is not None:
                out["applied_seq"] = self._applied_seq
            return out


def _model_handler(replica: ModelReplica):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A003
            pass

        def _json(self, status: int, doc: dict) -> None:
            body = (json.dumps(doc) + "\n").encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _rows(self, raw: bytes) -> int:
            ctype = (
                self.headers.get("Content-Type") or ""
            ).split(";")[0]
            if ctype == "application/octet-stream":
                if len(raw) % (4 * replica.dim):
                    raise ValueError("ragged raw body")
                return len(raw) // (4 * replica.dim)
            q = np.asarray(json.loads(raw)["queries"], np.float32)
            if q.ndim != 2 or q.shape[1] != replica.dim:
                raise ValueError(f"bad queries shape {q.shape}")
            return int(q.shape[0])

        def do_POST(self):  # noqa: N802 — stdlib handler convention
            tenant = self.headers.get(TENANT_HEADER, DEFAULT_TENANT)
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n > 0 else b""
            if self.path == "/query":
                try:
                    rows = self._rows(raw)
                except (ValueError, KeyError, TypeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                out = replica.serve_query(rows)
                self._json(503 if "error" in out else 200, out)
            elif self.path in ("/upsert", "/delete"):
                try:
                    doc = json.loads(raw)
                    ids = doc["ids"]
                    seq_h = self.headers.get(SEQ_HEADER)
                    seq = None if seq_h is None else int(seq_h)
                except (ValueError, KeyError, TypeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                out = replica.apply_mutation(self.path, tenant, ids, seq)
                status = out.pop("status", 503) if "error" in out else 200
                self._json(status, out)
            else:
                self._json(404, {"error": f"no such route {self.path}"})

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                st = replica.stats()
                self._json(200 if st["ok"] else 503, st)
            elif self.path == "/metrics":
                body = (
                    "# modeled replica: no registry\n".encode()
                )
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no such route {self.path}"})

    return Handler
