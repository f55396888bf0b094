"""Deterministic request coalescing: many small concurrent streams in,
bucket-sized batches out (the JAX package's ``frontend/coalesce.py``).

Why coalescing: the card's kernels reach their rate only on large uniform
batches, and the serving engine's bucketed entries (``serve/engine.py``)
were built for exactly that, but real concurrent traffic arrives as many
small per-client requests. Serving each alone would pad every 16-row
request up to the base bucket and burn the pad rows as wasted work. The
coalescer merges requests from many tenants into one batch near the bucket
size, so steady-state traffic fills the entries the engine already built:
the front end builds no new entry, it only fills existing buckets.

The batching math:

- **admit until the bucket fills or the oldest request's wait budget
  expires.** A batch forms when pending rows reach ``max_batch_rows``
  (reason ``"fill"``: offered load fills buckets, the peak-throughput
  regime) or when ``now - oldest.arrival >= max_wait_s`` (reason
  ``"deadline"``: the latency floor under light load; no request waits
  more than ``max_wait_s`` for co-travelers).
- **round-robin draining with deadline-first rotation.** Requests stay in
  per-tenant FIFO queues; a forming batch takes ONE whole request per
  tenant per rotation pass, starting at the tenant owning the globally
  oldest request (so a deadline-triggered batch always contains the
  request whose deadline triggered it), cycling in first-seen tenant
  order until the next head does not fit or nothing is pending. One
  request per tenant per pass is the no-starvation guarantee: a flooding
  tenant contributes at most one more request per pass than the slowest
  active tenant.
- **requests are indivisible.** Splitting a request across batches would
  split its result across retires; whole-request admission keeps the
  scatter trivial and the coalesced results bit-identical to serving the
  request alone (each row's result is independent of its batch-mates,
  the same property that makes bucket padding sound).

Determinism: this module is a PURE state machine. Every decision is a
function of (state, ``now``) with ``now`` passed in explicitly (no
wall-clock reads, no threads, no sockets), so the tests assert coalescing
behavior exactly, replaying arrival orders under a fake clock. The
threaded binding that pumps it with real time lives in ``server.py``.

No torch (and no numpy) at module load: payloads are opaque here.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque

REASONS = ("fill", "deadline", "flush")


@dataclasses.dataclass(frozen=True)
class FrontendRequest:
    """One admitted client request: an opaque (rows, d) payload plus the
    bookkeeping the batcher needs. ``seq`` is the global admission order
    — the deterministic tie-break and the "oldest" ordering (arrival
    timestamps may collide under a coarse injected clock)."""

    tenant: str
    queries: object  # opaque payload; (rows, d) array for the server
    rows: int
    arrival_s: float
    seq: int

    def wait_s(self, now: float) -> float:
        return now - self.arrival_s


@dataclasses.dataclass(frozen=True)
class CoalescedBatch:
    """One formed batch: whole requests in admission slices, plus the
    formation story (why now, how full, who waited longest)."""

    parts: tuple  # (FrontendRequest, ...) in batch row order
    rows: int
    reason: str  # "fill" | "deadline" | "flush"
    formed_s: float
    oldest_wait_s: float

    @property
    def tenants(self) -> dict:
        """tenant -> rows composition (the ``ServeSession.submit``
        span/stats form, aggregated over parts)."""
        comp: dict[str, int] = {}
        for r in self.parts:
            comp[r.tenant] = comp.get(r.tenant, 0) + r.rows
        return comp

    def composition(self) -> tuple:
        """((tenant, rows), ...) per PART in row order — the exact
        ``tenants=`` argument for ``ServeSession.submit``."""
        return tuple((r.tenant, r.rows) for r in self.parts)

    def slices(self):
        """Yield (request, start, stop) row slices into the stacked
        batch — the scatter map back to per-request results."""
        off = 0
        for r in self.parts:
            yield r, off, off + r.rows
            off += r.rows


class Coalescer:
    """The pure batcher: per-tenant FIFO queues, fill-or-deadline batch
    formation, deadline-first round-robin draining. Thread-unsafe by
    design (the threaded wrapper holds its own lock); every method takes
    time as an argument."""

    def __init__(self, *, max_batch_rows: int, max_wait_s: float):
        if max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {max_batch_rows}"
            )
        if not max_wait_s >= 0.0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_batch_rows = max_batch_rows
        self.max_wait_s = max_wait_s
        # insertion-ordered tenant -> FIFO deque; empty deques are KEPT so
        # the first-seen rotation order is stable across a tenant's idle
        # gaps (fairness must not depend on who happened to drain to zero)
        self._queues: dict[str, deque] = {}
        self._seq = itertools.count()
        self._pending_rows = 0

    # -- admission --------------------------------------------------------

    def admit(self, tenant: str, queries, rows: int,
              now: float) -> FrontendRequest:
        """Enqueue one request (admission control — depth/rate — is the
        scheduler's job and has already happened). Oversized and empty
        requests are caller bugs here and raise."""
        rows = int(rows)
        if rows < 1:
            raise ValueError(f"request must have >= 1 row, got {rows}")
        if rows > self.max_batch_rows:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch_rows="
                f"{self.max_batch_rows} (the scheduler rejects these "
                "before admission)"
            )
        req = FrontendRequest(
            tenant=str(tenant), queries=queries, rows=rows,
            arrival_s=now, seq=next(self._seq),
        )
        self._queues.setdefault(req.tenant, deque()).append(req)
        self._pending_rows += rows
        return req

    # -- state ------------------------------------------------------------

    @property
    def pending_rows(self) -> int:
        return self._pending_rows

    @property
    def pending_requests(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_rows_for(self, tenant: str) -> int:
        q = self._queues.get(str(tenant))
        return sum(r.rows for r in q) if q else 0

    def _oldest(self) -> FrontendRequest | None:
        heads = [q[0] for q in self._queues.values() if q]
        return min(heads, key=lambda r: r.seq) if heads else None

    def next_deadline_s(self) -> float | None:
        """When the oldest pending request's wait budget expires (the
        wake-up time a pump should sleep until); None when idle."""
        oldest = self._oldest()
        return None if oldest is None else oldest.arrival_s + self.max_wait_s

    # -- batch formation --------------------------------------------------

    def pop_ready(self, now: float, flush: bool = False):
        """The next formed batch, or None when no formation condition
        holds. Callers loop (``while (b := pop_ready(now)):``) — a burst
        may fill several buckets at one instant. ``flush=True`` forms a
        batch from whatever is pending regardless of fill/deadline
        (shutdown: enqueued requests must not be stranded)."""
        oldest = self._oldest()
        if oldest is None:
            return None
        fill = self._pending_rows >= self.max_batch_rows
        expired = now - oldest.arrival_s >= self.max_wait_s
        if not (fill or expired or flush):
            return None
        reason = "fill" if fill else ("deadline" if expired else "flush")

        # rotation order: first-seen tenant order, started at the oldest
        # request's tenant — the deadline-ordered guarantee (the request
        # that triggered formation is the batch's first take)
        order = list(self._queues)
        start = order.index(oldest.tenant)
        order = order[start:] + order[:start]

        parts: list[FrontendRequest] = []
        rows = 0
        closed = False
        while not closed:
            progress = False
            for t in order:
                q = self._queues[t]
                if not q:
                    continue
                head = q[0]
                if rows + head.rows > self.max_batch_rows:
                    # first misfit closes the batch: skipping ahead to
                    # smaller requests would reorder service within the
                    # rotation and make formation depend on payload sizes
                    # in a way no fairness bound survives
                    closed = True
                    break
                q.popleft()
                parts.append(head)
                rows += head.rows
                progress = True
            if not progress:
                break
        self._pending_rows -= rows
        return CoalescedBatch(
            parts=tuple(parts), rows=rows, reason=reason, formed_s=now,
            oldest_wait_s=now - oldest.arrival_s,
        )
