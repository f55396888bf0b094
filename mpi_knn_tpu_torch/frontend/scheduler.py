"""SLO-aware admission and overload control above the coalescer (the JAX
package's ``frontend/scheduler.py``).

Three jobs, all deterministic functions of (state, ``now``):

- **Backpressure, never silent drops.** A request that cannot be served
  within the SLO is refused AT ADMISSION with a structured 429-style
  :class:`Rejection` (reason + retry-after), two ways: per-tenant queue
  depth (``max_queue_rows`` — a tenant that cannot drain its own queue
  must not grow it) and per-tenant offered rate (``max_tenant_qps``, a
  deterministic token bucket refilled on the injected clock). Rejected
  is counted per tenant in the registry; accepted work is NEVER dropped
  later — once admitted, a request is served or the process died.
- **Deadline-ordered dispatch.** ``poll`` forms batches via the
  coalescer, whose formation triggers on the oldest request's wait
  budget and whose rotation starts at that request's tenant
  (``coalesce.py``) — the dispatch order is the deadline order, with
  round-robin fairness inside each batch.
- **Overload shedding wired into the existing resilience ladder.** The
  coalescer queue is the overload signal the per-batch deadline cannot
  see early: when total pending rows have stayed at/above
  ``shed_queue_rows`` for ``shed_hold_s`` continuously, the scheduler
  fires ``on_shed`` (the server wires it to
  ``ServeSession.shed_rung(reason="queue-overload")`` — one rung of
  nprobe/2 → mixed → bucket/2, the recall-measured knobs from
  ``resilience/ladder.py``); when pending rows have stayed at/below
  ``recover_queue_rows`` for ``recover_hold_s``, it fires
  ``on_recover`` (→ ``restore_rung``). Every transition lands in the
  metrics registry and the flight record via those session methods, plus
  the scheduler's own ``frontend_overload_sheds_total`` /
  ``frontend_overload_recoveries_total`` counters and ``sheds`` /
  ``recoveries`` event lists here.

Pure and socket-free like the coalescer: the threaded pump in
``server.py`` calls ``submit``/``poll`` under its own lock with real
time; the tests drive this class directly with a fake clock and assert
rejection determinism and the shed/recover walk exactly.

No torch import at module load.
"""

from __future__ import annotations

import dataclasses

from mpi_knn_tpu_torch.frontend.coalesce import Coalescer
from mpi_knn_tpu_torch.obs import metrics as obs_metrics
from mpi_knn_tpu_torch.obs import spans as obs_spans


@dataclasses.dataclass(frozen=True)
class Rejection:
    """A structured 429-style refusal — the admission answer a client can
    act on (back off ``retry_after_s``, shrink the request), never a
    silent drop or a hung socket."""

    tenant: str
    reason: str  # "queue-depth" | "rate" | "oversized-request"
    detail: str
    retry_after_s: float
    status: int = 429


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Front-end SLO knobs (host-side session state, like
    ``ResiliencePolicy`` — nothing here reaches a lowering)."""

    # coalescing: batches target this many rows (pad to the engine's
    # query_bucket·2^j grid happens inside the serve engine; keep this ON
    # the grid so steady-state fill-batches land in one executable) and
    # no request waits longer than max_wait_s for co-travelers
    max_batch_rows: int = 1024
    max_wait_s: float = 0.002
    # backpressure: per-tenant queued-row ceiling, and an optional
    # per-tenant admission rate (requests/s, token bucket of `burst`)
    max_queue_rows: int = 8192
    max_tenant_qps: float | None = None
    burst: int = 32
    # overload shedding: total pending rows at/above shed_queue_rows for
    # shed_hold_s continuously walks the session's ladder one rung down;
    # at/below recover_queue_rows (default shed/2) for recover_hold_s
    # walks it back up. None = never shed (the scheduler still
    # backpressures per tenant).
    shed_queue_rows: int | None = None
    shed_hold_s: float = 0.05
    recover_queue_rows: int | None = None
    recover_hold_s: float = 0.25

    def __post_init__(self):
        if self.max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {self.max_batch_rows}"
            )
        if not self.max_wait_s >= 0.0:
            raise ValueError(
                f"max_wait_s must be >= 0, got {self.max_wait_s}"
            )
        if self.max_queue_rows < self.max_batch_rows:
            raise ValueError(
                f"max_queue_rows ({self.max_queue_rows}) below "
                f"max_batch_rows ({self.max_batch_rows}) could never "
                "admit a full batch"
            )
        if self.max_tenant_qps is not None and not self.max_tenant_qps > 0:
            raise ValueError(
                f"max_tenant_qps must be > 0 (or None), got "
                f"{self.max_tenant_qps}"
            )
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.shed_queue_rows is not None and self.shed_queue_rows < 1:
            raise ValueError(
                f"shed_queue_rows must be >= 1 (or None), got "
                f"{self.shed_queue_rows}"
            )
        if not self.shed_hold_s >= 0.0 or not self.recover_hold_s >= 0.0:
            raise ValueError("shed/recover hold times must be >= 0")
        if (
            self.recover_queue_rows is not None
            and self.shed_queue_rows is not None
            and self.recover_queue_rows >= self.shed_queue_rows
        ):
            raise ValueError(
                "recover_queue_rows must sit strictly below "
                "shed_queue_rows (hysteresis, or shed/recover would "
                "oscillate every poll)"
            )

    @property
    def recover_rows(self) -> int | None:
        if self.shed_queue_rows is None:
            return None
        if self.recover_queue_rows is not None:
            return self.recover_queue_rows
        return self.shed_queue_rows // 2


class FrontendScheduler:
    """Admission + coalescing + overload control for one serving session.
    ``on_shed``/``on_recover`` are no-arg callables returning the new
    rung label or None (the ``ServeSession.shed_rung``/``restore_rung``
    signature); None means the ladder had nothing left to give and is
    recorded as such."""

    def __init__(self, policy: SLOPolicy, *, on_shed=None, on_recover=None):
        self.policy = policy
        self.coalescer = Coalescer(
            max_batch_rows=policy.max_batch_rows,
            max_wait_s=policy.max_wait_s,
        )
        self.on_shed = on_shed
        self.on_recover = on_recover
        self._metrics = obs_metrics.get_registry()
        # token buckets: tenant -> [tokens, last_refill_s]
        self._buckets: dict[str, list] = {}
        # overload state: when the queue first crossed (and stayed
        # across) each threshold; None = not currently in that regime
        self._over_since: float | None = None
        self._under_since: float | None = None
        self._shed_depth = 0  # sheds minus recoveries (restores pending)
        self.sheds: list[dict] = []
        self.recoveries: list[dict] = []
        self.admitted = 0
        self.rejected = 0

    # -- admission --------------------------------------------------------

    def _reject(self, tenant, reason, detail, retry_after_s) -> Rejection:
        self.rejected += 1
        self._metrics.counter(
            "frontend_rejections_total",
            help="requests refused at admission (backpressure, "
            "never a silent drop)",
            labels={"tenant": tenant, "reason": reason},
        ).inc()
        return Rejection(
            tenant=tenant, reason=reason, detail=detail,
            retry_after_s=round(retry_after_s, 6),
        )

    def _check_tenant(self, tenant: str) -> Rejection | None:
        """Tenant-id sanitization shared by the query and mutation
        admission paths: a tenant id flows into metrics LABELS and
        flight attrs, so a value the exposition cannot carry verbatim
        must be refused HERE, at the edge — admitted-then-crash-at-
        retire would take the dispatch pump (and every other tenant)
        down with one hostile header."""
        if (
            not tenant or len(tenant) > 256
            or any(c in tenant for c in ('"', "\\", "\n", "\r"))
        ):
            return self._reject(
                "invalid", "bad-tenant",
                "tenant id must be 1-256 chars with no quotes, "
                "backslashes, or newlines",
                0.0,
            )
        return None

    def _take_token(self, tenant: str, now: float) -> Rejection | None:
        """One deterministic token-bucket charge (reads and writes share
        the per-tenant budget — a tenant cannot starve its own queries
        by flooding upserts, or vice versa). None = admitted."""
        pol = self.policy
        if pol.max_tenant_qps is None:
            return None
        tokens, last = self._buckets.get(tenant, (float(pol.burst), now))
        tokens = min(
            float(pol.burst), tokens + (now - last) * pol.max_tenant_qps
        )
        if tokens < 1.0:
            self._buckets[tenant] = [tokens, now]
            return self._reject(
                tenant, "rate",
                f"tenant exceeds max_tenant_qps={pol.max_tenant_qps}",
                (1.0 - tokens) / pol.max_tenant_qps,
            )
        self._buckets[tenant] = [tokens - 1.0, now]
        return None

    def submit(self, tenant: str, queries, rows: int, now: float):
        """Admit one request or refuse it: returns a
        :class:`~mpi_knn_tpu_torch.frontend.coalesce.FrontendRequest` (admitted
        — it WILL be served) or a :class:`Rejection`. Decisions are
        deterministic in (state, now): the same arrival sequence always
        admits and rejects the same requests."""
        tenant = str(tenant)
        rows = int(rows)
        pol = self.policy
        rej = self._check_tenant(tenant)
        if rej is not None:
            return rej
        if rows < 1 or rows > pol.max_batch_rows:
            return self._reject(
                tenant, "oversized-request",
                f"request of {rows} rows is outside [1, "
                f"max_batch_rows={pol.max_batch_rows}]; split it",
                0.0,
            )
        queued = self.coalescer.pending_rows_for(tenant)
        if queued + rows > pol.max_queue_rows:
            return self._reject(
                tenant, "queue-depth",
                f"tenant has {queued} rows queued; admitting {rows} more "
                f"would exceed max_queue_rows={pol.max_queue_rows}",
                pol.max_wait_s,
            )
        rej = self._take_token(tenant, now)
        if rej is not None:
            return rej
        req = self.coalescer.admit(tenant, queries, rows, now)
        self.admitted += 1
        self._metrics.counter(
            "frontend_requests_total",
            help="requests admitted into the coalescer",
            labels={"tenant": tenant},
        ).inc()
        return req

    def admit_mutation(self, tenant: str, rows: int, now: float):
        """Admission control for a MUTATION request (upsert/delete):
        same tenant validation, size ceiling, and per-tenant
        token bucket as queries (reads and writes share one offered-rate
        budget — a tenant cannot starve its own queries by flooding
        upserts, or vice versa), but no coalescer: mutations dispatch
        synchronously under the index's mutation lock. Returns None
        (admitted) or a structured :class:`Rejection` — the 429
        governance the HTTP layer translates onto the wire."""
        tenant = str(tenant)
        rows = int(rows)
        pol = self.policy
        rej = self._check_tenant(tenant)
        if rej is not None:
            return rej
        if rows < 1 or rows > pol.max_batch_rows:
            return self._reject(
                tenant, "oversized-request",
                f"mutation of {rows} rows is outside [1, "
                f"max_batch_rows={pol.max_batch_rows}]; split it",
                0.0,
            )
        rej = self._take_token(tenant, now)
        if rej is not None:
            return rej
        self.admitted += 1
        self._metrics.counter(
            "frontend_mutations_total",
            help="mutation requests admitted (upsert/delete)",
            labels={"tenant": tenant},
        ).inc()
        return None

    # -- dispatch ---------------------------------------------------------

    def poll(self, now: float, flush: bool = False) -> list:
        """Every batch ready to dispatch at ``now`` (possibly several
        after a burst), plus the overload bookkeeping tick. The caller
        dispatches them in order — which IS deadline order.

        The overload signal is the queue depth at poll ENTRY — how much
        work had accumulated by the time the dispatcher came back around.
        A dispatcher keeping up polls an almost-empty queue; one pinned
        inside a slow device dispatch returns to a deep one. Measuring
        after the pop would read ~0 either way (a poll always drains
        every formable batch) and overload would be invisible."""
        pending = self.coalescer.pending_rows
        self._metrics.gauge(
            "frontend_queue_rows",
            help="query rows waiting in the coalescer at poll entry (the "
            "overload signal)",
        ).set(pending)
        self._overload_tick(now, pending)
        batches = []
        while True:
            b = self.coalescer.pop_ready(now, flush=flush)
            if b is None:
                break
            batches.append(b)
        return batches

    def next_wake_s(self) -> float | None:
        """When the pump must poll again even without new arrivals: the
        oldest request's deadline (None = idle)."""
        return self.coalescer.next_deadline_s()

    # -- overload control --------------------------------------------------

    def _overload_tick(self, now: float, pending: int) -> None:
        pol = self.policy
        if pol.shed_queue_rows is None:
            return
        if pending >= pol.shed_queue_rows:
            self._under_since = None
            if self._over_since is None:
                self._over_since = now
            elif now - self._over_since >= pol.shed_hold_s:
                self._over_since = now  # re-arm: next shed needs a fresh hold
                self._shed(now, pending)
        else:
            self._over_since = None
            if self._shed_depth > 0 and pending <= pol.recover_rows:
                if self._under_since is None:
                    self._under_since = now
                elif now - self._under_since >= pol.recover_hold_s:
                    self._under_since = now
                    self._recover(now, pending)
            else:
                self._under_since = None

    def _shed(self, now: float, pending: int) -> None:
        rung = self.on_shed() if self.on_shed is not None else None
        if rung is not None:
            self._shed_depth += 1
        ev = {"t_s": now, "pending_rows": pending, "rung": rung}
        self.sheds.append(ev)
        self._metrics.counter(
            "frontend_overload_sheds_total",
            help="queue-growth sheds requested of the serving ladder "
            "(rung=None means the ladder was already at its floor)",
        ).inc()
        obs_spans.event(
            "frontend-shed", cat="frontend", pending_rows=pending,
            rung=rung,
        )

    def _recover(self, now: float, pending: int) -> None:
        rung = self.on_recover() if self.on_recover is not None else None
        if rung is not None:
            self._shed_depth -= 1
        else:
            self._shed_depth = 0  # session already at full: nothing to undo
        ev = {"t_s": now, "pending_rows": pending, "rung": rung}
        self.recoveries.append(ev)
        self._metrics.counter(
            "frontend_overload_recoveries_total",
            help="queue-drained recoveries restoring a shed ladder rung",
        ).inc()
        obs_spans.event(
            "frontend-recover", cat="frontend", pending_rows=pending,
            rung=rung,
        )
