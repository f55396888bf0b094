"""The port's serving front end, pure layer: the coalescer and the SLO
scheduler as deterministic state machines (no torch, no sockets, no
threads, every clock injected), held against the JAX package's.

- Parity: one request trace with one fake clock, fed through the
  reference's ``Coalescer`` / ``FrontendScheduler`` and the port's, gives
  identical batches (composition, reason, rows), identical rejections
  (reason, status, retry-after) and identical shed / recover times.
- The reference's own cases (``tests/test_frontend.py``), run against the
  port: batch formation, conservation and FIFO order over seeded arrival
  orders, the row cap, bit-determinism, round-robin fairness, deadline
  order, structured backpressure, and the overload shed / recover walk
  with its hysteresis.
"""

from __future__ import annotations

import random

import pytest

from mpi_knn_tpu.frontend import coalesce as ref_coalesce
from mpi_knn_tpu.frontend import scheduler as ref_scheduler
from mpi_knn_tpu_torch.frontend.coalesce import Coalescer
from mpi_knn_tpu_torch.frontend.scheduler import (
    FrontendScheduler,
    Rejection,
    SLOPolicy,
)

# ---------------------------------------------------------------------------
# coalescer: formation triggers


def test_no_batch_before_fill_or_deadline():
    co = Coalescer(max_batch_rows=64, max_wait_s=0.010)
    co.admit("a", None, 16, now=0.0)
    co.admit("b", None, 16, now=0.001)
    assert co.pop_ready(0.005) is None  # 32 < 64 rows, oldest waited 5ms
    assert co.pending_rows == 32


def test_fill_triggers_immediately():
    co = Coalescer(max_batch_rows=64, max_wait_s=10.0)
    for i in range(4):
        co.admit(f"t{i}", None, 16, now=0.0)
    b = co.pop_ready(0.0)
    assert b is not None and b.reason == "fill"
    assert b.rows == 64 and len(b.parts) == 4
    assert co.pending_rows == 0 and co.pop_ready(0.0) is None


def test_deadline_triggers_ragged_batch():
    co = Coalescer(max_batch_rows=128, max_wait_s=0.010)
    co.admit("a", None, 16, now=0.0)
    assert co.pop_ready(0.0099) is None
    b = co.pop_ready(0.010)
    assert b is not None and b.reason == "deadline"
    assert b.rows == 16 and b.oldest_wait_s == pytest.approx(0.010)


def test_next_deadline_is_oldest_plus_max_wait():
    co = Coalescer(max_batch_rows=128, max_wait_s=0.010)
    assert co.next_deadline_s() is None
    co.admit("a", None, 8, now=0.002)
    co.admit("b", None, 8, now=0.001)  # later admit, earlier... no:
    # seq order is admission order, so "a" (seq 0) is the oldest even
    # though "b" carries a smaller timestamp — admission order IS the
    # deterministic arrival order under a coarse clock
    assert co.next_deadline_s() == pytest.approx(0.002 + 0.010)


def test_flush_forms_regardless():
    co = Coalescer(max_batch_rows=128, max_wait_s=10.0)
    co.admit("a", None, 8, now=0.0)
    assert co.pop_ready(0.0) is None
    b = co.pop_ready(0.0, flush=True)
    assert b is not None and b.reason == "flush" and b.rows == 8


def test_burst_forms_multiple_batches_in_one_poll():
    co = Coalescer(max_batch_rows=32, max_wait_s=10.0)
    for i in range(6):
        co.admit("a", None, 16, now=0.0)
    batches = []
    while (b := co.pop_ready(0.0)) is not None:
        batches.append(b)
    assert [b.rows for b in batches] == [32, 32, 32]


def test_oversized_and_empty_requests_raise_at_admit():
    co = Coalescer(max_batch_rows=32, max_wait_s=0.0)
    with pytest.raises(ValueError, match="exceeds max_batch_rows"):
        co.admit("a", None, 33, now=0.0)
    with pytest.raises(ValueError, match=">= 1 row"):
        co.admit("a", None, 0, now=0.0)


# ---------------------------------------------------------------------------
# coalescer: property tests over arrival orders


def _drive(events, max_batch_rows=64, max_wait_s=0.01):
    """Replay (kind, ...) events; returns the formed batches."""
    co = Coalescer(max_batch_rows=max_batch_rows, max_wait_s=max_wait_s)
    batches = []
    for ev in events:
        if ev[0] == "admit":
            _, tenant, rows, now = ev
            co.admit(tenant, None, rows, now)
        else:
            _, now = ev
            while (b := co.pop_ready(now)) is not None:
                batches.append(b)
    while (b := co.pop_ready(events[-1][-1], flush=True)) is not None:
        batches.append(b)
    return batches


def _random_events(seed, n_tenants=4, n_requests=60):
    rng = random.Random(seed)
    events, now = [], 0.0
    for _ in range(n_requests):
        now += rng.random() * 0.004
        events.append(
            ("admit", f"t{rng.randrange(n_tenants)}",
             rng.choice([1, 4, 8, 16, 32]), now)
        )
        if rng.random() < 0.5:
            events.append(("poll", now))
        if rng.random() < 0.3:
            now += 0.012  # jump past the wait budget
            events.append(("poll", now))
    events.append(("poll", now + 0.02))
    return events


@pytest.mark.parametrize("seed", range(8))
def test_property_conservation_fifo_and_caps(seed):
    """Over random arrival orders: every request serves exactly once,
    per-tenant FIFO order survives coalescing, no batch exceeds the row
    cap, and fill batches only form at/above the cap."""
    events = _random_events(seed)
    batches = _drive(events)
    admitted = [(e[1], e[2]) for e in events if e[0] == "admit"]
    served = [(r.tenant, r.rows) for b in batches for r in b.parts]
    # conservation: same multiset, nothing duplicated or dropped
    assert sorted(served) == sorted(admitted)
    seqs_seen = [r.seq for b in batches for r in b.parts]
    assert len(seqs_seen) == len(set(seqs_seen))
    # per-tenant FIFO: each tenant's seqs appear in admission order
    per_tenant: dict[str, list] = {}
    for b in batches:
        for r in b.parts:
            per_tenant.setdefault(r.tenant, []).append(r.seq)
    for seqs in per_tenant.values():
        assert seqs == sorted(seqs)
    for b in batches:
        assert b.rows == sum(r.rows for r in b.parts) <= 64
        if b.reason == "fill":
            # a fill batch formed because pending >= cap; with whole-
            # request granularity it still lands within one request of
            # full (the first misfit closes it)
            assert b.rows > 64 - 32


@pytest.mark.parametrize("seed", range(4))
def test_property_bit_determinism(seed):
    """The same arrival sequence always forms the same batches — the
    decisions are functions of (state, now) only."""
    events = _random_events(seed)
    a = _drive(events)
    b = _drive(events)
    assert [[r.seq for r in x.parts] for x in a] == \
        [[r.seq for r in x.parts] for x in b]
    assert [(x.rows, x.reason) for x in a] == [(x.rows, x.reason) for x in b]


def test_property_max_wait_bound():
    """No request waits beyond its budget when the pump polls at the
    deadline the coalescer itself announces."""
    co = Coalescer(max_batch_rows=1024, max_wait_s=0.010)
    rng = random.Random(5)
    now, pending, worst = 0.0, [], 0.0
    for i in range(200):
        now += rng.random() * 0.003
        co.admit(f"t{i % 3}", None, rng.choice([1, 8, 16]), now)
        pending.append(now)
        wake = co.next_deadline_s()
        if wake is not None and wake <= now:
            while (b := co.pop_ready(now)) is not None:
                for r in b.parts:
                    worst = max(worst, now - r.arrival_s)
                    pending.remove(r.arrival_s)
    # polls happen exactly at announced deadlines, so the worst wait is
    # bounded by max_wait plus one inter-arrival gap (< 3 ms here)
    assert worst <= 0.010 + 0.003 + 1e-9


def test_fairness_round_robin_bound():
    """Symmetric sustained backlog: round-robin draining serves every
    tenant the same number of requests per batch (skew <= 1 request),
    and the served max/min ratio over the run stays ~1 — the
    no-starvation bound."""
    co = Coalescer(max_batch_rows=64, max_wait_s=10.0)
    n_tenants = 4
    for i in range(40):  # 10 requests of 8 rows per tenant, interleaved
        co.admit(f"t{i % n_tenants}", None, 8, now=0.0)
    served: dict[str, int] = {}
    batches = []
    while (b := co.pop_ready(0.0)) is not None:
        batches.append(b)
        per_batch: dict[str, int] = {}
        for r in b.parts:
            served[r.tenant] = served.get(r.tenant, 0) + 1
            per_batch[r.tenant] = per_batch.get(r.tenant, 0) + 1
        # within one batch: at most one request of skew between tenants
        assert max(per_batch.values()) - min(per_batch.values()) <= 1
    assert len(batches) == 5  # 320 rows / 64
    assert max(served.values()) / min(served.values()) <= 1.5
    assert sum(served.values()) == 40


def test_fairness_flooder_cannot_starve_slow_tenant():
    """One tenant floods, one trickles: the trickler's request rides the
    very next batch (one-request-per-tenant-per-pass), not the tail of
    the flooder's backlog."""
    co = Coalescer(max_batch_rows=32, max_wait_s=10.0)
    for _ in range(20):
        co.admit("flood", None, 16, now=0.0)
    co.admit("slow", None, 16, now=0.001)
    b = co.pop_ready(0.001)
    assert sorted(r.tenant for r in b.parts) == ["flood", "slow"]


def test_deadline_triggered_batch_contains_the_oldest():
    """The request whose expired budget triggered formation is aboard —
    the rotation starts at its tenant."""
    co = Coalescer(max_batch_rows=32, max_wait_s=0.010)
    co.admit("a", None, 4, now=0.0)  # the oldest
    for _ in range(3):
        co.admit("b", None, 4, now=0.008)
    b = co.pop_ready(0.010)
    assert b.reason == "deadline"
    assert b.parts[0].tenant == "a" and b.parts[0].seq == 0


# ---------------------------------------------------------------------------
# scheduler: structured backpressure


def _policy(**kw):
    base = dict(max_batch_rows=64, max_wait_s=0.01, max_queue_rows=128)
    base.update(kw)
    return SLOPolicy(**base)


def test_queue_depth_rejection_is_structured_and_deterministic():
    sched = FrontendScheduler(_policy())
    outs = [sched.submit("a", None, 64, now=0.0) for _ in range(3)]
    assert not isinstance(outs[0], Rejection)
    assert not isinstance(outs[1], Rejection)  # 128 rows queued = the cap
    r = outs[2]
    assert isinstance(r, Rejection) and r.reason == "queue-depth"
    assert r.status == 429 and r.retry_after_s >= 0
    # another tenant is untouched by a's backpressure
    assert not isinstance(sched.submit("b", None, 64, now=0.0), Rejection)
    # determinism: replay the identical sequence — identical verdicts
    sched2 = FrontendScheduler(_policy())
    outs2 = [sched2.submit("a", None, 64, now=0.0) for _ in range(3)]
    assert [isinstance(o, Rejection) for o in outs2] == \
        [isinstance(o, Rejection) for o in outs]


def test_rate_limit_token_bucket():
    sched = FrontendScheduler(
        _policy(max_tenant_qps=10.0, burst=2, max_queue_rows=10_000)
    )
    a = sched.submit("a", None, 1, now=0.0)
    b = sched.submit("a", None, 1, now=0.0)
    c = sched.submit("a", None, 1, now=0.0)  # burst of 2 exhausted
    assert not isinstance(a, Rejection) and not isinstance(b, Rejection)
    assert isinstance(c, Rejection) and c.reason == "rate"
    assert c.retry_after_s == pytest.approx(0.1, rel=0.01)
    # tokens refill on the injected clock
    d = sched.submit("a", None, 1, now=0.2)
    assert not isinstance(d, Rejection)
    # other tenants have their own bucket
    assert not isinstance(sched.submit("b", None, 1, now=0.0), Rejection)


def test_oversized_request_rejected_not_raised():
    sched = FrontendScheduler(_policy())
    r = sched.submit("a", None, 65, now=0.0)
    assert isinstance(r, Rejection) and r.reason == "oversized-request"
    r0 = sched.submit("a", None, 0, now=0.0)
    assert isinstance(r0, Rejection) and r0.reason == "oversized-request"


def test_admitted_requests_always_serve():
    """Backpressure happens at admission ONLY: whatever was admitted
    comes back out of poll, nothing is dropped later."""
    sched = FrontendScheduler(_policy())
    n_admitted = 0
    for i in range(10):
        out = sched.submit(f"t{i % 3}", None, 48, now=0.0)
        n_admitted += 0 if isinstance(out, Rejection) else 1
    served = sum(
        len(b.parts) for b in sched.poll(1.0, flush=True)
    )
    assert served == n_admitted == sched.admitted


# ---------------------------------------------------------------------------
# scheduler: overload shed / recover (injected clock, injected session)


class _FakeLadder:
    """Stands in for ServeSession.shed_rung/restore_rung: a 3-rung walk
    recording every transition."""

    def __init__(self, rungs=("full", "mixed", "bucket/32")):
        self.rungs = rungs
        self.at = 0
        self.log = []

    def shed(self):
        if self.at >= len(self.rungs) - 1:
            self.log.append(("shed", None))
            return None
        self.at += 1
        self.log.append(("shed", self.rungs[self.at]))
        return self.rungs[self.at]

    def restore(self):
        if self.at == 0:
            self.log.append(("restore", None))
            return None
        self.at -= 1
        self.log.append(("restore", self.rungs[self.at]))
        return self.rungs[self.at]


def _overload_sched(ladder, **kw):
    pol = _policy(
        max_queue_rows=100_000,
        shed_queue_rows=256, shed_hold_s=0.05, recover_hold_s=0.10, **kw
    )
    return FrontendScheduler(
        pol, on_shed=ladder.shed, on_recover=ladder.restore
    )


def test_shed_fires_after_sustained_growth_only():
    lad = _FakeLadder()
    sched = _overload_sched(lad)

    def offer(now, rows=300):
        sched.submit("a", None, 64, now)  # keep the queue warm
        while sched.coalescer.pending_rows < rows:
            sched.submit("a", None, 64, now)

    # a single deep poll is a burst, not overload: no shed yet
    offer(0.0)
    sched.poll(0.0)
    assert lad.log == []
    # still deep after the hold time: one shed, exactly one
    offer(0.051)
    sched.poll(0.051)
    assert lad.log == [("shed", "mixed")]
    # the hold re-arms: the next shed needs ANOTHER sustained period
    offer(0.06)
    sched.poll(0.06)
    assert lad.log == [("shed", "mixed")]
    offer(0.12)
    sched.poll(0.12)
    assert lad.log == [("shed", "mixed"), ("shed", "bucket/32")]
    assert len(sched.sheds) == 2


def test_recover_restores_after_sustained_drain():
    lad = _FakeLadder()
    sched = _overload_sched(lad)
    for now in (0.0, 0.06):
        while sched.coalescer.pending_rows < 300:
            sched.submit("a", None, 64, now)
        sched.poll(now)
    assert lad.at == 1
    # queue drained (poll pops everything); recovery needs the hold
    sched.poll(0.10)
    sched.poll(0.15)
    assert lad.log[-1] == ("shed", "mixed")
    sched.poll(0.21)  # 0.10 -> 0.21 >= recover_hold_s below recover_rows
    assert lad.log[-1] == ("restore", "full") and lad.at == 0
    # fully recovered: quiet polls restore nothing further
    sched.poll(0.5)
    sched.poll(1.0)
    assert lad.log[-1] == ("restore", "full")
    assert len(sched.recoveries) == 1


def test_dip_below_threshold_resets_the_shed_hold():
    lad = _FakeLadder()
    sched = _overload_sched(lad)
    while sched.coalescer.pending_rows < 300:
        sched.submit("a", None, 64, now=0.0)
    sched.poll(0.0)
    sched.poll(0.03)  # dip: drained queue before the hold elapsed
    while sched.coalescer.pending_rows < 300:
        sched.submit("a", None, 64, now=0.06)
    sched.poll(0.06)  # deep again, but the hold restarted
    assert lad.log == []


def test_slo_policy_validation():
    with pytest.raises(ValueError, match="hysteresis"):
        SLOPolicy(max_batch_rows=64, max_queue_rows=128,
                  shed_queue_rows=100, recover_queue_rows=100)
    with pytest.raises(ValueError, match="never admit"):
        SLOPolicy(max_batch_rows=64, max_queue_rows=32)
    with pytest.raises(ValueError, match="max_tenant_qps"):
        SLOPolicy(max_batch_rows=64, max_queue_rows=64, max_tenant_qps=0.0)
    assert SLOPolicy(
        max_batch_rows=64, max_queue_rows=64, shed_queue_rows=100
    ).recover_rows == 50


def test_hostile_tenant_id_rejected_at_the_edge():
    """A tenant id the metrics exposition cannot carry (quotes,
    backslashes, newlines) is a structured rejection at admission —
    admitted-then-crash-at-retire would take the dispatch pump down for
    every other tenant (review regression)."""
    sched = FrontendScheduler(_policy())
    for bad in ('a"b', "a\\b", "a\nb", "", "x" * 257):
        r = sched.submit(bad, None, 4, now=0.0)
        assert isinstance(r, Rejection) and r.reason == "bad-tenant"
    assert sched.coalescer.pending_rows == 0  # nothing half-admitted
    assert not isinstance(sched.submit("fine-1", None, 4, now=0.0),
                          Rejection)


def test_loadgen_post_counts_connection_errors():
    """_post_query must return a countable failure (not kill the worker
    thread) when the server is unreachable — a load tool that loses its
    failures under load flatters what it exists to expose (review
    regression)."""
    import numpy as np

    from mpi_knn_tpu_torch.frontend.loadgen import _post_query

    status, rows = _post_query(
        "http://127.0.0.1:9",  # discard port: connection refused
        "t", np.zeros((1, 4), np.float32), timeout_s=2.0,
    )
    assert status == 0 and rows == 0


# ---------------------------------------------------------------------------
# parity with the reference: one trace, one fake clock, both packages


def _batch_story(batches):
    return [(b.composition(), b.reason, b.rows, round(b.formed_s, 9),
             round(b.oldest_wait_s, 9), [r.seq for r in b.parts],
             list(_slices(b))) for b in batches]


def _slices(b):
    return [(r.seq, start, stop) for r, start, stop in b.slices()]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rows_cap,wait", [(64, 0.01), (32, 0.0), (1024, 0.002)])
def test_coalescer_parity_with_the_reference(seed, rows_cap, wait):
    """Random admits and polls (flush at the end) through both coalescers:
    the same batches, in the same order, formed at the same instants,
    with the same pending state and wake-up time after every step."""
    rng = random.Random(seed)
    port = Coalescer(max_batch_rows=rows_cap, max_wait_s=wait)
    ref = ref_coalesce.Coalescer(max_batch_rows=rows_cap, max_wait_s=wait)
    now, got, want = 0.0, [], []
    for _ in range(120):
        now += rng.random() * 0.004
        if rng.random() < 0.6:
            tenant = f"t{rng.randrange(5)}"
            rows = rng.choice([1, 3, 8, 16, min(32, rows_cap)])
            port.admit(tenant, None, rows, now)
            ref.admit(tenant, None, rows, now)
        else:
            while (b := port.pop_ready(now)) is not None:
                got.append(b)
            while (b := ref.pop_ready(now)) is not None:
                want.append(b)
        assert port.pending_rows == ref.pending_rows
        assert port.pending_requests == ref.pending_requests
        assert port.next_deadline_s() == ref.next_deadline_s()
        assert port.pending_rows_for("t1") == ref.pending_rows_for("t1")
    while (b := port.pop_ready(now, flush=True)) is not None:
        got.append(b)
    while (b := ref.pop_ready(now, flush=True)) is not None:
        want.append(b)
    assert got and _batch_story(got) == _batch_story(want)
    assert [b.tenants for b in got] == [b.tenants for b in want]


def _trace(seed, n=300):
    """(tenant, rows, now) admissions and poll instants of one seeded
    trace: bursts that cross the shed threshold, lulls that recover, a
    hostile tenant id, oversized and empty requests."""
    rng = random.Random(seed)
    out, now = [], 0.0
    for i in range(n):
        lull = (i // 60) % 2
        now += rng.random() * (0.02 if lull else 0.001)
        r = rng.random() * (1.0 if lull else 0.8)
        if r < 0.65:
            tenant = rng.choice(["a", "b", "c", "d", 'bad"id', ""])
            out.append(("submit", tenant, rng.choice([0, 1, 8, 16, 64, 65]), now))
        elif r < 0.75:
            out.append(("mutation", rng.choice(["a", "b"]),
                        rng.choice([1, 64, 65]), now))
        else:
            out.append(("poll", now, rng.random() < 0.05))
    return out


def _replay(mod_sched, policy_kw, trace):
    """Feed a trace through one package's scheduler; the log of every
    decision, with its fake-clock time."""
    ladder = {"at": 0, "log": []}
    rungs = ("full", "mixed", "bucket/16")

    def shed():
        if ladder["at"] >= len(rungs) - 1:
            return None
        ladder["at"] += 1
        return rungs[ladder["at"]]

    def restore():
        if ladder["at"] == 0:
            return None
        ladder["at"] -= 1
        return rungs[ladder["at"]]

    sched = mod_sched.FrontendScheduler(mod_sched.SLOPolicy(**policy_kw),
                                        on_shed=shed, on_recover=restore)
    log = []
    for ev in trace:
        if ev[0] == "submit":
            _, tenant, rows, now = ev
            out = sched.submit(tenant, None, rows, now)
            log.append(("submit", now, _verdict(out)))
        elif ev[0] == "mutation":
            _, tenant, rows, now = ev
            log.append(("mutation", now,
                        _verdict(sched.admit_mutation(tenant, rows, now))))
        else:
            _, now, flush = ev
            batches = sched.poll(now, flush=flush)
            log.append(("poll", now, [(b.composition(), b.reason, b.rows)
                                      for b in batches]))
    return log, sched


def _verdict(out):
    if out is None:
        return "admitted"
    if hasattr(out, "retry_after_s"):
        return (out.tenant, out.reason, out.status, out.retry_after_s)
    return ("request", out.tenant, out.rows, out.seq)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy_kw", [
    dict(max_batch_rows=64, max_wait_s=0.01, max_queue_rows=128),
    dict(max_batch_rows=64, max_wait_s=0.005, max_queue_rows=256,
         max_tenant_qps=200.0, burst=4),
    dict(max_batch_rows=64, max_wait_s=0.002, max_queue_rows=100_000,
         shed_queue_rows=48, shed_hold_s=0.005, recover_hold_s=0.03),
], ids=["depth", "rate", "overload"])
def test_scheduler_parity_with_the_reference(seed, policy_kw):
    """One trace through both schedulers: identical admissions and
    rejections (tenant, reason, status, retry-after), identical batches,
    identical shed and recover events at identical fake-clock times."""
    trace = _trace(seed)
    got, port = _replay(__import__(
        "mpi_knn_tpu_torch.frontend.scheduler", fromlist=["x"]), policy_kw, trace)
    want, ref = _replay(ref_scheduler, policy_kw, trace)
    assert got == want
    assert port.sheds == ref.sheds and port.recoveries == ref.recoveries
    assert (port.admitted, port.rejected) == (ref.admitted, ref.rejected)
    if "shed_queue_rows" in policy_kw:
        assert port.sheds and port.recoveries  # the walk was exercised
    assert any(v[2] != "admitted" and isinstance(v[2], tuple)
               and v[2][1] == "bad-tenant" for v in got)


@pytest.mark.parametrize("kw,words", [
    (dict(max_batch_rows=0), "max_batch_rows"),
    (dict(max_wait_s=-1.0), "max_wait_s"),
    (dict(max_batch_rows=64, max_queue_rows=32), "never admit"),
    (dict(max_tenant_qps=0.0), "max_tenant_qps"),
    (dict(burst=0), "burst"),
    (dict(shed_queue_rows=0), "shed_queue_rows"),
    (dict(shed_hold_s=-1.0), "hold"),
    (dict(shed_queue_rows=100, recover_queue_rows=100), "hysteresis"),
])
def test_slo_policy_refusals_match_the_reference(kw, words):
    with pytest.raises(ValueError, match=words) as port_err:
        SLOPolicy(**kw)
    with pytest.raises(ValueError) as ref_err:
        ref_scheduler.SLOPolicy(**kw)
    assert str(port_err.value) == str(ref_err.value)
