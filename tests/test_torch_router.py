"""The port's replicated serving tier, held against the JAX package's:
health-gated membership, tenant-affine (rendezvous) spread with
least-queued spill, sequenced mutation fan-out with bounded replay, and
the replicated scaling gate.

- Parity: ``rendezvous_order`` / ``choose_replica`` equal the reference's
  over many tenants and fleets; ``Membership`` and ``MutationLog`` give
  the same decisions (events, states, marks, gaps) over the same seeded
  probe and mutation sequences.
- The reference's own cases (``tests/test_router.py``), run against the
  port: the pure state machines; the wire protocol over the port's
  :class:`ModelReplica` fleets (affinity, fan-out, eviction and rejoin
  with replay, quarantine, kill under load, the >= 2.5x scaling gate,
  connection reuse, multi-target spread); and mutation convergence over
  three real serve stacks of the port on the CPU.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

from mpi_knn_tpu.frontend import router as ref_router
from mpi_knn_tpu_torch.frontend import loadgen
from mpi_knn_tpu_torch.frontend.modelreplica import ModelReplica
from mpi_knn_tpu_torch.frontend.router import (
    JOINING,
    OUT,
    STALE,
    Membership,
    MutationLog,
    Router,
    RouterHTTPServer,
    RouterPolicy,
    choose_replica,
    rendezvous_order,
)
from mpi_knn_tpu_torch.obs.metrics import get_registry, parse_prometheus

# ---------------------------------------------------------------------------
# parity with the reference


@pytest.mark.parametrize("n_replicas", [1, 2, 3, 5, 8])
def test_rendezvous_order_matches_the_reference(n_replicas):
    names = [f"r{i}" for i in range(n_replicas)] + ["replica-x"] * (n_replicas > 4)
    names = sorted(set(names))
    for i in range(500):
        tenant = f"tenant-{i}" if i % 7 else f"t{i}\u00e9"
        assert rendezvous_order(tenant, names) == ref_router.rendezvous_order(
            tenant, names)


@pytest.mark.parametrize("seed", range(4))
def test_choose_replica_matches_the_reference(seed):
    rng = random.Random(seed)
    known = [f"r{i}" for i in range(5)]
    for i in range(300):
        rotation = {n: (rng.choice([0, 3, 8, 100]), rng.randrange(3))
                    for n in known if rng.random() < 0.7}
        bound = rng.choice([0, 4, 50])
        args = (f"tenant-{rng.randrange(40)}", known, rotation)
        assert choose_replica(*args, spill_queue_rows=bound) == \
            ref_router.choose_replica(*args, spill_queue_rows=bound)


def _probe_doc(rng, applied):
    r = rng.random()
    if r < 0.15:
        return None
    if r < 0.25:
        return {"ok": False}
    doc = {"ok": True, "ready": rng.random() < 0.85,
           "applied_seq": max(0, applied + rng.choice([-3, 0, 0, 1, 2])),
           "queue_rows": rng.randrange(64)}
    if rng.random() < 0.8:
        doc["uptime_s"] = round(rng.random() * 50, 3)
    return doc


@pytest.mark.parametrize("seed", range(6))
def test_membership_and_mutation_log_decisions_match_the_reference(seed):
    """The same seeded probe, promotion, quarantine, reload and mutation
    sequence through both packages' state machines: identical events,
    identical replica tables, identical gaps, after every step."""
    rng = random.Random(seed)
    policy_kw = dict(evict_after=rng.choice([1, 2, 3]),
                     rejoin_after=rng.choice([1, 2]),
                     replay_buffer=rng.choice([2, 4, 16]))
    port_m = Membership(RouterPolicy(**policy_kw))
    ref_m = ref_router.Membership(ref_router.RouterPolicy(**policy_kw))
    port_log = MutationLog(policy_kw["replay_buffer"])
    ref_log = ref_router.MutationLog(policy_kw["replay_buffer"])
    names = ["r0", "r1", "r2"]
    for n in names:
        port_m.add(n, f"http://{n}")
        ref_m.add(n, f"http://{n}")
    seen = set()
    for step in range(400):
        now = step * 0.1
        r = rng.random()
        if r < 0.5:
            name = rng.choice(names)
            doc = _probe_doc(rng, ref_m.replicas[name].applied_seq)
            assert port_m.note_probe(name, doc, now) == \
                ref_m.note_probe(name, doc, now)
        elif r < 0.65:
            body = b"%d" % step
            assert port_log.append("/upsert", "t", body) == \
                ref_log.append("/upsert", "t", body)
        elif r < 0.8:
            assert port_m.promotable() == ref_m.promotable()
            for name in ref_m.promotable():
                assert port_m.promote(name, now) == ref_m.promote(name, now)
        elif r < 0.9:
            name = rng.choice(names)
            base = max(ref_m.replicas[name].applied_seq,
                       ref_m.replicas[name].acked_seq)
            gap = ref_log.gap_after(base)
            assert port_log.gap_after(base) == gap
            if gap is None and ref_m.replicas[name].state != "stale":
                assert port_m.quarantine(name, now, min_seq=port_log.min_seq) \
                    == ref_m.quarantine(name, now, min_seq=ref_log.min_seq)
            elif gap:
                ack = gap[-1][0]
                port_m.replicas[name].acked_seq = ack
                ref_m.replicas[name].acked_seq = ack
        else:
            for name in names:
                ok = ref_m.reloadable(name, ref_log.min_seq)
                assert port_m.reloadable(name, port_log.min_seq) == ok
                if ok:
                    assert port_m.note_reload(name, now) == \
                        ref_m.note_reload(name, now)
        assert port_m.posture() == ref_m.posture()
        assert port_m.in_rotation() == ref_m.in_rotation()
        assert (port_log.seq, port_log.min_seq) == (ref_log.seq, ref_log.min_seq)
        seen |= {r["state"] for r in ref_m.posture().values()}
    assert len(seen) >= 3  # the walk visited the states, not one of them


# ---------------------------------------------------------------------------
# pure: rendezvous affinity


def test_rendezvous_order_is_deterministic_and_total():
    names = ["r0", "r1", "r2", "r3"]
    order = rendezvous_order("tenant-7", names)
    assert sorted(order) == sorted(names)
    assert order == rendezvous_order("tenant-7", list(reversed(names)))


def test_rendezvous_churn_remaps_only_the_lost_replicas_tenants():
    """The HRW property the router exists for: removing one replica
    remaps ONLY the tenants whose affine it was — everyone else keeps
    their replica (and its warm coalescing locality) — and they all
    snap back when it returns."""
    names = ["r0", "r1", "r2", "r3"]
    tenants = [f"tenant-{i}" for i in range(64)]
    before = {t: rendezvous_order(t, names)[0] for t in tenants}
    assert len(set(before.values())) == 4  # every replica owns someone
    shrunk = [n for n in names if n != "r2"]
    after = {t: rendezvous_order(t, shrunk)[0] for t in tenants}
    for t in tenants:
        if before[t] == "r2":
            assert after[t] != "r2"
        else:
            assert after[t] == before[t]
    restored = {t: rendezvous_order(t, names)[0] for t in tenants}
    assert restored == before


def test_choose_replica_affine_spill_and_empty_rotation():
    known = ["r0", "r1", "r2"]
    affine = rendezvous_order("t", known)[0]
    others = [n for n in known if n != affine]
    rotation = {n: (0, 0) for n in known}
    # affine, under the bound: no spill
    assert choose_replica("t", known, rotation, spill_queue_rows=4) == (
        affine, False,
    )
    # affine over the depth bound: least-queued spill
    rotation[affine] = (100, 0)
    rotation[others[0]] = (7, 1)
    rotation[others[1]] = (7, 0)
    assert choose_replica("t", known, rotation, spill_queue_rows=4) == (
        others[1], True,  # (queue_rows, inflight, name) tie-break
    )
    # affine out of rotation entirely (evicted): spill — but affinity is
    # computed over KNOWN, so the other tenants' mapping is untouched
    del rotation[affine]
    name, spilled = choose_replica("t", known, rotation,
                                   spill_queue_rows=4)
    assert spilled and name in others
    assert choose_replica("t", known, {}, spill_queue_rows=4) == (
        None, False,
    )


# ---------------------------------------------------------------------------
# pure: membership state machine


def _probe_ok(m, name, now, *, applied=0, ready=True, queue=0):
    return m.note_probe(name, {
        "ok": True, "ready": ready, "applied_seq": applied,
        "queue_rows": queue,
    }, now)


def test_membership_join_evict_rejoin_hysteresis():
    m = Membership(RouterPolicy(evict_after=3, rejoin_after=2))
    m.add("r0", "http://x")
    assert m.replicas["r0"].state == JOINING
    # probation: one ready probe is not enough at rejoin_after=2
    assert _probe_ok(m, "r0", 1.0) == []
    assert m.promotable() == []
    assert _probe_ok(m, "r0", 2.0) == []
    assert m.promotable() == ["r0"]
    ev = m.promote("r0", 2.0)
    assert ev["event"] == "join" and m.in_rotation() == ["r0"]
    # hysteresis: evict_after-1 consecutive failures don't evict, and a
    # ready probe in between resets the streak
    assert m.note_probe("r0", None, 3.0) == []
    assert m.note_probe("r0", {"ok": False}, 4.0) == []
    assert _probe_ok(m, "r0", 5.0) == []
    assert m.in_rotation() == ["r0"]
    assert m.note_probe("r0", None, 6.0) == []
    assert m.note_probe("r0", None, 7.0) == []
    events = m.note_probe("r0", None, 8.0)
    assert [e["event"] for e in events] == ["evict"]
    assert m.replicas["r0"].state == OUT and m.in_rotation() == []
    # recovery re-enters through probation, never straight to IN
    events = _probe_ok(m, "r0", 9.0)
    assert [e["event"] for e in events] == ["recover"]
    assert m.replicas["r0"].state == JOINING
    assert m.promotable() == []
    _probe_ok(m, "r0", 10.0)
    assert m.promotable() == ["r0"]


def test_membership_restart_detection_resets_ack_horizon():
    """A replica whose reported applied_seq went DOWN restarted: every
    router-side acknowledgment was for a life that no longer exists."""
    m = Membership(RouterPolicy())
    m.add("r0")
    _probe_ok(m, "r0", 1.0, applied=7)
    m.replicas["r0"].acked_seq = 9
    events = _probe_ok(m, "r0", 2.0, applied=0)
    assert [e["event"] for e in events] == ["restart-detected"]
    assert m.replicas["r0"].acked_seq == 0
    assert m.replicas["r0"].applied_seq == 0


def test_membership_quarantine_until_coverable_reload():
    m = Membership(RouterPolicy(rejoin_after=1))
    m.add("r0")
    _probe_ok(m, "r0", 1.0)
    m.promote("r0", 1.0)
    ev = m.quarantine("r0", 2.0, min_seq=7)
    assert ev["event"] == "quarantine" and ev["min_buffered_seq"] == 7
    assert m.replicas["r0"].state == STALE
    # still at a baseline the buffer can't cover: not reloadable
    _probe_ok(m, "r0", 3.0, applied=2)
    assert not m.reloadable("r0", 7)
    # cold-reloaded to seq 6: gap [7..] is exactly what is buffered
    _probe_ok(m, "r0", 4.0, applied=6)
    assert m.reloadable("r0", 7)
    ev = m.note_reload("r0", 5.0)
    assert ev["event"] == "reload"
    assert m.replicas["r0"].state == JOINING
    assert m.replicas["r0"].ok_streak == 0  # fresh probation


# ---------------------------------------------------------------------------
# pure: mutation log


def test_mutation_log_sequencing_gap_and_overflow():
    log = MutationLog(cap=3)
    assert log.min_seq == 1 and log.gap_after(0) == []
    for i in range(5):
        assert log.append("/upsert", "t", b"%d" % i) == i + 1
    assert log.seq == 5 and log.min_seq == 3  # 1 and 2 fell off
    assert log.gap_after(5) == []
    assert [m[0] for m in log.gap_after(3)] == [4, 5]
    assert [m[0] for m in log.gap_after(2)] == [3, 4, 5]
    assert log.gap_after(1) is None  # seq 2 is gone: overflow
    assert log.gap_after(0) is None


def test_router_policy_validates():
    with pytest.raises(ValueError):
        RouterPolicy(evict_after=0)
    with pytest.raises(ValueError):
        RouterPolicy(rejoin_after=0)
    with pytest.raises(ValueError):
        RouterPolicy(replay_buffer=0)


# ---------------------------------------------------------------------------
# the wire protocol over ModelReplica fleets


def _wait(pred, timeout_s=10.0, every=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return False


def _counter(name, **labels):
    return get_registry().counter(name, labels=labels or None).value


class _Fleet:
    """n ModelReplicas + a started Router (+ optional HTTP shell)."""

    def __init__(self, n, *, policy=None, http=False, **replica_kw):
        kw = dict(dim=8, k=3)
        kw.update(replica_kw)
        self.replicas = [ModelReplica(**kw).start() for _ in range(n)]
        self.names = [f"r{i}" for i in range(n)]
        self.router = Router(
            {f"r{i}": r.url for i, r in enumerate(self.replicas)},
            policy=policy or RouterPolicy(
                probe_interval_s=0.05, evict_after=2, rejoin_after=1,
            ),
        ).start()
        assert self.router.wait_rotation(n, timeout_s=10)
        self.server = RouterHTTPServer(self.router).start() if http else None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.server is not None:
            self.server.stop()
        self.router.stop()
        for r in self.replicas:
            try:
                r.stop()
            except OSError:
                pass


def _post(url, path, body, headers):
    req = urllib.request.Request(
        url + path, data=body, headers=headers, method="POST"
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def _query_body(dim, rows=2):
    return b"\x00" * (4 * dim * rows)


def test_wire_affinity_is_stable_and_matches_rendezvous():
    """Every tenant's queries land on its rendezvous-first replica, and
    keep landing there (X-Routed-To is the proof on the wire)."""
    with _Fleet(3, http=True) as f:
        for tenant in ("alice", "bob", "carol", "dave"):
            affine = rendezvous_order(tenant, f.names)[0]
            for _ in range(3):
                status, headers, doc = _post(
                    f.server.url, "/query", _query_body(8),
                    {"Content-Type": "application/octet-stream",
                     "X-Tenant": tenant},
                )
                assert status == 200 and doc["rows"] == 2
                assert headers["X-Routed-To"] == affine


def test_wire_mutation_fanout_sequences_all_replicas():
    with _Fleet(3, http=True) as f:
        status, _h, doc = _post(
            f.server.url, "/upsert",
            json.dumps({"ids": [1, 2], "rows": [[0.0] * 8] * 2}).encode(),
            {"Content-Type": "application/json", "X-Tenant": "t1"},
        )
        assert status == 200
        assert doc["seq"] == 1 and doc["failed"] == []
        assert doc["applied"] == ["r0", "r1", "r2"]
        status, _h, doc = _post(
            f.server.url, "/delete",
            json.dumps({"ids": [1]}).encode(),
            {"Content-Type": "application/json", "X-Tenant": "t1"},
        )
        assert status == 200 and doc["seq"] == 2
        for r in f.replicas:
            snap = r.snapshot()
            assert snap["applied_seq"] == 2
            assert [(m[0], m[1]) for m in snap["mutations"]] == [
                (1, "/upsert"), (2, "/delete"),
            ]


def test_wire_malformed_mutation_is_400_not_sequenced():
    with _Fleet(1, http=True) as f:
        for body in (b"not json", b"{}", b"[1,2]"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f.server.url, "/upsert", body,
                      {"Content-Type": "application/json"})
            assert ei.value.code == 400
            ei.value.read()
        assert f.router.log.seq == 0  # nothing malformed got a seq


def test_evict_rejoin_replays_missed_mutations_in_order():
    """The full outage arc: soft-fail one replica out of rotation,
    mutate while it is down, recover it — the router replays exactly
    the missed gap, in seq order, and only then promotes it back."""
    with _Fleet(3, http=True) as f:
        evicts0 = _counter(
            "router_membership_transitions_total", event="evict")
        joins0 = _counter(
            "router_membership_transitions_total", event="join")
        _post(f.server.url, "/upsert",
              json.dumps({"ids": [1], "rows": [[0.0] * 8]}).encode(),
              {"Content-Type": "application/json", "X-Tenant": "a"})
        sick = f.replicas[2]
        sick.fail(True)
        assert _wait(
            lambda: f.router.stats()["rotation"] == ["r0", "r1"]
        )
        assert _counter(
            "router_membership_transitions_total", event="evict"
        ) == evicts0 + 1
        # two mutations while r2 is out: applied to the rotation,
        # recorded for replay
        status, _h, doc = _post(
            f.server.url, "/upsert",
            json.dumps({"ids": [2], "rows": [[1.0] * 8]}).encode(),
            {"Content-Type": "application/json", "X-Tenant": "b"})
        assert status == 200 and doc["applied"] == ["r0", "r1"]
        _post(f.server.url, "/delete",
              json.dumps({"ids": [1]}).encode(),
              {"Content-Type": "application/json", "X-Tenant": "a"})
        assert sick.snapshot()["applied_seq"] == 1
        sick.fail(False)
        assert _wait(
            lambda: f.router.stats()["rotation"] == ["r0", "r1", "r2"]
        )
        # the gap (seqs 2 and 3) was replayed in order before the join
        snap = sick.snapshot()
        assert snap["applied_seq"] == 3
        assert [m[0] for m in snap["mutations"]] == [1, 2, 3]
        assert _counter(
            "router_membership_transitions_total", event="join"
        ) >= joins0 + 1
        assert _counter(
            "router_replayed_mutations_total", replica="r2") >= 2
        # and the healthz posture agrees (on the next probe cycle):
        # everyone converged on seq 3
        assert _wait(lambda: all(
            r["applied_seq"] == 3
            for r in f.router.stats()["replicas"].values()
        ))


def test_replay_overflow_quarantines_until_cold_reload():
    """A replica that slept past the replay buffer cannot be replayed
    forward: it is quarantined (stale) until a cold reload brings its
    baseline back inside the buffer — then it rejoins through replay."""
    policy = RouterPolicy(probe_interval_s=0.05, evict_after=2,
                          rejoin_after=1, replay_buffer=2)
    with _Fleet(2, policy=policy, http=True) as f:
        overflow0 = _counter("router_replay_overflow_total")
        sick = f.replicas[1]
        sick.fail(True)
        assert _wait(lambda: f.router.stats()["rotation"] == ["r0"])
        for i in range(4):  # cap=2: seqs 1 and 2 fall off the buffer
            _post(f.server.url, "/upsert",
                  json.dumps(
                      {"ids": [10 + i], "rows": [[0.0] * 8]}
                  ).encode(),
                  {"Content-Type": "application/json"})
        sick.fail(False)
        assert _wait(
            lambda: f.router.stats()["replicas"]["r1"]["state"] == STALE
        )
        assert f.router.stats()["rotation"] == ["r0"]
        assert _counter("router_replay_overflow_total") == overflow0 + 1
        # cold reload to a coverable baseline (seq 2: gap = buffered
        # seqs 3 and 4) readmits it through normal replay + probation
        sick.cold_reload(applied_seq=2)
        assert _wait(
            lambda: f.router.stats()["rotation"] == ["r0", "r1"]
        )
        snap = sick.snapshot()
        assert snap["applied_seq"] == 4
        assert [m[0] for m in snap["mutations"]] == [3, 4]


def test_router_healthz_mirrors_index_facts_and_metrics_reparse():
    with _Fleet(2, http=True) as f:
        doc = loadgen.probe_server(f.server.url)
        assert doc["ok"] is True and doc["role"] == "router"
        assert doc["dim"] == 8 and doc["k"] == 3  # mirrored from replicas
        assert doc["rotation"] == ["r0", "r1"]
        assert doc["seq"] == 0 and doc["min_buffered_seq"] == 1
        assert set(doc["replicas"]) == {"r0", "r1"}
        _post(f.server.url, "/query", _query_body(8),
              {"Content-Type": "application/octet-stream",
               "X-Tenant": "m"})
        samples = parse_prometheus(loadgen.fetch_metrics(f.server.url))
        assert samples["router_rotation_size"] == 2
        assert any(
            k.startswith("router_requests_total") for k in samples
        )


def test_kill_one_replica_under_load_zero_unstructured_errors():
    """The rolling-restart drill's core: SIGKILL-equivalent one
    of three replicas mid-load — in-flight and pooled requests die with
    transport errors, the router retries them on a live replica, the
    rotation heals by eviction, and the client sees ZERO failures. Then
    a replacement on the same address rejoins and converges."""
    with _Fleet(3, http=True, service_s=0.002, lanes=2) as f:
        _post(f.server.url, "/upsert",
              json.dumps({"ids": [1], "rows": [[0.0] * 8]}).encode(),
              {"Content-Type": "application/json"})
        victim = f.replicas[0]
        addr = victim._httpd.server_address[:2]
        killer = threading.Timer(0.4, victim.kill)
        killer.start()
        rep = loadgen.run_http(
            f.server.url, tenants=6, qps=40.0, n_requests=48, rows=2,
            timeout_s=30,
        )
        killer.join()
        assert rep["errors"] == 0 and rep["rejected"] == 0
        assert set(rep["by_status"]) == {"200"}
        assert sum(rep["per_tenant"].values()) == 6 * 48
        assert _wait(
            lambda: f.router.stats()["rotation"] == ["r1", "r2"]
        )
        # mutate while the slot is dead, then resurrect it on the SAME
        # address (the static-fleet analogue of a supervised restart)
        _post(f.server.url, "/upsert",
              json.dumps({"ids": [2], "rows": [[0.0] * 8]}).encode(),
              {"Content-Type": "application/json"})
        reborn = ModelReplica(dim=8, k=3, host=addr[0],
                              port=addr[1]).start()
        f.replicas[0] = reborn
        assert _wait(
            lambda: f.router.stats()["rotation"] == ["r0", "r1", "r2"]
        )
        # restart detected (applied_seq went 1 -> 0), full gap replayed
        assert reborn.snapshot()["applied_seq"] == f.router.log.seq
        assert _wait(lambda: all(
            r["applied_seq"] == f.router.log.seq
            for r in f.router.stats()["replicas"].values()
        ))


# ---------------------------------------------------------------------------
# acceptance: replicated scaling, and the loadgen transport regression


def _scaling_leg(n):
    reps = [
        ModelReplica(dim=8, k=3, service_s=0.01, lanes=1).start()
        for _ in range(n)
    ]
    router = Router(
        {f"r{i}": r.url for i, r in enumerate(reps)},
        policy=RouterPolicy(probe_interval_s=0.05, rejoin_after=1,
                            spill_queue_rows=2),
    ).start()
    assert router.wait_rotation(n, timeout_s=10)
    srv = RouterHTTPServer(router).start()
    try:
        return loadgen.run_http(
            srv.url, tenants=12, qps=330.0 / 12, n_requests=25, rows=4,
            timeout_s=30, connections=6,
        )
    finally:
        srv.stop()
        router.stop()
        for r in reps:
            r.stop()


def test_acceptance_three_replicas_scale_2_5x_at_p99_bound():
    """The reference's scaling gate: replicas of a FIXED per-replica
    capacity (100 req/s: one 10ms lane — modeled service, so a host of
    few cores can genuinely run three of them concurrently), offered
    330 req/s. One replica saturates at its capacity; three behind the
    router must sustain >= 2.5x that AND meet a p99 bound the single
    replica blows by an order of magnitude."""
    P99_BOUND_MS = 1000.0
    one = _scaling_leg(1)
    three = _scaling_leg(3)
    assert one["errors"] == 0 and three["errors"] == 0
    assert sum(three["per_tenant"].values()) == 12 * 25
    ratio = three["achieved_rps"] / one["achieved_rps"]
    assert ratio >= 2.5, (
        f"3 replicas {three['achieved_rps']} req/s vs 1 replica "
        f"{one['achieved_rps']} req/s — only {ratio:.2f}x"
    )
    assert three["p99_ms"] <= P99_BOUND_MS, (
        f"3-replica p99 {three['p99_ms']}ms over {P99_BOUND_MS}ms"
    )
    assert one["p99_ms"] > P99_BOUND_MS  # the load is real overload for 1


def test_loadgen_connection_reuse_beats_per_connect():
    """The load generator's transport: at an offered load that
    saturates both transports, the keep-alive pool must sustain at
    least the per-connect throughput (in practice ~5x: no TCP connect
    + thread spawn per request)."""
    rep = ModelReplica(dim=8, k=3, service_s=0.0, lanes=0).start()
    try:
        reuse = loadgen.run_http(
            rep.url, tenants=4, qps=1500.0, n_requests=150, rows=2,
            timeout_s=30, connect="reuse",
        )
        per = loadgen.run_http(
            rep.url, tenants=4, qps=1500.0, n_requests=150, rows=2,
            timeout_s=30, connect="per-request",
        )
    finally:
        rep.stop()
    assert reuse["errors"] == 0 and per["errors"] == 0
    assert reuse["connect"] == "reuse" and per["connect"] == "per-request"
    assert reuse["achieved_rps"] >= per["achieved_rps"], (
        f"reuse {reuse['achieved_rps']} req/s < per-connect "
        f"{per['achieved_rps']} req/s"
    )


def test_loadgen_targets_spread_tenants_round_robin():
    reps = [
        ModelReplica(dim=8, k=3).start() for _ in range(2)
    ]
    try:
        rep = loadgen.run_http(
            targets=[r.url for r in reps], tenants=4, qps=200.0,
            n_requests=10, rows=2, timeout_s=30,
        )
        assert rep["errors"] == 0 and rep["targets"] == 2
        assert sum(rep["per_tenant"].values()) == 40
        # tenants 0,2 -> replica 0; tenants 1,3 -> replica 1
        assert reps[0].snapshot()["queries"] == 20
        assert reps[1].snapshot()["queries"] == 20
    finally:
        for r in reps:
            r.stop()


# ---------------------------------------------------------------------------
# convergence over real serve stacks of the port


def test_mutation_convergence_across_real_replicas(tmp_path):
    """Three real serve stacks of the port (on the CPU) over identical
    index builds, churned
    through the router while one is down and rebooted cold from the
    original artifact state: after replay, every replica reports the
    router's seq and answers the same queries IDENTICALLY — and the
    deleted ids are gone everywhere."""
    import numpy as np

    from mpi_knn_tpu_torch.config import KNNConfig
    from mpi_knn_tpu_torch.frontend import (
        Frontend,
        FrontendHTTPServer,
        SLOPolicy,
    )
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy
    from mpi_knn_tpu_torch.serve import ServeSession

    rng = np.random.default_rng(0)
    d, nc = 16, 8
    cents = rng.standard_normal((nc, d)).astype(np.float32) * 5.0
    X = (cents[rng.integers(0, nc, 256)]
         + rng.standard_normal((256, d))).astype(np.float32)
    cfg = KNNConfig(k=5, partitions=nc, nprobe=4, query_tile=32,
                    query_bucket=32, mutation_bucket=32,
                    dispatch_depth=1, kmeans_iters=8,
                    bucket_headroom=0.5)

    def stack(port=0):
        fe = Frontend(
            ServeSession(build_ivf_index(X, cfg, device="cpu"),
                         resilience=ResiliencePolicy(), device="cpu"),
            SLOPolicy(max_batch_rows=32, max_wait_s=0.002,
                      max_queue_rows=65536),
        ).start()
        return fe, FrontendHTTPServer(fe, port=port).start()

    stacks = [stack() for _ in range(3)]
    router = Router(
        {f"r{i}": srv.url for i, (_fe, srv) in enumerate(stacks)},
        policy=RouterPolicy(probe_interval_s=0.05, evict_after=2,
                            rejoin_after=1),
    ).start()
    server = RouterHTTPServer(router).start()
    try:
        assert router.wait_rotation(3, timeout_s=30)

        def upsert(ids, rows, tenant="default"):
            return _post(
                server.url, "/upsert",
                json.dumps(
                    {"ids": ids, "rows": rows.tolist()}
                ).encode(),
                {"Content-Type": "application/json",
                 "X-Tenant": tenant},
            )

        churn_rows = (cents[rng.integers(0, nc, 6)]
                      + rng.standard_normal((6, d))).astype(np.float32)
        status, _h, doc = upsert([5000, 5001, 5002], churn_rows[:3])
        assert status == 200 and doc["applied"] == ["r0", "r1", "r2"]

        # take r2 down hard (both layers), churn while it is out
        _fe2, srv2 = stacks[2]
        port2 = srv2.address[1]
        srv2.stop()
        _fe2.stop()
        assert _wait(
            lambda: router.stats()["rotation"] == ["r0", "r1"],
            timeout_s=15,
        )
        # r2 is out of rotation: the fan-out no longer targets it at
        # all — it is lagging, to be replayed forward on rejoin
        status, _h, doc = upsert([6000, 6001, 6002], churn_rows[3:])
        assert status == 200
        assert doc["applied"] == ["r0", "r1"] and doc["failed"] == []
        status, _h, doc = _post(
            server.url, "/delete",
            json.dumps({"ids": [5000, 6000]}).encode(),
            {"Content-Type": "application/json"},
        )
        assert status == 200 and router.log.seq == 3

        # cold reboot on the same address from the ORIGINAL artifact
        # state (applied_seq=0): restart detection + full replay
        stacks[2] = stack(port=port2)
        assert _wait(
            lambda: router.stats()["rotation"] == ["r0", "r1", "r2"],
            timeout_s=30,
        )
        assert _wait(lambda: all(
            r["applied_seq"] == 3
            for r in router.stats()["replicas"].values()
        ), timeout_s=15)

        # post-churn queries answered IDENTICALLY by every replica
        q = np.ascontiguousarray(
            cents[rng.integers(0, nc, 8)]
            + rng.standard_normal((8, d)), dtype="<f4",
        )
        answers = []
        for _fe, srv in stacks:
            status, _h, doc = _post(
                srv.url, "/query", q.tobytes(),
                {"Content-Type": "application/octet-stream",
                 "X-Tenant": "readback"},
            )
            assert status == 200
            answers.append((doc["ids"], doc["dists"]))
        assert answers[0] == answers[1] == answers[2]
        live = {i for row in answers[0][0] for i in row}
        assert not live & {5000, 6000}  # deleted ids never come back
    finally:
        server.stop()
        router.stop()
        for fe, srv in stacks:
            try:
                srv.stop()
            except OSError:
                pass
            fe.stop()


# ---------------------------------------------------------------------------
# review hardening: gapless marks, life markers, lock posture, pool hygiene


def test_membership_restart_detected_by_uptime_drop():
    """A restart restored from an artifact current at the SAME probed
    mark shows no seq regression; only the uptime LIFE marker dropping
    reveals the new life (and resets the ack horizon legs had built)."""
    m = Membership(RouterPolicy())
    m.add("r0")
    m.note_probe("r0", {"ok": True, "ready": True, "applied_seq": 3,
                        "uptime_s": 12.5}, 1.0)
    m.replicas["r0"].acked_seq = 9  # fan-out legs acked between probes
    events = m.note_probe("r0", {"ok": True, "ready": True,
                                 "applied_seq": 3, "uptime_s": 0.2}, 2.0)
    assert [e["event"] for e in events] == ["restart-detected"]
    assert m.replicas["r0"].acked_seq == 3
    assert m.replicas["r0"].applied_seq == 3


def test_membership_stale_probe_doc_is_not_a_restart():
    """A probed /healthz rendered BEFORE recent fan-out legs landed
    carries an applied_seq below the leg-updated mark. Same life (uptime
    grew), so no restart event — and the mark never regresses."""
    m = Membership(RouterPolicy())
    m.add("r0")
    m.note_probe("r0", {"ok": True, "ready": True, "applied_seq": 2,
                        "uptime_s": 5.0}, 1.0)
    r = m.replicas["r0"]
    r.applied_seq = 6  # _note_leg advanced the mark between probes
    r.acked_seq = 6
    events = m.note_probe("r0", {"ok": True, "ready": True,
                                 "applied_seq": 4, "uptime_s": 5.5}, 2.0)
    assert events == []
    assert r.applied_seq == 6 and r.acked_seq == 6


def test_modelreplica_refuses_gapped_seq():
    """The gapless-mark contract, driven directly: a seq past
    applied+1 is a 409-shaped refusal that applies NOTHING, replays of
    the hole land in order, and at-or-below seqs stay duplicates."""
    rep = ModelReplica(dim=8, k=3)  # never started: pure state checks
    try:
        out = rep.apply_mutation("/upsert", "t", [1], 1)
        assert out["applied_seq"] == 1
        out = rep.apply_mutation("/upsert", "t", [2], 3)
        assert out == {"error": "seq-gap", "status": 409,
                       "applied_seq": 1}
        snap = rep.snapshot()
        assert snap["applied_seq"] == 1 and len(snap["mutations"]) == 1
        assert rep.apply_mutation("/upsert", "t", [2], 2)[
            "applied_seq"] == 2
        assert rep.apply_mutation("/upsert", "t", [2], 2)["duplicate"]
    finally:
        rep._httpd.server_close()


def test_transient_fanout_failure_never_gaps_a_replica():
    """One replica's fan-out leg fails transiently while it stays in
    rotation: later live legs must 409 against its gapless mark (never
    apply over the hole and silently lose the missed mutation), and the
    probe loop's replay closes the hole IN ORDER."""
    policy = RouterPolicy(probe_interval_s=30.0, evict_after=3,
                          rejoin_after=1)  # one startup probe cycle,
    # then no replay until the test invokes it explicitly
    body = json.dumps({"ids": [1]}).encode()
    with _Fleet(2, policy=policy) as f:
        lagger = f.replicas[1]
        lagger.drop_mutations(True)
        status, doc = f.router.mutate("/upsert", "t", body)
        assert status == 200
        assert doc["applied"] == ["r0"] and doc["failed"] == ["r1"]
        lagger.drop_mutations(False)
        # the leg for seq 2 reaches a healthy replica still missing
        # seq 1: the gapless mark refuses it — lagging, never gapped
        status, doc = f.router.mutate("/upsert", "t", body)
        assert status == 200
        assert doc["applied"] == ["r0"] and doc["failed"] == ["r1"]
        snap = lagger.snapshot()
        assert snap["applied_seq"] == 0 and snap["mutations"] == []
        # the health surface reads the published posture, not _mutlock
        assert f.router.stats()["seq"] == 2
        # one probe cycle replays the hole forward, in order
        f.router._probe_once()
        snap = lagger.snapshot()
        assert snap["applied_seq"] == 2
        assert [m[0] for m in snap["mutations"]] == [1, 2]
        assert f.replicas[0].snapshot()["applied_seq"] == 2


def test_pool_pruning_and_stop_close_stranded_connections():
    """A supervised restart publishes a new port: pooled keep-alive
    sockets under the old url must be closed by the probe cycle's
    prune, and Router.stop() must close whatever remains."""
    class _Conn:
        def __init__(self):
            self.closed = False

        def close(self):
            self.closed = True

    router = Router({"r0": "http://127.0.0.1:9/"})  # never started
    old, probe_old, cur = _Conn(), _Conn(), _Conn()
    router._pools = {
        ("r0", "http://old:1"): [old],
        ("probe", "http://old:1"): [probe_old],
        ("r0", "http://cur:1"): [cur],
    }
    router._prune_pools({"r0": "http://cur:1"})
    assert old.closed and probe_old.closed and not cur.closed
    assert list(router._pools) == [("r0", "http://cur:1")]
    router.stop()  # never started: must not raise, must drain pools
    assert cur.closed and router._pools == {}


# ---------------------------------------------------------------------------
# supervision: run_supervised's stop and spawn hooks, and a spawned fleet of
# the port's own serve children on the CPU


def test_run_supervised_stop_event_and_on_spawn():
    """``on_spawn`` sees the child's pid right after the spawn; a set
    ``stop_event`` ends the supervision and kills the child, the result a
    "timeout" with the reason "stop requested"."""
    import os
    import sys

    from mpi_knn_tpu_torch.resilience.worker import run_supervised

    pids, stop = [], threading.Event()
    out = {}
    th = threading.Thread(target=lambda: out.update(res=run_supervised(
        [sys.executable, "-c", "import time; time.sleep(120)"],
        beat_timeout_s=None, stop_event=stop, on_spawn=pids.append)),
        daemon=True)
    th.start()
    assert _wait(lambda: bool(pids), timeout_s=20)
    os.kill(pids[0], 0)  # alive
    stop.set()
    th.join(20)
    assert not th.is_alive()
    res = out["res"]
    assert res.status == "timeout" and res.reason == "stop requested"
    with pytest.raises(ProcessLookupError):
        os.kill(pids[0], 0)


def test_spawned_serve_children_rejoin_after_sigkill(tmp_path):
    """``router --spawn``'s supervisor over real ``python -m
    mpi_knn_tpu_torch serve --platform cpu`` children: both join the
    rotation, a SIGKILLed child is restarted on a new port and rejoins
    with its ``applied_seq`` caught up by replay (a mutation the pallas
    layout refuses with a 400 consumes its seq all the same)."""
    import os
    import signal

    from mpi_knn_tpu_torch.frontend.router import ReplicaSupervisor

    serve_args = ["--data", "synthetic:512x16c4", "--k", "4", "--backend",
                  "pallas", "--bucket", "32", "--corpus-tile", "128",
                  "--platform", "cpu"]
    sup = ReplicaSupervisor(2, serve_args, workdir=str(tmp_path)).start()
    router = Router(supervisor=sup, policy=RouterPolicy(
        probe_interval_s=0.1, evict_after=2, rejoin_after=1)).start()
    srv = RouterHTTPServer(router).start()
    try:
        assert router.wait_rotation(2, timeout_s=120)
        body = _query_body(16, rows=3)
        hdr = {"Content-Type": "application/octet-stream", "X-Tenant": "a"}
        status, _h, first = _post(srv.url, "/query", body, hdr)
        assert status == 200 and first["rows"] == 3
        victim = rendezvous_order("a", sup.names())[0]
        pid, url = sup.pid(victim), sup.url(victim)
        os.kill(pid, signal.SIGKILL)
        status, _h, doc = _post(srv.url, "/query", body, hdr)
        assert status == 200 and doc["ids"] == first["ids"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.url, "/upsert",
                  json.dumps({"ids": [1], "rows": [[0.0] * 16]}).encode(),
                  {"Content-Type": "application/json"})
        assert ei.value.code == 400  # the pallas layout refuses mutation
        ei.value.read()
        assert _wait(lambda: sup.pid(victim) not in (None, pid)
                     and sup.url(victim) not in (None, url), timeout_s=60)
        assert _wait(lambda: router.stats()["rotation"] == sorted(sup.names())
                     and all(r["applied_seq"] == router.log.seq == 1
                             for r in router.stats()["replicas"].values()),
                     timeout_s=120)
        status, _h, doc = _post(srv.url, "/query", body, hdr)
        assert status == 200 and doc["ids"] == first["ids"]
        assert _counter("router_replica_restarts_total", replica=victim) >= 1
    finally:
        srv.stop()
        router.stop()
        sup.stop(timeout_s=30)
    assert all(sup.pid(n) is None for n in sup.names())
