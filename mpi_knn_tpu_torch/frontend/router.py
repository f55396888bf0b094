"""The replicated serving tier (the JAX package's ``frontend/router.py``):
a torch-free router fronting N ``python -m mpi_knn_tpu_torch serve``
replicas of one index.

Layering follows the front end's testability contract: everything with
behavior worth asserting is a pure state machine here:

- :class:`Membership`: health-gated rotation. A replica joins only when
  its ``/healthz`` says ready, leaves after ``evict_after`` consecutive
  probe failures, and re-enters through ``joining`` (probation) after
  ``rejoin_after`` consecutive ready probes. Every transition is returned
  as an event dict for the impure shell to count and stamp.
- :class:`MutationLog`: the per-index mutation history. A monotone
  sequence number per ``POST /upsert`` / ``/delete``, a BOUNDED replay
  buffer, and the gap computation that decides whether an out-of-date
  replica can be replayed forward or has diverged past the buffer
  (overflow: quarantine until cold-reloaded to a coverable baseline).
- :func:`rendezvous_order` / :func:`choose_replica`: tenant-affine
  spread. Rendezvous (HRW) hashing, so membership churn remaps ONLY the
  affected tenants' keys and each replica keeps its tenants' coalescing
  locality; least-queued spill when the affine replica is out of
  rotation or over the depth bound read from ``/healthz``.

The impure shell is as thin as it can be made:

- :class:`Router`: threads and sockets. A prober thread polls each
  replica's ``/healthz`` on the router's OWN clock (replica clocks are
  never trusted, and a wedged replica must not stall the rotation
  decision), fans mutations out to every in-rotation replica stamped
  with ``X-Mutation-Seq``, and replays buffered gaps to joining or
  lagging replicas in order. Lock order is ``_mutlock`` -> ``_lock``
  (strict): the mutation lock is held across fan-out/replay I/O (it is
  the ordering authority), while the membership lock only covers routing
  decisions and state, so queries and ``/healthz`` (which reads the log's
  posture from a snapshot published under ``_lock``) never wait on
  mutation I/O.
- :class:`RouterHTTPServer`: the stdlib ``ThreadingHTTPServer`` shell.
  ``POST /query`` proxies to the chosen replica (structured 503 when the
  rotation is empty, one retry on a different replica when the transport
  fails mid-flight: queries are idempotent), ``POST /upsert`` /
  ``/delete`` sequence and fan out, ``GET /healthz`` the router posture,
  ``GET /metrics`` the obs exposition.
- :class:`ReplicaSupervisor`: ``router --spawn N``. Each replica slot is
  one thread looping ``resilience.worker.run_supervised`` over a
  ``python -m mpi_knn_tpu_torch serve`` child with a SHARED
  ``--cache-dir`` (the kernel libraries nvcc built once load from it:
  second and later replicas build none) and a per-slot ``--ready-file``
  that doubles as discovery: children bind ``--port 0`` and publish their
  URL atomically; a restarted child publishes a NEW port and the prober
  picks it up on its next cycle. On one card every child is a process of
  its own with its own CUDA context and its own copy of the corpus.

Replica-side contract (``frontend/server.py``): mutations carrying
``X-Mutation-Seq`` advance an ``applied_seq`` high-water mark exposed in
``/healthz``; a seq at or below the mark is a replayed duplicate,
acknowledged and never re-applied, so replay may overlap live fan-out.
The mark is GAPLESS: a replica refuses a seq beyond ``applied_seq + 1``
with 409 (outside the deterministic set, so the router never acks it),
because applying over a hole would silently lose the missed mutation:
the router's in-order replay is the only path that advances a lagging
replica. Deterministic refusals (400/507) consume their seq exactly as an
apply would (a replay could only repeat them; a position that did not
advance would wedge the stream on 409 forever).

No torch import anywhere in this module: the router is exactly the layer
that must run in a process that never touches a card.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import http.client
import json
import os
import threading
import time
import urllib.parse

from mpi_knn_tpu_torch.obs import metrics as obs_metrics
from mpi_knn_tpu_torch.obs import spans as obs_spans

SEQ_HEADER = "X-Mutation-Seq"
TENANT_HEADER = "X-Tenant"
DEFAULT_TENANT = "default"

# membership states
JOINING = "joining"  # known, probation: not yet (or not yet re-) promoted
IN = "in"  # in rotation
OUT = "out"  # evicted on probe failures, awaiting recovery
STALE = "stale"  # mutation gap fell off the replay buffer: quarantined


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """The router's knobs — all times on the router's clock."""

    probe_interval_s: float = 0.5
    probe_timeout_s: float = 5.0
    # consecutive probe FAILURES before an in-rotation replica is evicted
    # (hysteresis: one dropped poll must not flap the rotation)
    evict_after: int = 3
    # consecutive READY probes before a joining replica is promoted
    rejoin_after: int = 2
    # spill when the affine replica's /healthz queue_rows exceeds this
    spill_queue_rows: int = 4096
    # bounded mutation replay buffer (entries, not bytes): the outage
    # window a replica may sleep through and still be replayed forward
    replay_buffer: int = 4096
    request_timeout_s: float = 30.0
    # per fan-out/replay leg: deliberately much shorter than the query
    # timeout — a failed leg is replayed by the probe loop anyway, and
    # the leg runs under the mutation lock, so one wedged replica must
    # bound how long it can stall every other mutation
    fanout_timeout_s: float = 5.0

    def __post_init__(self):
        if self.evict_after < 1 or self.rejoin_after < 1:
            raise ValueError("evict_after and rejoin_after must be >= 1")
        if self.replay_buffer < 1:
            raise ValueError("replay_buffer must be >= 1")


def rendezvous_order(tenant: str, names) -> list[str]:
    """Replica names by descending HRW score for ``tenant``: the first
    IS the tenant's affine replica; churn anywhere else in the list
    never changes it (the minimal-remap property a modulo hash lacks)."""
    def score(name: str) -> int:
        h = hashlib.sha256(f"{tenant}|{name}".encode()).digest()
        return int.from_bytes(h[:8], "big")

    return sorted(names, key=lambda n: (-score(n), n))


def choose_replica(tenant: str, known, rotation: dict,
                   *, spill_queue_rows: int) -> tuple:
    """(name, spilled) — the affine replica when it is in rotation and
    under the depth bound, else the least-queued in-rotation replica
    (spill). ``rotation`` maps name → (queue_rows, inflight); ``known``
    is EVERY known replica, in or out — affinity is computed over the
    full set so an eviction only remaps the evicted replica's tenants,
    and they snap back on rejoin. (None, False) on empty rotation."""
    if not rotation:
        return None, False
    affine = rendezvous_order(tenant, known)[0]
    depth = rotation.get(affine)
    if depth is not None and depth[0] <= spill_queue_rows:
        return affine, False
    pick = min(sorted(rotation), key=lambda n: (*rotation[n], n))
    return pick, True


@dataclasses.dataclass
class ReplicaState:
    """One replica as the router last saw it (mutated only under the
    router's membership lock — :class:`Membership` is serialized)."""

    name: str
    url: str | None = None
    state: str = JOINING
    ok_streak: int = 0
    fail_streak: int = 0
    ready: bool = False
    # the replica's own high-water mark — from the last probe, advanced
    # between probes by each 200 fan-out/replay leg's response (a
    # restart in the probe gap must not be compared against a mark
    # staler than the legs the router already saw land)
    applied_seq: int = 0
    # the replica's last reported /healthz uptime_s: the LIFE marker.
    # Within one life both uptime and applied_seq are monotone; an
    # uptime that drops is a restart even when the new life's baseline
    # happens to equal the last mark
    uptime_s: float | None = None
    # the router-side acknowledgment horizon: the highest seq this
    # replica gave a DETERMINISTIC response for (2xx, or a 4xx/507 that
    # a replay could only repeat) — transient failures don't advance it
    acked_seq: int = 0
    queue_rows: int = 0
    last_probe_s: float | None = None
    doc: dict | None = None


class Membership:
    """The health-gated rotation state machine — pure: probes come in as
    (name, healthz-doc-or-None, now) observations, transitions come out
    as event dicts. Serialized by the router's membership lock."""

    def __init__(self, policy: RouterPolicy):
        self.policy = policy
        self.replicas: dict[str, ReplicaState] = {}

    def add(self, name: str, url: str | None = None) -> None:
        if name in self.replicas:
            raise ValueError(f"duplicate replica {name!r}")
        self.replicas[name] = ReplicaState(name=name, url=url)

    def set_url(self, name: str, url: str | None) -> None:
        self.replicas[name].url = url

    def in_rotation(self) -> list[str]:
        return sorted(
            n for n, r in self.replicas.items() if r.state == IN
        )

    def _event(self, event: str, r: ReplicaState, now: float,
               **extra) -> dict:
        return {"event": event, "replica": r.name, "state": r.state,
                "now": now, **extra}

    def note_probe(self, name: str, doc: dict | None,
                   now: float) -> list[dict]:
        """Fold one probe observation in. ``doc`` is the parsed
        ``/healthz`` body, or None for any transport/HTTP failure —
        the two are deliberately indistinct: a replica that cannot
        answer its health check is out, whatever the reason."""
        r = self.replicas[name]
        r.last_probe_s = now
        events: list[dict] = []
        if doc is None or not doc.get("ok", False):
            r.ok_streak = 0
            r.fail_streak += 1
            r.ready = False
            if r.state == IN and r.fail_streak >= self.policy.evict_after:
                r.state = OUT
                events.append(self._event(
                    "evict", r, now, fails=r.fail_streak
                ))
            return events
        applied = int(doc.get("applied_seq", 0))
        up = doc.get("uptime_s")
        up = float(up) if up is not None else None
        # restart detection: the uptime LIFE marker is authoritative
        # when both sides report it — a probed doc that raced a fan-out
        # leg can carry an applied_seq below the leg-updated mark with
        # no restart, and a restart restored to the last mark shows no
        # seq regression at all. Without uptime data (a minimal
        # /healthz), a dropping applied_seq is the only signal.
        if up is not None and r.uptime_s is not None:
            restarted = up < r.uptime_s
        else:
            restarted = applied < r.applied_seq
        if restarted:
            # every router-side acknowledgment was for a life that no
            # longer exists: resynchronize both marks to what the new
            # life reports, so the replay planner sees the real gap
            r.acked_seq = applied
            r.applied_seq = applied
            events.append(self._event(
                "restart-detected", r, now, applied_seq=applied
            ))
        else:
            # same life: the mark never regresses (the probed doc may
            # trail mutation legs acknowledged since it was rendered)
            r.applied_seq = max(r.applied_seq, applied)
        r.uptime_s = up
        r.fail_streak = 0
        r.queue_rows = int(doc.get("queue_rows", 0))
        r.ready = bool(doc.get("ready", False))
        r.doc = doc
        r.ok_streak = r.ok_streak + 1 if r.ready else 0
        if r.state == OUT and r.ready:
            r.state = JOINING
            events.append(self._event("recover", r, now))
        return events

    def promotable(self) -> list[str]:
        """Joining replicas past probation — the shell promotes each one
        only after its mutation gap has been replayed."""
        return sorted(
            n for n, r in self.replicas.items()
            if r.state == JOINING
            and r.ok_streak >= self.policy.rejoin_after
        )

    def promote(self, name: str, now: float) -> dict:
        r = self.replicas[name]
        r.state = IN
        return self._event("join", r, now, applied_seq=r.applied_seq)

    def quarantine(self, name: str, now: float, *,
                   min_seq: int) -> dict:
        """The replica's gap fell off the replay buffer: it cannot be
        replayed forward and must cold-reload to a baseline at or past
        ``min_seq - 1`` before it is considered again."""
        r = self.replicas[name]
        r.state = STALE
        return self._event(
            "quarantine", r, now,
            applied_seq=r.applied_seq, min_buffered_seq=min_seq,
        )

    def reloadable(self, name: str, min_seq: int) -> bool:
        """A stale replica whose reported baseline became coverable
        again (cold-reloaded from a refreshed artifact)."""
        r = self.replicas[name]
        return (
            r.state == STALE and r.ready
            and max(r.applied_seq, r.acked_seq) >= min_seq - 1
        )

    def note_reload(self, name: str, now: float) -> dict:
        r = self.replicas[name]
        r.state = JOINING
        r.ok_streak = 0  # fresh probation after the reload
        return self._event("reload", r, now, applied_seq=r.applied_seq)

    def posture(self) -> dict:
        """The /healthz replica table (plain data, no I/O)."""
        return {
            name: {
                "url": r.url,
                "state": r.state,
                "ready": r.ready,
                "applied_seq": r.applied_seq,
                "acked_seq": r.acked_seq,
                "queue_rows": r.queue_rows,
                "ok_streak": r.ok_streak,
                "fail_streak": r.fail_streak,
            }
            for name, r in sorted(self.replicas.items())
        }


class MutationLog:
    """Sequenced, bounded mutation history. The router is the ordering
    authority: every mutation gets the next seq here, and replicas apply
    strictly by seq (duplicates suppressed replica-side). Bounded: the
    buffer covers a bounded outage window, not unbounded divergence —
    ``gap_after`` returns None when a baseline fell off the left edge.
    Serialized by the router's mutation lock."""

    def __init__(self, cap: int):
        self.cap = cap
        self.seq = 0  # last assigned
        self._buf: collections.deque = collections.deque()

    @property
    def min_seq(self) -> int:
        """Lowest buffered seq (``seq + 1`` when empty — an empty log
        covers exactly the baselines that need nothing replayed)."""
        return self._buf[0][0] if self._buf else self.seq + 1

    def append(self, path: str, tenant: str, body: bytes) -> int:
        self.seq += 1
        self._buf.append((self.seq, path, tenant, body))
        while len(self._buf) > self.cap:
            self._buf.popleft()
        return self.seq

    def gap_after(self, applied_seq: int) -> list | None:
        """The (seq, path, tenant, body) entries a replica at
        ``applied_seq`` is missing, in order — or None when the gap is
        no longer fully buffered (overflow)."""
        if applied_seq >= self.seq:
            return []
        if applied_seq + 1 < self.min_seq:
            return None
        return [m for m in self._buf if m[0] > applied_seq]


# ---------------------------------------------------------------------------
# impure shell

# replica responses a replay could only repeat: advancing the ack
# horizon past them keeps the protocol live (a malformed or
# headroom-overflowing mutation must not wedge replay forever); 429 and
# 5xx are transient — the next replay cycle retries them — and 409 is
# the replica's seq-gap refusal (it has not seen seq - 1 yet): the leg
# stays unacked so the probe loop replays the hole forward in order
_DETERMINISTIC = frozenset({200, 400, 404, 507})


class Router:
    """Bind a :class:`Membership` + :class:`MutationLog` to real probes,
    proxying, and fan-out. ``replicas`` maps name → base URL for a
    static fleet; pass ``supervisor`` instead (or as well) for spawned
    replicas whose URLs come from ready files and change on restart."""

    def __init__(self, replicas: dict | None = None, *,
                 policy: RouterPolicy | None = None, supervisor=None,
                 clock=time.monotonic):
        self.policy = policy or RouterPolicy()
        self._clock = clock
        self.supervisor = supervisor
        # lock order: _mutlock -> _lock, never the reverse. _plock
        # is a leaf (held only around pool list ops, no calls out).
        self._lock = threading.Lock()
        self._mutlock = threading.Lock()
        self._plock = threading.Lock()
        self.membership = Membership(self.policy)
        self.log = MutationLog(self.policy.replay_buffer)
        # (seq, min_seq) published under _lock after every append, so
        # /healthz and the lag gauges read the log's posture WITHOUT
        # _mutlock — the mutation lock is held across fan-out/replay
        # I/O, and one wedged replica must not stall the health surface
        self._log_posture = (self.log.seq, self.log.min_seq)
        self._inflight: dict[str, int] = {}
        self._pools: dict[tuple, list] = {}
        self.started_s = time.monotonic()
        self._stop = threading.Event()
        self._prober = threading.Thread(
            target=self._probe_loop, name="router-prober", daemon=True
        )
        with self._lock:  # single-threaded here; the discipline is
            # cheap to honor and keeps Membership's contract uniform
            for name, url in sorted((replicas or {}).items()):
                self.membership.add(name, url)
            if supervisor is not None:
                for name in supervisor.names():
                    self.membership.add(name, supervisor.url(name))

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Router":
        self._prober.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._prober.ident is not None:  # join only a started thread
            self._prober.join(
                self.policy.probe_interval_s
                + self.policy.probe_timeout_s + 5
            )
        # close every pooled keep-alive socket: a daemon-threaded shell
        # dies with the process, but an embedding test or CLI stops many
        # routers in one life — their pools must not strand sockets
        with self._plock:
            conns = [c for pool in self._pools.values() for c in pool]
            self._pools.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass

    def wait_rotation(self, n: int, timeout_s: float = 60.0) -> bool:
        """Block until ≥ n replicas are in rotation (startup rendezvous
        for CLIs and tests)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if len(self.membership.in_rotation()) >= n:
                    return True
            if self._stop.wait(0.05):
                return False
        return False

    # -- probe / membership ----------------------------------------------

    def _probe_loop(self) -> None:
        # first cycle immediately: a fresh fleet should not wait a full
        # interval to start joining
        while True:
            try:
                self._probe_once()
            except Exception:  # noqa: BLE001 — the rotation must outlive
                # one bad cycle (a half-dead replica yielding garbage
                # must not kill probing for the healthy ones)
                pass
            if self._stop.wait(self.policy.probe_interval_s):
                return

    def _fetch_healthz(self, url: str) -> dict | None:
        """One health poll — None on ANY failure. A stale pooled
        connection is retried once fresh so an idle-closed socket never
        masquerades as a sick replica."""
        for _attempt in range(2):
            try:
                conn, pooled = self._conn_get("probe", url)
            except OSError:
                return None
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                data = resp.read()
                doc = json.loads(data) if resp.status == 200 else None
            except (OSError, http.client.HTTPException, ValueError,
                    TimeoutError):
                try:
                    conn.close()
                except OSError:
                    pass
                if pooled:
                    continue
                return None
            self._conn_put("probe", url, conn)
            return doc if isinstance(doc, dict) else None
        return None

    def _probe_once(self) -> None:
        with self._lock:
            names = sorted(self.membership.replicas)
        # I/O with no lock held: a wedged replica costs probe_timeout_s
        # of this thread, never a lock anyone else wants
        observed = {}
        urls: dict[str, str | None] = {}
        for name in names:
            url = (
                self.supervisor.url(name)
                if self.supervisor is not None
                else None
            )
            with self._lock:
                if url is None:
                    url = self.membership.replicas[name].url
                elif url != self.membership.replicas[name].url:
                    self.membership.set_url(name, url)
            urls[name] = url
            doc = self._fetch_healthz(url) if url else None
            observed[name] = doc
        self._prune_pools(urls)
        events: list[dict] = []
        with self._mutlock:
            plans = []
            with self._lock:
                now = self._clock()
                for name, doc in observed.items():
                    events += self.membership.note_probe(name, doc, now)
                # quarantine exit: a stale replica whose baseline became
                # coverable again (cold reload)
                for name in names:
                    if self.membership.reloadable(name, self.log.min_seq):
                        events.append(
                            self.membership.note_reload(name, now)
                        )
                # replay planning: joining replicas past probation, and
                # in-rotation replicas a failed fan-out left lagging
                for name in names:
                    r = self.membership.replicas[name]
                    base = max(r.applied_seq, r.acked_seq)
                    promoting = (
                        r.state == JOINING
                        and r.ok_streak >= self.policy.rejoin_after
                    )
                    lagging = r.state == IN and base < self.log.seq
                    if not (promoting or lagging):
                        continue
                    gap = self.log.gap_after(base)
                    if gap is None:
                        events.append(self.membership.quarantine(
                            name, now, min_seq=self.log.min_seq
                        ))
                        self._registry().counter(
                            "router_replay_overflow_total",
                            help="replicas quarantined because their "
                            "mutation gap fell off the replay buffer",
                        ).inc()
                        continue
                    plans.append((name, r.url, gap, promoting))
            # replay I/O under _mutlock only: live mutations queue
            # behind the replay, preserving the global order
            for name, url, gap, promoting in plans:
                done = self._send_gap(name, url, gap)
                if promoting and done:
                    with self._lock:
                        r = self.membership.replicas[name]
                        if r.state == JOINING:
                            events.append(
                                self.membership.promote(name, self._clock())
                            )
        self._note_events(events)
        with self._lock:  # the published posture, never _mutlock: the
            # gauges must not queue behind replay I/O
            seq_now = self._log_posture[0]
            rotation = len(self.membership.in_rotation())
            lags = {
                name: max(0, seq_now
                          - max(r.applied_seq, r.acked_seq))
                for name, r in self.membership.replicas.items()
            }
        reg = self._registry()
        reg.gauge(
            "router_rotation_size", help="replicas in rotation"
        ).set(rotation)
        for name, lag in sorted(lags.items()):
            reg.gauge(
                "router_replica_lag", help="mutation seqs behind the log",
                labels={"replica": name},
            ).set(lag)

    def _send_gap(self, name: str, url: str | None, gap) -> bool:
        """Replay ``gap`` to one replica in seq order; stop at the first
        non-deterministic failure (order must never have holes). True
        when the replica acknowledged the whole gap."""
        if url is None:
            return False
        for seq, path, tenant, body in gap:
            status, rdoc = self._post_to(
                name, url, path, body, tenant, seq,
                timeout_s=self.policy.fanout_timeout_s,
            )
            if status not in _DETERMINISTIC:
                return False
            self._note_leg(name, seq, rdoc)
            self._registry().counter(
                "router_replayed_mutations_total",
                help="buffered mutations replayed to replicas",
                labels={"replica": name},
            ).inc()
        return True

    def _note_events(self, events) -> None:
        reg = self._registry()
        for ev in events:
            reg.counter(
                "router_membership_transitions_total",
                help="membership state transitions",
                labels={"event": ev["event"]},
            ).inc()
            obs_spans.event(
                "membership", cat="router", event=ev["event"],
                replica=ev["replica"], state=ev["state"],
            )

    def _note_leg(self, name: str, seq: int, rdoc) -> None:
        """Fold one DETERMINISTIC fan-out/replay leg into the replica's
        marks: the ack horizon reaches ``seq``, and the response's own
        ``applied_seq`` (both serve and modeled replicas stamp it)
        advances the probed mark BETWEEN probe cycles — restart
        detection and replay planning must never work from a mark
        staler than the legs the router already saw land."""
        rep = rdoc.get("applied_seq") if isinstance(rdoc, dict) else None
        with self._lock:
            r = self.membership.replicas[name]
            if seq > r.acked_seq:
                r.acked_seq = seq
            if rep is not None and int(rep) > r.applied_seq:
                r.applied_seq = int(rep)

    # -- connection pooling ----------------------------------------------

    def _conn_get(self, name: str, url: str):
        """(conn, pooled): a keep-alive connection — pooled=True means
        it may have gone stale (server closed it between requests) and
        a transport failure on it warrants one fresh retry."""
        key = (name, url)
        with self._plock:
            pool = self._pools.get(key)
            if pool:
                return pool.pop(), True
        import socket

        u = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(
            u.hostname, u.port or 80, timeout=self.policy.probe_timeout_s
        )
        conn.connect()
        # Nagle + delayed-ACK would stall the headers/body send pair
        # ~40ms per proxied request — the router must add microseconds,
        # not a TCP timer
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return conn, False

    def _conn_put(self, name: str, url: str, conn) -> None:
        with self._plock:
            self._pools.setdefault((name, url), []).append(conn)

    def _prune_pools(self, urls: dict) -> None:
        """Drop (and close) pooled connections whose url is no longer
        any replica's CURRENT url: a supervised restart publishes a new
        port, and the old port's sockets would otherwise strand open
        under the dead key for the process lifetime. ``urls`` maps
        replica name → current base url (None while unpublished)."""
        live = {u for u in urls.values() if u}
        stale = []
        with self._plock:
            for key in list(self._pools):
                name, url = key
                current = (
                    url in live if name == "probe"
                    else urls.get(name) == url
                )
                if not current:
                    stale.extend(self._pools.pop(key))
        for conn in stale:  # close OUTSIDE _plock (leaf lock, no calls)
            try:
                conn.close()
            except OSError:
                pass

    # -- query path -------------------------------------------------------

    def route_query(self, tenant: str, exclude=()) -> tuple | None:
        """(name, url, spilled) for one query, or None when the rotation
        (minus ``exclude``) is empty. Bumps the in-flight count — pair
        with :meth:`finish_query`."""
        with self._lock:
            known = sorted(self.membership.replicas)
            rotation = {
                n: (r.queue_rows, self._inflight.get(n, 0))
                for n, r in self.membership.replicas.items()
                if r.state == IN and n not in exclude
                and r.url is not None
            }
            name, spilled = choose_replica(
                tenant, known, rotation,
                spill_queue_rows=self.policy.spill_queue_rows,
            )
            if name is None:
                return None
            self._inflight[name] = self._inflight.get(name, 0) + 1
            url = self.membership.replicas[name].url
        if spilled:
            self._registry().counter(
                "router_spills_total",
                help="queries routed off their affine replica",
            ).inc()
        return name, url, spilled

    def finish_query(self, name: str) -> None:
        with self._lock:
            self._inflight[name] = max(0, self._inflight.get(name, 0) - 1)

    def forward_query(self, tenant: str, body: bytes,
                      ctype: str) -> tuple:
        """(status, headers, body) — proxy one query to the chosen
        replica; on a TRANSPORT failure (never an HTTP status) retry
        once on a different replica: queries are idempotent, and the
        in-flight requests of a killed replica are exactly what the
        rolling-restart drill must not surface as 5xx."""
        reg = self._registry()
        exclude: set[str] = set()
        for _attempt in range(2):
            pick = self.route_query(tenant, exclude=exclude)
            if pick is None:
                reg.counter(
                    "router_no_replica_total",
                    help="requests refused with an empty rotation",
                ).inc()
                return 503, {"Retry-After": "1"}, _json_body({
                    "error": "no-replicas",
                    "detail": "no replica in rotation",
                    "tenant": tenant,
                })
            name, url, _sp = pick
            try:
                status, headers, data = self._proxy(
                    name, url, "/query", body,
                    {"Content-Type": ctype, TENANT_HEADER: tenant},
                    timeout_s=self.policy.request_timeout_s,
                )
            except (OSError, http.client.HTTPException, ValueError,
                    TimeoutError):
                reg.counter(
                    "router_proxy_failures_total",
                    help="transport failures talking to a replica",
                    labels={"replica": name},
                ).inc()
                exclude.add(name)
                continue
            finally:
                self.finish_query(name)
            reg.counter(
                "router_requests_total",
                help="queries proxied, by serving replica",
                labels={"replica": name},
            ).inc()
            headers["X-Routed-To"] = name
            return status, headers, data
        return 502, {}, _json_body({
            "error": "replica-unreachable",
            "detail": "transport failed on two replicas",
            "tenant": tenant,
        })

    def _proxy(self, name: str, url: str, path: str, body: bytes,
               headers: dict, *, timeout_s: float) -> tuple:
        """One proxied round trip over a pooled keep-alive connection;
        a stale pooled connection is retried once on a fresh one, a
        fresh-connection failure propagates to the caller."""
        while True:
            conn, pooled = self._conn_get(name, url)
            conn.timeout = timeout_s
            if conn.sock is not None:
                conn.sock.settimeout(timeout_s)
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException, ValueError,
                    TimeoutError):
                try:
                    conn.close()
                except OSError:
                    pass
                if not pooled:
                    raise
                continue
            out_headers = {}
            for h in ("Content-Type", "Retry-After"):
                v = resp.getheader(h)
                if v is not None:
                    out_headers[h] = v
            self._conn_put(name, url, conn)
            return resp.status, out_headers, data

    # -- mutation path ----------------------------------------------------

    def mutate(self, path: str, tenant: str, body: bytes) -> tuple:
        """(status, doc): sequence one mutation and fan it out to every
        in-rotation replica under the mutation lock — the lock IS the
        ordering authority (two concurrent mutations serialize here, so
        every replica sees the same order the log records). A replica
        that fails transiently is left lagging; the probe loop replays
        it forward (duplicates suppressed replica-side)."""
        try:
            doc = json.loads(body)
            if not isinstance(doc, dict) or "ids" not in doc:
                raise ValueError("mutation body must carry ids")
        except (ValueError, TypeError) as e:
            return 400, {"error": f"malformed mutation: {e}"}
        reg = self._registry()
        with self._mutlock:
            with self._lock:
                targets = [
                    (n, self.membership.replicas[n].url)
                    for n in self.membership.in_rotation()
                    if self.membership.replicas[n].url is not None
                ]
            if not targets:
                reg.counter(
                    "router_no_replica_total",
                    help="requests refused with an empty rotation",
                ).inc()
                return 503, {
                    "error": "no-replicas",
                    "detail": "no replica in rotation",
                    "tenant": tenant,
                }
            seq = self.log.append(path, tenant, body)
            with self._lock:  # lock order: _mutlock -> _lock
                self._log_posture = (self.log.seq, self.log.min_seq)
            reg.counter(
                "router_mutations_total",
                help="mutations sequenced, by route",
                labels={"path": path.lstrip("/")},
            ).inc()
            results: dict[str, tuple] = {}
            for name, url in targets:
                status, rdoc = self._post_to(
                    name, url, path, body, tenant, seq,
                    timeout_s=self.policy.fanout_timeout_s,
                )
                results[name] = (status, rdoc)
                if status in _DETERMINISTIC:
                    self._note_leg(name, seq, rdoc)
                else:
                    reg.counter(
                        "router_fanout_failures_total",
                        help="mutation fan-out legs that failed "
                        "(replayed later)",
                        labels={"replica": name},
                    ).inc()
        applied = sorted(n for n, (s, _) in results.items() if s == 200)
        failed = sorted(n for n in results if n not in applied)
        first_doc = next(
            (d for _n, (s, d) in sorted(results.items())
             if s == 200 and isinstance(d, dict)),
            None,
        )
        if not applied:
            # every leg failed: surface the first replica's verdict when
            # it was deterministic (a 400 IS a 400), else a structured 502
            status0, doc0 = results[sorted(results)[0]]
            if status0 in _DETERMINISTIC and isinstance(doc0, dict):
                return status0, {**doc0, "seq": seq, "failed": failed}
            return 502, {
                "error": "fanout-failed", "seq": seq, "failed": failed,
            }
        return 200, {
            "seq": seq, "applied": applied, "failed": failed,
            "result": first_doc,
        }

    def _post_to(self, name: str, url: str, path: str, body: bytes,
                 tenant: str, seq: int, *, timeout_s: float) -> tuple:
        """(status, doc-or-None) for one mutation leg; transport
        failures come back as status 0, never an exception."""
        try:
            status, _h, data = self._proxy(
                name, url, path, body,
                {
                    "Content-Type": "application/json",
                    TENANT_HEADER: tenant,
                    SEQ_HEADER: str(seq),
                },
                timeout_s=timeout_s,
            )
        except (OSError, http.client.HTTPException, ValueError,
                TimeoutError):
            return 0, None
        try:
            return status, json.loads(data)
        except ValueError:
            return status, None

    # -- posture ----------------------------------------------------------

    def stats(self) -> dict:
        """The router's own ``GET /healthz`` document. Reads the log's
        PUBLISHED posture, never ``_mutlock``: the mutation lock is held
        across fan-out/replay I/O, and the health endpoint must answer
        while a wedged replica is timing a leg out."""
        with self._lock:
            seq, min_seq = self._log_posture
            replicas = self.membership.posture()
            rotation = self.membership.in_rotation()
            inflight = dict(sorted(self._inflight.items()))
            # mirror the index facts (dim/k/backend/...) from any probed
            # replica, so a load generator can point at the router and
            # shape requests exactly as it would against one replica
            facts = {}
            for _n, r in sorted(self.membership.replicas.items()):
                if r.doc is not None:
                    facts = {
                        key: r.doc.get(key)
                        for key in ("dim", "k", "backend",
                                    "max_batch_rows")
                        if key in r.doc
                    }
                    break
        doc = {
            "ok": True,
            "role": "router",
            **facts,
            "uptime_s": round(time.monotonic() - self.started_s, 3),
            "seq": seq,
            "min_buffered_seq": min_seq,
            "rotation": rotation,
            "replicas": replicas,
            "inflight": inflight,
            "policy": {
                "probe_interval_s": self.policy.probe_interval_s,
                "evict_after": self.policy.evict_after,
                "rejoin_after": self.policy.rejoin_after,
                "spill_queue_rows": self.policy.spill_queue_rows,
                "replay_buffer": self.policy.replay_buffer,
            },
        }
        if self.supervisor is not None:
            doc["children"] = self.supervisor.posture()
        return doc

    def _registry(self):
        return obs_metrics.get_registry()


def _json_body(doc: dict) -> bytes:
    return (json.dumps(doc) + "\n").encode()


# ---------------------------------------------------------------------------
# HTTP shell


def _router_handler(router: Router, quiet: bool = True):
    """The handler class bound to one router (closure construction, the
    front end's convention — stdlib handlers have no constructor
    channel)."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A003
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        def _send(self, status: int, headers: dict, body: bytes) -> None:
            self.send_response(status)
            for k, v in headers.items():
                self.send_header(k, v)
            if "Content-Type" not in headers:
                self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            n = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(n) if n > 0 else b""

        def do_POST(self):  # noqa: N802 — stdlib handler convention
            tenant = self.headers.get(TENANT_HEADER, DEFAULT_TENANT)
            body = self._body()
            if self.path == "/query":
                ctype = (
                    self.headers.get("Content-Type")
                    or "application/octet-stream"
                )
                status, headers, data = router.forward_query(
                    tenant, body, ctype
                )
                self._send(status, headers, data)
            elif self.path in ("/upsert", "/delete"):
                status, doc = router.mutate(self.path, tenant, body)
                self._send(status, {}, _json_body(doc))
            else:
                self._send(404, {}, _json_body(
                    {"error": f"no such route {self.path}"}
                ))

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, {}, _json_body(router.stats()))
            elif self.path == "/metrics":
                text = obs_metrics.get_registry().to_prometheus()
                self._send(
                    200,
                    {"Content-Type": "text/plain; version=0.0.4"},
                    text.encode(),
                )
            else:
                self._send(404, {}, _json_body(
                    {"error": f"no such route {self.path}"}
                ))

    return Handler


class RouterHTTPServer:
    """``ThreadingHTTPServer`` wrapper for the router — the front end
    server's bind/serve/stop shape, ``--port 0`` picks an ephemeral
    port."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, quiet: bool = True):
        from mpi_knn_tpu_torch.frontend.server import _tuned_server_class

        self.router = router
        self._httpd = _tuned_server_class()(
            (host, port), _router_handler(router, quiet)
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http",
            daemon=True,
        )

    @property
    def address(self) -> tuple:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "RouterHTTPServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(10.0)


# ---------------------------------------------------------------------------
# replica supervisor


class ReplicaSupervisor:
    """N supervised ``serve`` children — one thread per slot
    looping :func:`~mpi_knn_tpu_torch.resilience.worker.run_supervised`, so a
    crashed replica is restarted (and then health-gated back into
    rotation by the router; the supervisor only keeps processes alive,
    it never touches membership). Children bind ``--port 0`` and publish
    their URL to a per-slot ready file (atomic rename), which doubles as
    discovery: the prober re-reads it every cycle, so a restarted child
    on a new port is found without any registration channel."""

    def __init__(self, count: int, serve_args, *, workdir: str,
                 restart_backoff_s: float = 0.5):
        if count < 1:
            raise ValueError("need at least one replica")
        self.count = count
        self.serve_args = list(serve_args)
        self.workdir = workdir
        self.restart_backoff_s = restart_backoff_s
        os.makedirs(workdir, exist_ok=True)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._pids: dict[str, int] = {}
        self._last: dict[str, dict] = {}
        self._threads = [
            threading.Thread(
                target=self._supervise, args=(i,),
                name=f"replica-supervisor-{i}", daemon=True,
            )
            for i in range(count)
        ]

    def names(self) -> list[str]:
        return [f"r{i}" for i in range(self.count)]

    def _ready_file(self, name: str) -> str:
        return os.path.join(self.workdir, f"{name}.url")

    def start(self) -> "ReplicaSupervisor":
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout_s)

    def _supervise(self, i: int) -> None:
        from mpi_knn_tpu_torch.resilience.worker import (
            python_worker_argv,
            run_supervised,
        )

        name = f"r{i}"
        ready = self._ready_file(name)
        while not self._stop.is_set():
            try:
                os.unlink(ready)  # a dead child's URL must not linger
            except OSError:
                pass
            argv = python_worker_argv(
                "-m", "mpi_knn_tpu_torch", "serve", *self.serve_args,
                "--port", "0", "--ready-file", ready, "-q",
            )

            def note_pid(pid: int, name=name) -> None:
                with self._lock:
                    self._pids[name] = pid

            res = run_supervised(
                argv, beat_timeout_s=None, wall_timeout_s=None,
                stop_event=self._stop, on_spawn=note_pid,
            )
            with self._lock:
                self._pids.pop(name, None)
                self._last[name] = {
                    "status": res.status,
                    "returncode": res.returncode,
                    "reason": res.reason,
                    "stderr_tail": res.stderr_tail[-512:],
                }
            if self._stop.is_set():
                break
            obs_metrics.get_registry().counter(
                "router_replica_restarts_total",
                help="supervised replica children restarted",
                labels={"replica": name},
            ).inc()
            obs_spans.event(
                "replica-exit", cat="router", replica=name,
                status=res.status,
                returncode=res.returncode if res.returncode is not None
                else -1,
            )
            self._stop.wait(self.restart_backoff_s)

    def url(self, name: str) -> str | None:
        """The replica's published base URL — None while it is (re)
        booting. Read from the ready file every time: the file IS the
        discovery channel and a restart rewrites it."""
        try:
            with open(self._ready_file(name)) as f:
                url = f.read().strip()
            return url or None
        except OSError:
            return None

    def pid(self, name: str) -> int | None:
        with self._lock:
            return self._pids.get(name)

    def posture(self) -> dict:
        with self._lock:
            pids = dict(self._pids)
            last = {n: dict(d) for n, d in self._last.items()}
        return {
            name: {
                "pid": pids.get(name),
                "url": self.url(name),
                "last_exit": last.get(name),
            }
            for name in self.names()
        }
