"""Guard maps — the declared concurrency contract of the port's threaded
host modules, and the target list ``python -m mpi_knn_tpu_torch lint
--host`` sweeps.

The map is ENFORCED, not advisory (rule H1): a shared mutable attribute
of a thread-crossing class that is not declared here — guarded by a
named lock, confined to a named thread root, or explicitly waived with a
rationale — is a finding when it is touched from two or more thread
roots. Waivers are counted in the report, so intentional unguarded
access cannot accrete silently. A declared name that no longer exists in
the scanned source is a problem of its own (a stale map), so this map is
written from the port's classes and attributes, entry by entry.

Vocabulary (one :class:`ClassGuard` per class):

- ``guarded={attr: lock}`` — every access site must sit inside
  ``with <lock>:`` (an attr name of the same class, or a full token
  like ``frontend.server.Frontend._lock`` / ``obs.spans:_reclock``).
- ``confined={attr: root}`` — the attr belongs to ONE thread root
  (rule H3: it must be unreachable from every other root's call graph).
- ``serialized_by=<token>`` — an externally-serialized pure class (the
  coalescer/scheduler pattern): the class holds no lock of its own, and
  every call into it from outside its serialization group must hold the
  named lock.
- ``instance_per_thread=<root>`` — handler-style classes whose every
  instance lives on one thread (stdlib ``BaseHTTPRequestHandler``).
- ``waivers={attr: rationale}`` — deliberate unguarded access, with the
  one-line why.

Map-wide fields: ``attr_types``/``name_types``/``callbacks`` are
resolution hints for the call graph; ``lock_factories`` names functions
that hand out a lock (``with mutation_lock(index):``) and the token the
rules call it; ``reentrant`` the RLock tokens; ``call_guards`` the
functions whose every call must hold a lock.
"""

from __future__ import annotations

import dataclasses
import pathlib
from dataclasses import field

_PKG = pathlib.Path(__file__).resolve().parents[2]  # mpi_knn_tpu_torch/


@dataclasses.dataclass
class ClassGuard:
    guarded: dict[str, str] = field(default_factory=dict)
    confined: dict[str, str] = field(default_factory=dict)
    confined_methods: set[str] = field(default_factory=set)
    waivers: dict[str, str] = field(default_factory=dict)
    aliases: dict[str, str] = field(default_factory=dict)
    serialized_by: str | None = None
    instance_per_thread: str | None = None
    force_thread_crossing: bool = False


@dataclasses.dataclass
class GuardMap:
    classes: dict[str, ClassGuard] = field(default_factory=dict)
    # module -> {global name: lock token} / {global name: rationale}
    module_guards: dict[str, dict[str, str]] = field(default_factory=dict)
    module_waivers: dict[str, dict[str, str]] = field(default_factory=dict)
    # "<class qual>.<attr>" -> class qual (instance typing for chains)
    attr_types: dict[str, str] = field(default_factory=dict)
    # module -> {bare/closure name: class qual}
    name_types: dict[str, dict[str, str]] = field(default_factory=dict)
    # "<class qual>.<attr>" (called as self.attr()) -> function qual
    callbacks: dict[str, str] = field(default_factory=dict)
    # root name -> function quals (declared roots; spawns auto-detect more)
    roots: dict[str, list[str]] = field(default_factory=dict)
    # "<function qual>" -> rationale (H4 write-site waivers)
    h4_waivers: dict[str, str] = field(default_factory=dict)
    # "<function qual>" of a function returning a lock -> its token
    lock_factories: dict[str, str] = field(default_factory=dict)
    # lock tokens of re-entrant locks (RLock)
    reentrant: set[str] = field(default_factory=set)
    # "<function qual>" -> the lock token every call of it must hold
    call_guards: dict[str, str] = field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class HostTarget:
    """One lint target: a named group of (module key, source path)."""

    name: str
    modules: tuple[tuple[str, str], ...]


def default_targets() -> list[HostTarget]:
    """The JAX package's seven threaded-module targets, and the port's
    own eighth and ninth: ``ops._build``, the kernel libraries' builds
    behind the cache (nvcc processes started together, loaded under a
    module lock), and ``parallel.hostlink``, the grid form's host proxy
    (one thread a call, started before K5's launch and joined after it)."""

    def p(rel: str) -> str:
        return str(_PKG / rel)

    return [
        HostTarget("frontend", (
            ("frontend.coalesce", p("frontend/coalesce.py")),
            ("frontend.scheduler", p("frontend/scheduler.py")),
            ("frontend.server", p("frontend/server.py")),
            ("frontend.loadgen", p("frontend/loadgen.py")),
            ("frontend.router", p("frontend/router.py")),
            ("frontend.modelreplica", p("frontend/modelreplica.py")),
            ("frontend.cli", p("frontend/cli.py")),
        )),
        HostTarget("serve.engine", (("serve.engine", p("serve/engine.py")),)),
        HostTarget("serve.mutate", (("serve.mutate", p("serve/mutate.py")),)),
        HostTarget(
            "serve.aotcache", (("serve.aotcache", p("serve/aotcache.py")),)
        ),
        HostTarget("obs.metrics", (("obs.metrics", p("obs/metrics.py")),)),
        HostTarget("obs.spans", (("obs.spans", p("obs/spans.py")),)),
        HostTarget(
            "resilience.worker",
            (("resilience.worker", p("resilience/worker.py")),),
        ),
        HostTarget("ops._build", (("ops._build", p("ops/_build.py")),)),
        HostTarget("parallel.hostlink",
                   (("parallel.hostlink", p("parallel/hostlink.py")),)),
    ]


def default_guards() -> GuardMap:
    """The production guard map — the port's serving stack's threading
    contract in one place."""
    g = GuardMap()

    # -- frontend ---------------------------------------------------------
    g.classes["frontend.server.Frontend"] = ClassGuard(
        guarded={
            "_tickets": "_lock",
            "_stop": "_lock",
            "_crashed": "_lock",
            "_applied_seq": "_lock",
        },
        confined={
            # the pump is the only thread that dispatches and scatters
            "_dispatched": "dispatch-pump",
        },
    )
    g.classes["frontend.server.Ticket"] = ClassGuard(
        force_thread_crossing=True,
        waivers={
            "_dists": "published before _event.set(); readers wait on "
            "the Event (happens-before via Event.set/wait)",
            "_ids": "published before _event.set(); readers wait on the "
            "Event",
            "_error": "published before _event.set(); readers wait on "
            "the Event",
            "done_s": "published before _event.set(); readers wait on "
            "the Event",
        },
    )
    g.classes["frontend.scheduler.FrontendScheduler"] = ClassGuard(
        serialized_by="frontend.server.Frontend._lock",
    )
    g.classes["frontend.coalesce.Coalescer"] = ClassGuard(
        serialized_by="frontend.server.Frontend._lock",
    )
    g.classes["frontend.server._http_handler.Handler"] = ClassGuard(
        instance_per_thread="http-handler",
    )
    g.classes["frontend.server.FrontendHTTPServer"] = ClassGuard()
    g.classes["frontend.server._tuned_server_class.TunedHTTPServer"] = (
        ClassGuard(guarded={"_live_socks": "_live_lock"})
    )

    # -- frontend.router --------------------------------------------------
    # lock order (H2): _mutlock -> _lock, strict; _plock is a leaf
    g.classes["frontend.router.Router"] = ClassGuard(
        guarded={
            "_inflight": "_lock",
            "_pools": "_plock",
            "log": "_mutlock",
            "_log_posture": "_lock",
        },
    )
    g.classes["frontend.router.Membership"] = ClassGuard(
        serialized_by="frontend.router.Router._lock",
    )
    g.classes["frontend.router.ReplicaState"] = ClassGuard(
        serialized_by="frontend.router.Router._lock",
    )
    g.classes["frontend.router.MutationLog"] = ClassGuard(
        serialized_by="frontend.router.Router._mutlock",
    )
    g.classes["frontend.router._router_handler.Handler"] = ClassGuard(
        instance_per_thread="http-handler",
    )
    g.classes["frontend.router.RouterHTTPServer"] = ClassGuard()
    g.classes["frontend.router.ReplicaSupervisor"] = ClassGuard(
        guarded={"_pids": "_lock", "_last": "_lock"},
    )
    g.classes["frontend.modelreplica.ModelReplica"] = ClassGuard(
        guarded={
            "_applied_seq": "_lock",
            "_mutations": "_lock",
            "_queries": "_lock",
            "_waiting": "_lock",
            "_failing": "_lock",
            "_drop_mutations": "_lock",
        },
    )
    g.classes["frontend.modelreplica._model_handler.Handler"] = (
        ClassGuard(instance_per_thread="http-handler")
    )

    # -- serve engine -----------------------------------------------------
    g.classes["serve.engine.ServeSession"] = ClassGuard(
        guarded={
            "warm_state": "_warm_lock",
            "latencies": "_stats_lock",
            "queries_served": "_stats_lock",
            "retries_total": "_stats_lock",
            "deadline_breaches": "_stats_lock",
            "tenant_stats": "_stats_lock",
            "exchange": "_stats_lock",
            "degradations": "_stats_lock",
            "restorations": "_stats_lock",
            "_rung": "_stats_lock",
            "mutation_stats": "_stats_lock",
        },
        confined={
            "_inflight": "dispatch-pump",
            "_seq": "dispatch-pump",
            "_consecutive_breaches": "dispatch-pump",
        },
        waivers={
            "warm_report": "written once by the warm thread before "
            "_serving_ready.set(); readers wait on that Event",
        },
    )
    g.classes["serve.engine._BucketExec"] = ClassGuard()
    # the dispatch-versus-mutation contract: every batch dispatch and
    # every mutation takes the per-index mutation lock (an RLock handed
    # out by engine.mutation_lock), and order_stream, which chains the
    # streams that enqueue work on the resident tensors, runs only under
    # it; the per-entry build locks (engine._key_lock) are taken inside
    # it by a dispatch, never around it
    g.lock_factories.update({
        "serve.engine.mutation_lock": "serve.engine:mutation_lock",
        "serve.engine._key_lock": "serve.engine:_key_lock",
    })
    g.reentrant.add("serve.engine:mutation_lock")
    g.call_guards["serve.engine.order_stream"] = "serve.engine:mutation_lock"
    g.module_guards["serve.engine"] = {
        # the entries-built count: the warm pool and the pump build
        # entries at once, a test or a caller resets it
        "MISSES": "serve.engine:_LOCK_MUTEX",
    }

    # -- serve.mutate -----------------------------------------------------
    g.classes["serve.mutate.Compactor"] = ClassGuard(
        guarded={"_history": "_lock", "_deferred": "_lock"},
    )

    # -- aot cache --------------------------------------------------------
    g.classes["serve.aotcache.AOTCache"] = ClassGuard()
    g.module_guards["serve.aotcache"] = {
        "_active": "serve.aotcache:_lock",
        "_configured": "serve.aotcache:_lock",
    }

    # -- obs --------------------------------------------------------------
    for cls in ("Counter", "Gauge"):
        g.classes[f"obs.metrics.{cls}"] = ClassGuard(
            guarded={"_value": "_lock"},
        )
    g.classes["obs.metrics.Histogram"] = ClassGuard(
        guarded={"_counts": "_lock", "_sum": "_lock", "_count": "_lock"},
    )
    g.classes["obs.metrics.MetricsRegistry"] = ClassGuard(
        guarded={"_metrics": "_lock", "_kinds": "_lock"},
    )
    g.classes["obs.spans.FlightRecorder"] = ClassGuard(
        guarded={"_f": "_lock", "_gen": "_lock", "_open_t0": "_lock"},
        waivers={
            "_ids": "itertools.count.__next__ is atomic under the GIL "
            "(single bytecode, C-implemented)",
            "_stack": "threading.local: per-thread by construction",
        },
    )
    g.module_guards["obs.spans"] = {
        "_recorder": "obs.spans:_reclock",
        "_env_recorder": "obs.spans:_reclock",
    }

    # -- resolution hints -------------------------------------------------
    g.attr_types.update({
        "frontend.server.Frontend.session": "serve.engine.ServeSession",
        "frontend.server.Frontend.scheduler":
            "frontend.scheduler.FrontendScheduler",
        "frontend.scheduler.FrontendScheduler.coalescer":
            "frontend.coalesce.Coalescer",
        "frontend.scheduler.FrontendScheduler._metrics":
            "obs.metrics.MetricsRegistry",
        "serve.engine.ServeSession._metrics": "obs.metrics.MetricsRegistry",
        "frontend.server.FrontendHTTPServer.frontend":
            "frontend.server.Frontend",
        "frontend.router.Router.membership":
            "frontend.router.Membership",
        "frontend.router.Router.log": "frontend.router.MutationLog",
        "frontend.router.Router.supervisor":
            "frontend.router.ReplicaSupervisor",
        "frontend.router.RouterHTTPServer.router":
            "frontend.router.Router",
    })
    g.name_types["frontend.server"] = {"frontend": "frontend.server.Frontend"}
    g.name_types["frontend.router"] = {"router": "frontend.router.Router"}
    g.name_types["frontend.modelreplica"] = {
        "replica": "frontend.modelreplica.ModelReplica",
    }
    g.callbacks.update({
        "frontend.scheduler.FrontendScheduler.on_shed":
            "serve.engine.ServeSession.shed_rung",
        "frontend.scheduler.FrontendScheduler.on_recover":
            "serve.engine.ServeSession.restore_rung",
    })

    # -- thread roots -----------------------------------------------------
    g.roots.update({
        # stdlib ThreadingHTTPServer spawns these per connection — not
        # visible as a threading.Thread(...) in the source, so declared
        "http-handler": [
            "frontend.server._http_handler.Handler.do_POST",
            "frontend.server._http_handler.Handler.do_GET",
            "frontend.router._router_handler.Handler.do_POST",
            "frontend.router._router_handler.Handler.do_GET",
            "frontend.modelreplica._model_handler.Handler.do_POST",
            "frontend.modelreplica._model_handler.Handler.do_GET",
        ],
        "dispatch-pump": ["frontend.server.Frontend._run"],
        "router-prober": ["frontend.router.Router._probe_loop"],
        "replica-supervisor": [
            "frontend.router.ReplicaSupervisor._supervise",
        ],
        "warm-pool": [
            "serve.engine.ServeSession.warm",
            "serve.engine.ServeSession.warm.one",
            "frontend.server.Frontend.start._warm",
        ],
    })
    return g
