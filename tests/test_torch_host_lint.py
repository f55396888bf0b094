"""The port's host concurrency lint (``mpi_knn_tpu_torch.analysis.host``):
the JAX package's injected counterexamples through the production rule
path, parity with the JAX package's engine on the same fixtures, the clean
production sweep over the port's threaded modules through the CLI, the
runtime witness layer, the races the sweep found in the port (each
re-injected into a copy of its module and caught), and the port's own
rules for locks handed out by functions (``engine.mutation_lock``).

Convention: every counterexample is a deliberately broken input fed
through the exact production engine (``run_host_lint``, the function
``python -m mpi_knn_tpu_torch lint --host`` calls), never a hand-driven
rule object.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from mpi_knn_tpu_torch.analysis.host import (
    ClassGuard,
    GuardMap,
    HostTarget,
    default_guards,
    default_targets,
    run_host_lint,
)
from mpi_knn_tpu_torch.analysis.host.witness import (
    InstrumentedLock,
    WitnessLog,
    instrument,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "mpi_knn_tpu_torch"


def _target(tmp_path, name: str, src: str) -> HostTarget:
    p = tmp_path / f"{name}.py"
    p.write_text(textwrap.dedent(src))
    return HostTarget(name, ((name, str(p)),))


def _findings(report, rule=None):
    return [f for f in report.findings if rule is None or f.rule == rule]


# ---------------------------------------------------------------------------
# the fixtures: each (name, source, guard map as plain data) — fed to the
# port's engine here and to the JAX package's in the parity test

CX1 = """
    import threading

    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0

        def _run(self):
            self.count += 1  # no lock

        def start(self):
            threading.Thread(target=self._run).start()

        def read(self):
            with self._lock:
                return self.count
"""
CX2 = """
    import threading

    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self._other = threading.Lock()
            self.items = []

        def _run(self):
            with self._other:
                self.items.append(1)

        def start(self):
            threading.Thread(target=self._run).start()
"""
CX3 = """
    import threading

    _a = threading.Lock()
    _b = threading.Lock()

    def forward():
        with _a:
            with _b:
                pass

    def backward():
        with _b:
            helper()

    def helper():
        with _a:
            pass
"""
CX3B = """
    import threading

    _m = threading.Lock()

    def outer():
        with _m:
            inner()

    def inner():
        with _m:
            pass
"""
CX4 = """
    import threading

    class Pump:
        def __init__(self):
            self.inflight = []

        def _run(self):
            self.inflight.append(1)

        def start(self):
            threading.Thread(target=self._run).start()

    class Handler:
        def do_GET(self):
            return peek(self)

    def peek(handler):
        return len(PUMP.inflight)
"""
CX5 = """
    import os

    def store_entry(path, blob):
        with open(path, "wb") as f:   # torn-read window
            f.write(blob)

    def store_entry_atomic(path, blob):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
"""
CX6 = """
    import threading

    class S:
        def __init__(self):
            self.state = {}

        def _writer(self):
            self.state["x"] = 1

        def _reader(self):
            return dict(self.state)

        def start(self):
            threading.Thread(target=self._writer).start()
            threading.Thread(target=self._reader).start()
"""
CX7 = """
    import threading

    class W:
        def __init__(self):
            self._lock = threading.Lock()
            self._inner = threading.Lock()
            self.count = 0

        def _run(self):
            with self._lock:
                self.count += 1
                with self._inner:
                    pass

        def start(self):
            threading.Thread(target=self._run).start()

        def read(self):
            with self._lock:
                return self.count
"""
CX8 = """
    import threading

    _lock = threading.Lock()
    _cached = None

    def get(make):
        global _cached
        {body}

    def worker(make):
        get(make)

    def start(make):
        threading.Thread(target=worker, args=(make,)).start()
        threading.Thread(target=worker, args=(make,)).start()
"""
CX8_BAD = CX8.replace("{body}", """if _cached is None:
            _cached = make()
        return _cached""")
CX8_GOOD = CX8.replace("{body}", """with _lock:
            if _cached is None:
                _cached = make()
            return _cached""")
CX9 = """
    def f():
        return 1
"""
OLD = """
    import threading

    class Session:
        def __init__(self):
            self._warm_lock = threading.Lock()
            self._stats_lock = threading.Lock()
            self.warm_state = {}
            self.latencies = []

        def warm(self):
            self.warm_state = {"total": 1}  # old bug: no lock

        def retire(self):
            with self._stats_lock:
                self.latencies.append(1.0)

    class Front:
        def __init__(self, session):
            self._lock = threading.Lock()
            self.session = session

        def _run(self):
            self.session.retire()

        def start(self):
            threading.Thread(target=self._run).start()

        def stats(self):
            ses = self.session
            with self._lock:
                return len(ses.latencies), dict(ses.warm_state)
"""

# (fixture name, module name, source, guard map as plain data)
FIXTURES = [
    ("unguarded", "cx1", CX1,
     {"classes": {"cx1.W": {"guarded": {"count": "_lock"}}}}),
    ("wrong_lock", "cx2", CX2,
     {"classes": {"cx2.W": {"guarded": {"items": "_lock"}}}}),
    ("cycle", "cx3", CX3, {}),
    ("self_deadlock", "cx3b", CX3B, {}),
    ("confinement", "cx4", CX4,
     {"classes": {"cx4.Pump": {"confined": {"inflight": "pump"}}},
      "roots": {"pump": ["cx4.Pump._run"],
                "http-handler": ["cx4.Handler.do_GET"]},
      "name_types": {"cx4": {"PUMP": "cx4.Pump"}}}),
    ("bare_open", "cx5", CX5, {}),
    ("undeclared", "cx6", CX6, {}),
    ("waived", "cx6", CX6,
     {"classes": {"cx6.S": {"waivers": {
         "state": "benign last-write-wins cache (test)"}}}}),
    ("clean", "cx7", CX7,
     {"classes": {"cx7.W": {"guarded": {"count": "_lock"}}}}),
    ("global_bad", "cx8", CX8_BAD, {}),
    ("global_good", "cx8b", CX8_GOOD,
     {"module_guards": {"cx8b": {"_cached": "cx8b:_lock"}}}),
    ("stale_root", "cx9", CX9, {"roots": {"pump": ["cx9.gone"]}}),
    ("old_races", "old", OLD,
     {"classes": {"old.Session": {"guarded": {
         "warm_state": "_warm_lock", "latencies": "_stats_lock"}}},
      "attr_types": {"old.Front.session": "old.Session"},
      "roots": {"http-handler": ["old.Front.stats"],
                "warm-pool": ["old.Session.warm"]}}),
]


def _guards(data: dict, guard_map=GuardMap, class_guard=ClassGuard):
    g = guard_map()
    for cls, fields in data.get("classes", {}).items():
        g.classes[cls] = class_guard(**fields)
    for name in ("roots", "name_types", "attr_types", "module_guards",
                 "h4_waivers"):
        getattr(g, name).update(data.get(name, {}))
    return g


def _run_fixture(tmp_path, name: str):
    _, module, src, data = next(f for f in FIXTURES if f[0] == name)
    return run_host_lint([_target(tmp_path, module, src)],
                         guards=_guards(data))


# ---------------------------------------------------------------------------
# the JAX package's injected counterexamples, on the port's engine


def test_unguarded_write_fires(tmp_path):
    """H1: a guarded attribute written with no lock held."""
    rep = _run_fixture(tmp_path, "unguarded")
    f = _findings(rep, "H1-lock-discipline")
    assert len(f) == 1 and f[0].where == "cx1.W._run"
    assert "with no lock held" in f[0].message
    assert not rep.ok


def test_wrong_lock_guard_fires(tmp_path):
    """H1: the access holds A lock — just not the declared one."""
    rep = _run_fixture(tmp_path, "wrong_lock")
    f = _findings(rep, "H1-lock-discipline")
    assert len(f) == 1 and "WRONG lock" in f[0].message
    assert "cx2.W._other" in f[0].message


def test_lock_order_cycle_fires(tmp_path):
    """H2: A->B lexically, B->A through the call graph — a cycle, found
    statically and named in the report's lock graph."""
    rep = _run_fixture(tmp_path, "cycle")
    f = _findings(rep, "H2-lock-order")
    assert len(f) == 1 and "cycle" in f[0].message
    assert rep.lock_graph.cycles == [["cx3:_a", "cx3:_b"]]
    assert not rep.lock_graph.acyclic and not rep.ok


def test_self_deadlock_fires(tmp_path):
    """H2: re-acquiring a held non-reentrant lock through a call."""
    rep = _run_fixture(tmp_path, "self_deadlock")
    f = _findings(rep, "H2-lock-order")
    assert len(f) == 1 and "self-deadlock" in f[0].message


def test_confinement_breach_from_http_handler_fires(tmp_path):
    """H3: a pump-confined attribute reachable from a declared
    HTTP-handler root."""
    rep = _run_fixture(tmp_path, "confinement")
    f = _findings(rep, "H3-confinement")
    assert len(f) == 1 and f[0].where == "cx4.peek"
    assert "http-handler" in f[0].message


def test_bare_open_w_in_cache_writer_fires(tmp_path):
    """H4: a bare truncating write in a threaded cache-entry writer — and
    the temp+os.replace idiom in the same module passes."""
    rep = _run_fixture(tmp_path, "bare_open")
    f = _findings(rep, "H4-atomic-publish")
    assert len(f) == 1 and f[0].where == "cx5.store_entry"
    assert "mpi_knn_tpu_torch.utils.atomicio" in f[0].message
    g = GuardMap()
    g.h4_waivers["cx5.store_entry"] = "test-only artifact, single writer"
    rep2 = run_host_lint([_target(tmp_path, "cx5", CX5)], guards=g)
    assert not _findings(rep2, "H4-atomic-publish")
    assert any("store_entry" in str(w["where"]) for w in rep2.waivers)


def test_undeclared_shared_attribute_fires(tmp_path):
    """H1 enforcement teeth: an attribute in NO guard map, mutated outside
    __init__, touched from two thread roots."""
    rep = _run_fixture(tmp_path, "undeclared")
    f = _findings(rep, "H1-lock-discipline")
    assert len(f) == 1 and "undeclared shared attribute" in f[0].message
    assert f[0].attr == "cx6.S.state"


def test_waiver_honored_and_counted(tmp_path):
    """The same module goes green under an explicit waiver, and the waiver
    is enumerated in the report."""
    rep = _run_fixture(tmp_path, "waived")
    assert rep.ok and not rep.findings
    assert rep.waivers == [{
        "where": "cx6.S.state",
        "rationale": "benign last-write-wins cache (test)",
    }]
    assert rep.to_json()["summary"]["waivers"] == 1


def test_clean_module_green(tmp_path):
    """A correctly-locked module produces zero findings and the right
    lock-order edge."""
    rep = _run_fixture(tmp_path, "clean")
    assert rep.ok and not rep.findings
    assert ("cx7.W._lock", "cx7.W._inner") in set(rep.lock_graph.edges)
    assert rep.lock_graph.acyclic


def test_undeclared_global_fires_and_module_guard_passes(tmp_path):
    """H1 on module globals: an unguarded lazy singleton fires; the
    declared module lock silences it when actually held."""
    f = _findings(_run_fixture(tmp_path, "global_bad"), "H1-lock-discipline")
    assert f and "module global" in f[0].message
    assert _run_fixture(tmp_path, "global_good").ok


def test_stale_guard_map_is_a_problem(tmp_path):
    """A declared root naming a function that no longer exists makes the
    report NOT ok."""
    rep = _run_fixture(tmp_path, "stale_root")
    assert not rep.ok and rep.problems


def test_production_sweep_would_catch_the_fixed_races(tmp_path):
    """The JAX package's regression pin: its old unguarded patterns in a
    fixture fire on the port's rules too."""
    rep = _run_fixture(tmp_path, "old_races")
    assert {f.attr for f in rep.findings} == {
        "old.Session.latencies", "old.Session.warm_state",
    }
    assert len(rep.findings) == 3  # warm write + two raw stats reads
    assert {f.where for f in rep.findings} == {
        "old.Session.warm", "old.Front.stats",
    }


# ---------------------------------------------------------------------------
# parity: the JAX package's engine and the port's, same fixtures, same map


@pytest.mark.parametrize("name", [f[0] for f in FIXTURES])
def test_findings_equal_the_reference_engine(tmp_path, name):
    from mpi_knn_tpu.analysis.host import ClassGuard as RefClassGuard
    from mpi_knn_tpu.analysis.host import GuardMap as RefGuardMap
    from mpi_knn_tpu.analysis.host import HostTarget as RefHostTarget
    from mpi_knn_tpu.analysis.host import run_host_lint as ref_run

    _, module, src, data = next(f for f in FIXTURES if f[0] == name)
    target = _target(tmp_path, module, src)
    port = run_host_lint([target], guards=_guards(data))
    ref = ref_run([RefHostTarget(target.name, target.modules)],
                  guards=_guards(data, RefGuardMap, RefClassGuard))

    def key(rep):
        return sorted((f.rule, f.module, f.where, f.lineno, f.attr)
                      for f in rep.findings)

    assert key(port) == key(ref)
    assert port.ok == ref.ok
    assert port.lock_graph.to_json() == ref.lock_graph.to_json()
    assert port.waivers == ref.waivers
    assert bool(port.problems) == bool(ref.problems)


# ---------------------------------------------------------------------------
# the production sweep over the port, through the CLI


def test_production_sweep_clean_via_cli(tmp_path):
    """``lint --host``: exit 0 over the JAX package's seven targets and the
    port's ``ops._build`` and ``parallel.hostlink``, zero findings, zero
    problems, every waiver with a rationale, the lock graph acyclic from
    the report, and the port's dispatch-versus-mutation lock in it."""
    from mpi_knn_tpu_torch.analysis.cli import main as lint_main

    assert lint_main(["--host", "-q", "--out", str(tmp_path)]) == 0
    doc = json.loads((tmp_path / "host_report.json").read_text())
    assert doc["ok"] is True
    assert doc["summary"]["findings"] == 0
    assert doc["summary"]["problems"] == 0
    names = {t["name"] for t in doc["targets"]}
    assert names == {
        "frontend", "serve.engine", "serve.mutate", "serve.aotcache",
        "obs.metrics", "obs.spans", "resilience.worker", "ops._build",
        "parallel.hostlink",
    }
    assert all(t["ok"] for t in doc["targets"])
    lg = doc["lock_graph"]
    assert lg["acyclic"] is True and lg["cycles"] == []
    assert "serve.engine.ServeSession._stats_lock" in lg["nodes"]
    assert "serve.engine:mutation_lock" in lg["nodes"]
    assert ["frontend.server.Frontend._lock",
            "serve.engine.ServeSession._stats_lock"] in lg["edges"]
    assert ["ops._build:_load_lock", "serve.aotcache:_lock"] in lg["edges"]
    assert doc["summary"]["waivers"] == len(doc["waivers"]) > 0
    assert all(w["rationale"].strip() for w in doc["waivers"])
    for root in ("dispatch-pump", "http-handler", "warm-pool",
                 "thread:serve.mutate.Compactor._run"):
        assert root in doc["roots"]


def test_host_rule_filter_and_usage_error(tmp_path):
    from mpi_knn_tpu_torch.analysis.cli import main as lint_main

    assert lint_main(["--host", "-q", "--out", str(tmp_path),
                      "--rule", "H2-lock-order"]) == 0
    doc = json.loads((tmp_path / "host_report.json").read_text())
    assert list(doc["rules"]) == ["H2-lock-order"]
    assert lint_main(["--host", "--rule", "H9-nope"]) == 2


def test_package_main_routes_lint_without_torch(tmp_path):
    """``python -m mpi_knn_tpu_torch lint --host`` exits 0 writing its own
    report and loads no torch; ``lint`` without ``--host`` runs the rule
    matrix (a filtered CPU sweep exits 0 with its report), and refuses
    ``--cache-dir`` by name."""
    out = tmp_path / "lint"
    probe = ("import runpy, sys; sys.argv = ['mpi_knn_tpu_torch'] + "
             "sys.argv[1:]\ntry:\n    runpy.run_module('mpi_knn_tpu_torch', "
             "run_name='__main__')\nexcept SystemExit as e:\n    "
             "print('torch' in sys.modules, 'jax' in sys.modules)\n    "
             "raise")
    ok = subprocess.run(
        [sys.executable, "-c", probe, "lint", "--host", "-q", "--out",
         str(out)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.split() == ["False", "False"]
    assert json.loads((out / "host_report.json").read_text())["ok"]
    rules = tmp_path / "rules"
    run = subprocess.run(
        [sys.executable, "-m", "mpi_knn_tpu_torch", "lint", "--device", "cpu",
         "--backend", "ivf", "--mutate", "delete", "-q", "--out", str(rules)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert json.loads((rules / "report.json").read_text())["ok"]
    bad = subprocess.run([sys.executable, "-m", "mpi_knn_tpu_torch", "lint",
                          "--cache-dir", str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and "--cache-dir" in bad.stderr


def test_committed_report_is_the_sweep():
    """``artifacts/lint/torch/host_report.json`` is what the sweep writes
    now (the JAX package's own report beside it is another file)."""
    committed = json.loads(
        (REPO / "artifacts" / "lint" / "torch" / "host_report.json")
        .read_text())
    assert committed == run_host_lint().to_json()
    ref = json.loads((REPO / "artifacts" / "lint" / "host_report.json")
                     .read_text())
    assert ref["source"] == "mpi_knn_tpu.analysis.host"


def test_report_shape_and_save(tmp_path):
    rep = run_host_lint()
    doc = json.loads(rep.save(tmp_path).read_text())
    assert doc["schema_version"] == 1
    assert doc["source"] == "mpi_knn_tpu_torch.analysis.host"
    assert set(doc["rules"]) == {
        "H1-lock-discipline", "H2-lock-order", "H3-confinement",
        "H4-atomic-publish",
    }
    assert doc["summary"]["targets"] == 9
    assert doc["summary"]["classes_checked"] >= 15
    s = doc["summary"]
    assert s["lock_graph_acyclic"] and s["findings"] == 0


@pytest.mark.parametrize("rule", [
    "H1-lock-discipline", "H2-lock-order", "H3-confinement",
    "H4-atomic-publish",
])
def test_each_rule_runs_clean_alone_on_production(rule):
    rep = run_host_lint(rule_names=[rule])
    assert rep.ok, [f.to_json() for f in rep.findings]


# ---------------------------------------------------------------------------
# the races the sweep found in the port, re-injected into a copy


# (module key, what the repair wrote, the racy original, the finding's attr)
REPAIRS = [
    ("serve.engine",
     '''               if self.index.backend == "ivf-sharded" else {}),''',
     '''               if self.exchange is not None else {}),''',
     "serve.engine.ServeSession.exchange"),
    ("serve.engine",
     '''    global MISSES
    with _LOCK_MUTEX:
        MISSES = 0
''',
     '''    global MISSES
    MISSES = 0
''',
     "serve.engine:MISSES"),
]


@pytest.mark.parametrize("module,repaired,racy,attr", REPAIRS,
                         ids=[r[3] for r in REPAIRS])
def test_sweep_catches_the_repaired_races_reinjected(tmp_path, module,
                                                      repaired, racy, attr):
    src_path = PORT / (module.replace(".", "/") + ".py")
    src = src_path.read_text()
    assert src.count(repaired) == 1
    broken = tmp_path / src_path.name
    broken.write_text(src.replace(repaired, racy))
    targets = [
        HostTarget(t.name, tuple((m, str(broken) if m == module else p)
                                 for m, p in t.modules))
        for t in default_targets()
    ]
    rep = run_host_lint(targets)
    assert [f.attr for f in rep.findings] == [attr]
    assert rep.findings[0].rule == "H1-lock-discipline"
    assert not rep.ok and not rep.problems


# ---------------------------------------------------------------------------
# the port's rules for locks handed out by functions

FACTORY = """
    import threading

    _MUTEX = threading.Lock()

    def mutation_lock(index):
        with _MUTEX:
            return index.setdefault("lock", threading.RLock())

    def key_lock(index):
        with _MUTEX:
            return index.setdefault("key", threading.Lock())

    def order_stream(index):
        index["stream"] = 1

    def dispatch(index):
        with mutation_lock(index):
            order_stream(index)
            {dispatch_body}

    def mutate(index):
        with mutation_lock(index):
            _scatter(index)
            {mutate_body}

    def _scatter(index):
        order_stream(index)

    def warm(index):
        with key_lock(index):
            {warm_body}

    def start(index):
        threading.Thread(target=dispatch, args=(index,)).start()
        threading.Thread(target=mutate, args=(index,)).start()
        threading.Thread(target=warm, args=(index,)).start()
"""


def _factory_guards(module: str) -> GuardMap:
    g = GuardMap()
    g.lock_factories = {f"{module}.mutation_lock": f"{module}:mutation_lock",
                        f"{module}.key_lock": f"{module}:key_lock"}
    g.reentrant = {f"{module}:mutation_lock"}
    g.call_guards = {f"{module}.order_stream": f"{module}:mutation_lock"}
    return g


def _factory(tmp_path, name, dispatch="pass", mutate="pass", warm="pass"):
    return _target(tmp_path, name, FACTORY.format(
        dispatch_body=dispatch, mutate_body=mutate, warm_body=warm))


def test_factory_locks_enter_the_lock_graph_and_the_call_guard_holds(
        tmp_path):
    """``with mutation_lock(index):`` is a lock: an order_stream called
    under it (lexically, or in a helper every caller enters holding it)
    passes; a nested re-entrant acquisition is no self-deadlock."""
    t = _factory(tmp_path, "fx1", mutate="with mutation_lock(index): pass")
    rep = run_host_lint([t], guards=_factory_guards("fx1"))
    assert rep.ok, [f.to_json() for f in rep.findings] + rep.problems
    assert "fx1:mutation_lock" in rep.lock_graph.nodes
    # the inner acquisition calls the factory, which may take its mutex,
    # while the lock is held
    assert set(rep.lock_graph.edges) == {("fx1:mutation_lock", "fx1:_MUTEX")}


def test_order_stream_without_the_mutation_lock_fires(tmp_path):
    t = _factory(tmp_path, "fx2", warm="order_stream(index)")
    rep = run_host_lint([t], guards=_factory_guards("fx2"))
    f = _findings(rep, "H1-lock-discipline")
    assert len(f) == 1 and f[0].where == "fx2.warm"
    assert f[0].attr == "fx2.order_stream"
    assert "fx2:mutation_lock" in f[0].message


def test_dispatch_against_warm_lock_inversion_fires(tmp_path):
    """A dispatch taking the entry lock under the mutation lock and a warm
    taking the mutation lock under the entry lock: a cycle through
    handed-out locks."""
    t = _factory(tmp_path, "fx3", dispatch="with key_lock(index): pass",
                 warm="with mutation_lock(index): pass")
    rep = run_host_lint([t], guards=_factory_guards("fx3"))
    f = _findings(rep, "H2-lock-order")
    assert any("cycle" in x.message for x in f)
    assert rep.lock_graph.cycles == [["fx3:key_lock", "fx3:mutation_lock"]]


def test_reacquiring_a_non_reentrant_factory_lock_fires(tmp_path):
    t = _factory(tmp_path, "fx4", warm="with key_lock(index): pass")
    rep = run_host_lint([t], guards=_factory_guards("fx4"))
    f = _findings(rep, "H2-lock-order")
    assert len(f) == 1 and "self-deadlock" in f[0].message
    assert f[0].attr == "fx4:key_lock"


def test_stale_factory_call_guard_and_class_entry_are_problems(tmp_path):
    t = _factory(tmp_path, "fx5")
    g = _factory_guards("fx5")
    g.lock_factories["fx5.gone_lock"] = "fx5:gone"
    g.call_guards["fx5.gone_stream"] = "fx5:mutation_lock"
    g.classes["fx5.Gone"] = ClassGuard(guarded={"x": "_lock"})
    rep = run_host_lint([t], guards=g)
    assert not rep.ok and len(rep.problems) == 3
    joined = " ".join(rep.problems)
    assert "fx5.gone_lock" in joined and "fx5.gone_stream" in joined
    assert "fx5.Gone" in joined


def test_stale_attribute_of_a_production_class_is_a_problem():
    g = default_guards()
    g.classes["obs.metrics.Counter"].guarded["_counts"] = "_lock"
    rep = run_host_lint(guards=g)
    assert not rep.ok
    assert rep.problems == [
        "guard map entry obs.metrics.Counter._counts names an attribute "
        "the scanned source never touches (stale guard map?)"]


# ---------------------------------------------------------------------------
# runtime witnesses (armed in tests only)


def test_witness_observes_lock_order_inversion():
    log = WitnessLog()
    a = InstrumentedLock("A", log)
    b = InstrumentedLock("B", log)

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    assert log.inversions() == {("A", "B")}
    assert {("A", "B"), ("B", "A")} <= log.ordered_pairs()


def test_witness_observes_guard_violation():
    log = WitnessLog()
    lock = InstrumentedLock("W._lock", log)
    state = {"count": 0}

    def guarded():
        with lock:
            state["count"] += 1
            log.note_access("W.count", "write")

    def unguarded():
        state["count"] += 1
        log.note_access("W.count", "write")

    for fn in (guarded, unguarded):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    bad = log.guard_violations({"W.count": "W._lock"})
    assert len(bad) == 1 and bad[0].held == ()


def test_witness_instruments_production_registry():
    """instrument() swaps the port's MetricsRegistry lock for the recording
    wrapper: the get-or-create path and the snapshot show the acquisition,
    and no ordering against a metric's own lock is observed."""
    from mpi_knn_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    log = WitnessLog()
    with instrument(reg, log, "_lock", prefix="obs."):
        c = reg.counter("witness_total", help="x")
        c.inc()
        reg.snapshot()
    names = [ev.lock for ev in log.acquires]
    assert names.count("obs.MetricsRegistry._lock") >= 2
    assert log.inversions() == set()


def test_witness_orders_dispatch_and_mutation_on_one_index():
    """The runtime twin of the declared contract: a dispatch-shaped and a
    mutation-shaped critical section on one index, each under the
    instrumented mutation lock with the entry mutex inside it, never
    invert."""
    from mpi_knn_tpu_torch.serve import engine

    log = WitnessLog()
    index = type("I", (), {})()
    lk = InstrumentedLock("mutation_lock", log, lock=engine.mutation_lock(index))
    mutex = InstrumentedLock("_LOCK_MUTEX", log)

    def section():
        with lk:
            with lk:  # re-entrant: a mutation deriving its freelist
                with mutex:
                    pass

    threads = [threading.Thread(target=section) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert log.inversions() == set()
    assert ("mutation_lock", "_LOCK_MUTEX") in log.ordered_pairs()
    assert engine.mutation_lock(index) is engine.mutation_lock(index)


# ---------------------------------------------------------------------------
# the port's thread-safe primitives the map relies on


def test_histogram_snapshot_consistent_under_concurrent_observe():
    from mpi_knn_tpu_torch.obs.metrics import Histogram

    h = Histogram("lat", buckets=(0.1, 1.0, 10.0))
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            h.observe((i % 40) * 0.3)
            i += 1

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for _ in range(300):
            snap = h.snapshot()
            assert sum(snap["counts"]) == snap["count"]
    finally:
        stop.set()
        t.join()
    assert h.count == sum(h.snapshot()["counts"])


def test_counter_snapshot_takes_lock():
    from mpi_knn_tpu_torch.obs.metrics import Counter, Gauge

    c = Counter("c_total")
    c.inc(2.5)
    assert c.snapshot()["value"] == 2.5 and c.value == 2.5
    g = Gauge("g")
    g.set(4.0)
    g.add(-1.0)
    assert g.snapshot()["value"] == 3.0


def test_get_recorder_returns_one_instance_across_threads(tmp_path,
                                                          monkeypatch):
    from mpi_knn_tpu_torch.obs import spans

    monkeypatch.setenv(spans.RECORDER_ENV, str(tmp_path / "fl.jsonl"))
    monkeypatch.setattr(spans, "_env_recorder", None)
    monkeypatch.setattr(spans, "_recorder", None)
    got = []
    barrier = threading.Barrier(8)

    def grab():
        barrier.wait()
        got.append(spans.get_recorder())

    threads = [threading.Thread(target=grab) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({id(r) for r in got}) == 1 and got[0] is not None


def test_warm_and_stats_snapshots_are_consistent_copies():
    from mpi_knn_tpu_torch.config import KNNConfig
    from mpi_knn_tpu_torch.serve import ServeSession, build_index

    X = np.random.default_rng(0).standard_normal((192, 16)).astype(np.float32)
    cfg = KNNConfig(k=3, backend="serial", query_bucket=16, corpus_tile=64,
                    query_tile=32)
    sess = ServeSession(build_index(X, cfg, device="cpu"), device="cpu")
    sess.warm([16])
    ws = sess.warm_snapshot()
    assert ws["done"] is True and ws["total"] >= 1
    ws["ready"] = -99
    assert sess.warm_snapshot()["ready"] != -99
    list(sess.stream([X[:8], X[:12]]))
    st = sess.stats_snapshot()
    assert st["batches_retired"] == 2
    assert st["queries_served"] == 20
    assert st["rung"] == sess.rung
    st["tenants"].append("ghost")
    assert sess.stats_snapshot()["tenants"] == []


def test_atomic_write_publishes_whole_content(tmp_path):
    from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

    path = tmp_path / "ready"
    docs = [f"url-{i}" * 200 + "\n" for i in range(50)]
    seen = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                seen.append(path.read_text())
            except OSError:
                pass

    t = threading.Thread(target=reader)
    t.start()
    try:
        for d in docs:
            atomic_write_text(path, d)
    finally:
        stop.set()
        t.join()
    assert path.read_text() == docs[-1]
    assert all(s in docs for s in seen if s)
    assert [p.name for p in tmp_path.iterdir()] == ["ready"]


def test_heartbeat_still_atomic_via_shared_helper(tmp_path):
    from mpi_knn_tpu_torch.resilience.heartbeat import HeartbeatWriter, read_beat

    w = HeartbeatWriter(str(tmp_path / "beat.json"))
    assert w.beat("a") == 1
    assert w.beat("b") == 2
    doc = read_beat(str(tmp_path / "beat.json"))
    assert doc is not None and doc["seq"] == 2 and doc["label"] == "b"
