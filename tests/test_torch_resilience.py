"""The port's resilience layer (``mpi_knn_tpu_torch/resilience/``) and the
serving session under a policy, against the JAX package's
``mpi_knn_tpu.resilience`` and its ``ServeSession`` on the CPU.

- heartbeats, fault specs (``TKNN_FAULTS``), the backoff schedule and the
  policy's validation equal the reference's; ``poison_topk`` writes NaN
  into element [0, 0] of a tensor in place;
- ``build_ladder`` gives the reference's labels on the serial, pallas
  (exact build, ``mixed`` included) and clustered layouts;
- a resilient session beside the reference's with the same faults armed:
  equal attempts, backoffs, degraded rungs, breaches and rung walks; ids
  equal up to ties, distances allclose in f32; every rung's batch bit for
  bit a session built at that rung's config;
- a CUDA-like error is not retried, and a failed attempt gives its slot
  back; the sentinel names the batch; ``warm`` builds every rung;
- the worker runner (ok, hang killed by beat starvation, wall timeout,
  crash with the tail of stderr) and the doctor (healthy on the CPU, the
  injected hang, a supervisor that never imports torch);
- the query CLI under a policy, its refusals as the reference's.

Subprocess children import no torch where they need none (the worker's
``-c`` scripts); the doctor's probe child does.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from mpi_knn_tpu import KNNConfig as JaxConfig
from mpi_knn_tpu import build_index as jbuild_index
from mpi_knn_tpu import resilience as jres
from mpi_knn_tpu.ivf import build_ivf_index as jbuild_ivf
from mpi_knn_tpu.serve import ServeSession as JaxSession
from mpi_knn_tpu.serve import cli as jax_serve_cli
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch import resilience as pres
from mpi_knn_tpu_torch.ivf import build_ivf_index
from mpi_knn_tpu_torch.obs import spans as ps
from mpi_knn_tpu_torch.obs.metrics import get_registry, watch_compiles
from mpi_knn_tpu_torch.ops import fused_knn
from mpi_knn_tpu_torch.resilience.faults import parse_fault_env
from mpi_knn_tpu_torch.resilience.ladder import FULL_RUNG
from mpi_knn_tpu_torch.resilience.worker import python_worker_argv
from mpi_knn_tpu_torch.serve import ServeSession, build_index
from mpi_knn_tpu_torch.serve import cli as serve_cli
from mpi_knn_tpu_torch.serve import engine
from tests.oracle import oracle_all_knn, recall_against_oracle

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _kw(**kw):
    kw.setdefault("k", 4)
    kw.setdefault("query_tile", 16)
    kw.setdefault("corpus_tile", 32)
    kw.setdefault("query_bucket", 32)
    kw.setdefault("dispatch_depth", 1)
    kw.setdefault("backend", "serial")
    return kw


def _pair(X, ivf=False, **kw):
    """The reference's index and the port's from the same data and config."""
    if ivf:
        kw = {"partitions": 4, "nprobe": 4, **kw}
        return (jbuild_ivf(X, JaxConfig(**_kw(**kw))),
                build_ivf_index(X, KNNConfig(**_kw(**kw)), device=CPU))
    return (jbuild_index(X, JaxConfig(**_kw(**kw))),
            build_index(X, KNNConfig(**_kw(**kw)), device=CPU))


def _blobs(seed, m=256, d=16):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((4, d)).astype(np.float32) * 6
    return (cents[rng.integers(0, 4, m)]
            + rng.standard_normal((m, d))).astype(np.float32)


def _armed(faults):
    """Both packages' faults armed from one spec."""
    class _Both:
        def __enter__(self):
            self.j = jres.install_faults(faults).__enter__()
            self.p = pres.install_faults(faults).__enter__()

        def __exit__(self, *exc):
            self.p.__exit__(*exc)
            self.j.__exit__(*exc)
    return _Both()


# ---------------------------------------------------------------------------
# heartbeats, faults, retry: the reference's contracts


def test_heartbeat_roundtrip_missing_and_torn(tmp_path, monkeypatch):
    p = str(tmp_path / "beat.json")
    w = pres.HeartbeatWriter(p)
    assert (w.beat("first"), w.beat("second")) == (1, 2)
    assert pres.read_beat(p) == jres.read_beat(p)
    assert pres.read_beat(p)["label"] == "second"
    torn = tmp_path / "torn.json"
    torn.write_text('{"seq": 1, "lab')
    assert pres.read_beat(str(torn)) is None
    assert pres.read_beat(str(tmp_path / "never.json")) is None
    monkeypatch.delenv(pres.HEARTBEAT_ENV, raising=False)
    assert pres.maybe_beat("anything") is None
    monkeypatch.setenv(pres.HEARTBEAT_ENV, p)
    a = pres.maybe_beat("a")
    assert pres.maybe_beat("b") == a + 1 and jres.read_beat(p)["label"] == "b"


@pytest.mark.parametrize("spec", [
    "bench-series=hang, serve-batch=transient:2,serve-nan=nan",
    "serve-batch=slow:0.25", "doctor-probe=hang:3", "",
])
def test_fault_specs_parse_as_the_reference(spec):
    from mpi_knn_tpu.resilience.faults import parse_fault_env as jparse

    got, want = parse_fault_env(spec), jparse(spec)
    assert {k: (v.site, v.kind, v.arg) for k, v in got.items()} == \
        {k: (v.site, v.kind, v.arg) for k, v in want.items()}


@pytest.mark.parametrize("bad", ["serve-batch", "serve-batch=explode", "=hang",
                                 "x=slow:y", "a=transient:two"])
def test_malformed_fault_specs_raise_in_both(bad):
    from mpi_knn_tpu.resilience.faults import parse_fault_env as jparse

    for parse in (parse_fault_env, jparse):
        with pytest.raises(ValueError):
            parse(bad)


def test_fault_kinds_act_as_in_the_reference(monkeypatch):
    with pres.install_faults({"site-a": ("transient", 2), "s": ("slow", 0.05)}):
        for _ in range(2):
            with pytest.raises(pres.TransientFault):
                pres.fault_point("site-a")
        pres.fault_point("site-a")
        pres.fault_point("other-site")
        t0 = time.perf_counter()
        pres.fault_point("s")
        assert time.perf_counter() - t0 >= 0.05
    pres.fault_point("site-a")  # disarmed on exit
    monkeypatch.setenv("TKNN_FAULTS", "env-site=transient:1")
    pres.reset_fault_state()
    with pytest.raises(pres.TransientFault):
        pres.fault_point("env-site")
    pres.fault_point("env-site")
    pres.reset_fault_state()


def test_poison_topk_writes_nan_in_place_only_when_armed():
    d = torch.ones((4, 3))
    assert pres.poison_topk(d) is d and not torch.isnan(d).any()
    with pres.install_faults({"serve-nan": "nan"}):
        out = pres.poison_topk(d)
    assert out is d and torch.isnan(d[0, 0])
    assert not torch.isnan(d.flatten()[1:]).any()


@pytest.mark.parametrize("retries,base,cap", [(5, 0.05, 0.2), (0, 0.05, 0.2),
                                              (3, 0.3, 2.0), (8, 0.01, 1.0)])
def test_backoff_schedule_equals_the_reference(retries, base, cap):
    assert pres.backoff_schedule(retries, base, cap) == \
        jres.backoff_schedule(retries, base, cap)


def test_retry_story_and_propagation():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise pres.TransientFault("injected")
        return "payload"

    slept = []
    out = pres.retry_with_backoff(flaky, retries=3, base_s=0.05, sleep=slept.append)
    assert (out.value, out.attempts, out.backoffs) == ("payload", 3, (0.05, 0.1))
    assert tuple(slept) == (0.05, 0.1)

    def cuda_error():  # an illegal address poisons the context: never retried
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    calls["n"] = 0
    with pytest.raises(RuntimeError, match="illegal"):
        pres.retry_with_backoff(cuda_error, retries=5, sleep=lambda s: None)

    def always():
        raise pres.TransientFault("never recovers")

    with pytest.raises(pres.RetryExhausted) as e:
        pres.retry_with_backoff(always, retries=1, sleep=lambda s: None)
    assert e.value.attempts == 2 and isinstance(e.value.__cause__, pres.TransientFault)


@pytest.mark.parametrize("bad", [dict(max_retries=-1), dict(degrade_after=0),
                                 dict(batch_deadline_s=-1.0), dict(min_bucket=0)])
def test_policy_validation_equals_the_reference(bad):
    for mod in (jres, pres):
        with pytest.raises(ValueError):
            mod.ResiliencePolicy(**bad)
    assert pres.ResiliencePolicy().retryable == (pres.TransientFault,)


# ---------------------------------------------------------------------------
# the ladder


@pytest.mark.parametrize("layout,kw", [
    ("serial", {}),
    ("serial-bf16", dict(dtype="bfloat16", query_bucket=16)),
    ("serial-floor", dict(query_bucket=16)),
    ("pallas", dict(backend="pallas")),
    ("pallas-mixed", dict(backend="pallas", precision_policy="mixed")),
    ("ivf", dict(ivf=True, query_bucket=16)),
    ("ivf-nprobe3", dict(ivf=True, nprobe=3)),
])
@pytest.mark.parametrize("min_bucket", [8, 16])
def test_build_ladder_labels_equal_the_reference(layout, kw, min_bucket):
    j, p = _pair(_blobs(3), **kw)
    jl = jres.build_ladder(j, j.compatible_cfg(j.cfg),
                           jres.ResiliencePolicy(min_bucket=min_bucket))
    pl = pres.build_ladder(p, p.compatible_cfg(p.cfg),
                           pres.ResiliencePolicy(min_bucket=min_bucket))
    assert [label for label, _ in pl] == [label for label, _ in jl]
    for (_, pc), (_, jc) in zip(pl, jl):
        assert (pc.precision_policy, pc.query_bucket, pc.nprobe) == \
            (jc.precision_policy, jc.query_bucket, jc.nprobe)


def test_an_exact_pallas_index_on_a_card_keeps_the_mixed_rung():
    """On a card a pallas index stages only its build config's corpus part;
    the ladder validates rungs as staged (``stageable_cfg``), so ``mixed``
    stays while ``compatible_cfg`` alone would refuse it, and a session
    stages it before traffic (``stage_for``)."""
    p = build_index(_blobs(3), KNNConfig(**_kw(backend="pallas")), device=CPU)
    part = torch.zeros(1)
    p.staged = fused_knn.StagedCorpus(exact=(part, part, part))  # as on a card
    mixed = p.cfg.replace(precision_policy="mixed")
    with pytest.raises(ValueError, match="did not stage"):
        p.compatible_cfg(mixed)
    assert p.stageable_cfg(mixed) == mixed
    labels = [lb for lb, _ in pres.build_ladder(p, p.cfg, pres.ResiliencePolicy())]
    assert labels == [FULL_RUNG, "mixed", "bucket/16"]


# ---------------------------------------------------------------------------
# the session under a policy, beside the reference's


def _check_rows(got, want, X, Q, k):
    """Ids equal up to ties (as recall against the f64 oracle); distances
    allclose in f32: the two frameworks sum in different orders, so the
    bound is f32's rounding of q^2 + c^2."""
    od, oi = oracle_all_knn(X, k, queries=Q)
    assert recall_against_oracle(got.ids, od, oi, k) == \
        recall_against_oracle(want.ids, od, oi, k)
    scale = 2 * max((X ** 2).sum(1).max(), (Q ** 2).sum(1).max())
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                               atol=1e-6 * scale)


def test_transient_retry_equals_the_reference(rng):
    X = rng.standard_normal((128, 16)).astype(np.float32)
    Q = rng.standard_normal((8, 16)).astype(np.float32)
    j, p = _pair(X)
    clean = ServeSession(p, device=CPU).submit(Q)[0]
    pol = dict(max_retries=3, backoff_base_s=0.01)
    js = JaxSession(j, resilience=jres.ResiliencePolicy(**pol))
    ses = ServeSession(p, resilience=pres.ResiliencePolicy(**pol), device=CPU)
    with _armed({"serve-batch": ("transient", 2)}):
        want = js.submit(Q)[0]
        got = ses.submit(Q)[0]
    assert (got.attempts, got.backoffs) == (want.retries + 1, want.backoffs)
    assert (got.attempts, got.backoffs, ses.retries_total) == (3, (0.01, 0.02), 2)
    assert ses.stats_snapshot()["retries_total"] == js.retries_total == 2
    _check_rows(got, want, X, Q, 4)
    assert np.array_equal(got.ids, clean.ids) and \
        np.array_equal(got.dists, clean.dists)


@pytest.mark.parametrize("ivf", [False, True])
def test_rung_walk_equals_the_reference(ivf):
    """Injected slow batches walk both ladders the same way: the same
    degraded rungs, breaches and degradations; ids equal up to ties at
    every rung of the dense index. The port's k-means cannot draw JAX's
    initial centroids, so a clustered index's partitions differ: its
    ``nprobe`` rungs are held to the index's own ``recall_target``."""
    X = _blobs(7)
    Q = X[:16] + np.random.default_rng(1).normal(scale=0.5, size=(16, 16)).astype(
        np.float32)
    j, p = _pair(X, ivf=ivf, query_bucket=32)
    pol = dict(batch_deadline_s=0.01, degrade_after=1, max_retries=0, min_bucket=16)
    js = JaxSession(j, resilience=jres.ResiliencePolicy(**pol))
    ses = ServeSession(p, resilience=pres.ResiliencePolicy(**pol), device=CPU)
    assert [lb for lb, _ in ses.ladder] == [lb for lb, _ in js.ladder]
    js.warm([16])
    ses.warm([16])
    got, want = [], []
    with _armed({"serve-batch": ("slow", 0.02)}):
        for _ in range(len(ses.ladder) + 1):
            want += js.submit(Q)
            got += ses.submit(Q)
    assert [(b.degraded, b.deadline_breached, b.bucket) for b in got] == \
        [(b.degraded, b.deadline_breached, b.bucket) for b in want]
    assert ses.degradations == js.degradations
    assert ses.rung == js.rung == ses.ladder[-1][0]
    assert ses.deadline_breaches == js.deadline_breaches == len(got)
    od, oi = oracle_all_knn(X, 4, queries=Q)
    for g, w in zip(got, want):
        if ivf and g.degraded is not None:
            assert recall_against_oracle(g.ids, od, oi, 4) >= p.cfg.recall_target
        else:
            _check_rows(g, w, X, Q, 4)


def test_each_rung_serves_what_a_session_at_its_config_serves(rng):
    X = rng.standard_normal((192, 16)).astype(np.float32)
    Q = rng.standard_normal((16, 16)).astype(np.float32)
    p = build_index(X, KNNConfig(**_kw(query_bucket=32)), device=CPU)
    ses = ServeSession(p, resilience=pres.ResiliencePolicy(min_bucket=16),
                       device=CPU)
    assert [lb for lb, _ in ses.ladder] == [FULL_RUNG, "mixed", "bucket/16"]
    for i, (label, cfg) in enumerate(ses.ladder):
        if i:
            assert ses.shed_rung(reason="test") == label
        got = ses.submit(Q)[0]
        want = ServeSession(p, cfg, device=CPU).submit(Q)[0]
        assert got.degraded == (None if label == FULL_RUNG else label)
        assert np.array_equal(got.ids, want.ids)
        assert np.array_equal(got.dists, want.dists)
    assert ses.shed_rung() is None  # the floor
    assert ses.restore_rung() == "mixed" and ses.rung == "mixed"
    assert get_registry().gauge("serve_ladder_rung").value == 1
    assert ses.restorations == [{"rung": "mixed", "reason": "recovered"}]


def test_sentinel_names_the_batch_and_counts_it(rng):
    idx = build_index(rng.standard_normal((128, 16)).astype(np.float32),
                      KNNConfig(**_kw()), device=CPU)
    ses = ServeSession(idx, resilience=pres.ResiliencePolicy(max_retries=0),
                       device=CPU)
    n0 = get_registry().counter("serve_poisoned_results_total").value
    with pres.install_faults({"serve-nan": "nan"}):
        with pytest.raises(pres.PoisonedResultError) as e:
            ses.submit(np.ones((8, 16), np.float32))
    assert (e.value.batch_seq, e.value.bucket, e.value.rows, e.value.rung) == \
        (0, 32, 8, FULL_RUNG)
    assert get_registry().counter("serve_poisoned_results_total").value == n0 + 1
    # an all-inf row trips it too
    res = engine.BatchResult(None, None, 2, 32, seq=5,
                             dists=np.array([[1.0, 2.0], [np.inf, np.inf]]))
    with pytest.raises(pres.PoisonedResultError, match="all-inf row"):
        ses._check_sentinel(res)


def test_without_a_policy_the_session_keeps_its_shape(rng):
    idx = build_index(rng.standard_normal((128, 16)).astype(np.float32),
                      KNNConfig(**_kw()), device=CPU)
    ses = ServeSession(idx, device=CPU)
    assert ses.rung == FULL_RUNG and len(ses.ladder) == 1 and ses.staged_bytes == 0
    with pres.install_faults({"serve-batch": ("slow", 0.02)}):
        res = ses.submit(np.ones((4, 16), np.float32))[0]
    assert (res.degraded, res.attempts, res.retries, res.backoffs,
            res.deadline_breached) == (None, 1, 0, (), False)
    assert ses.degradations == []


def test_a_cuda_error_is_not_retried_and_the_slot_comes_back(rng, monkeypatch):
    idx = build_index(rng.standard_normal((128, 16)).astype(np.float32),
                      KNNConfig(**_kw()), device=CPU)
    ses = ServeSession(idx, resilience=pres.ResiliencePolicy(max_retries=3),
                       device=CPU)
    ses.warm([8])
    exec_ = next(iter(idx._cache.values()))
    free0 = len(exec_.free)
    calls = []

    def illegal(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(engine, "_dispatch", illegal)
    with pytest.raises(RuntimeError, match="illegal"):
        ses.submit(np.ones((8, 16), np.float32))
    assert len(calls) == 1 and len(exec_.free) == free0
    monkeypatch.undo()
    with pres.install_faults({"serve-batch": ("transient", 2)}):
        ses.submit(np.ones((8, 16), np.float32))
    assert len(exec_.free) == free0 and exec_.slots == free0


def test_backoff_is_excluded_from_the_deadline(rng):
    idx = build_index(rng.standard_normal((128, 16)).astype(np.float32),
                      KNNConfig(**_kw()), device=CPU)
    ses = ServeSession(idx, resilience=pres.ResiliencePolicy(
        batch_deadline_s=0.15, degrade_after=1, max_retries=2,
        backoff_base_s=0.3), device=CPU)
    Q = np.ones((8, 16), np.float32)
    ses.submit(Q)
    with pres.install_faults({"serve-batch": ("transient", 1)}):
        res = ses.submit(Q)[0]
    assert res.retries == 1 and res.backoffs == (0.3,) and res.latency_s > 0.3
    assert not res.deadline_breached and ses.degradations == []


def test_warm_builds_every_rung_and_the_walk_builds_nothing(rng):
    idx = build_index(rng.standard_normal((128, 16)).astype(np.float32),
                      KNNConfig(**_kw()), device=CPU)
    ses = ServeSession(idx, resilience=pres.ResiliencePolicy(
        batch_deadline_s=0.01, degrade_after=1, max_retries=0, min_bucket=16),
        device=CPU)
    ses.warm([16])
    with watch_compiles() as builds:
        with pres.install_faults({"serve-batch": ("slow", 0.02)}):
            for _ in range(len(ses.ladder) + 1):
                ses.submit(np.ones((16, 16), np.float32))
    assert ses.rung == ses.ladder[-1][0] and builds == []


# ---------------------------------------------------------------------------
# the worker runner and the doctor

_CHILD_OK = textwrap.dedent("""
    import sys
    from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat
    maybe_beat("working")
    print("payload-line", "torch" in sys.modules)
""")

_CHILD_HANG = textwrap.dedent("""
    from mpi_knn_tpu_torch.resilience.faults import fault_point
    from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat
    maybe_beat("pre-hang")
    fault_point("test-hang")
""")

_CHILD_SPIN = textwrap.dedent("""
    import time
    from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat
    while True:
        maybe_beat("spin")
        time.sleep(0.05)
""")


def test_worker_results():
    res = pres.run_supervised(python_worker_argv("-c", _CHILD_OK), cwd=REPO,
                              beat_timeout_s=60)
    assert res.ok and res.returncode == 0 and res.reason is None
    assert "payload-line False" in res.stdout  # the child imported no torch
    assert res.beats == 1 and res.last_beat_label == "working"

    t0 = time.monotonic()
    res = pres.run_supervised(
        python_worker_argv("-c", _CHILD_HANG), cwd=REPO,
        env=dict(os.environ, TKNN_FAULTS="test-hang=hang"),
        beat_timeout_s=1.0, wall_timeout_s=120)
    assert res.status == "timeout" and "beat starvation" in res.reason
    assert res.beats == 1 and res.last_beat_label == "pre-hang"
    assert time.monotonic() - t0 < 60

    res = pres.run_supervised(python_worker_argv("-c", _CHILD_SPIN), cwd=REPO,
                              beat_timeout_s=30, wall_timeout_s=1.0)
    assert res.status == "timeout" and "wall timeout" in res.reason
    assert res.beats >= 1

    code = "import sys; sys.stderr.write('boom-detail\\n'); sys.exit(3)"
    res = pres.run_supervised(python_worker_argv("-c", code), cwd=REPO)
    assert res.status == "crashed" and res.returncode == 3
    assert "boom-detail" in res.stderr_tail


def test_doctor_healthy_on_the_cpu():
    from mpi_knn_tpu_torch.resilience.doctor import run_probe

    env = {k: v for k, v in os.environ.items() if k != "TKNN_FAULTS"}
    v = run_probe(platform="cpu", env=env)
    assert v["ok"] is True and v["status"] == "ok", v
    assert v["probe"]["platform"] == "cpu" and v["probe"]["agrees_with_plain"]
    assert v["mutation"]["ok"] and v["mutation"]["second_pass_builds"] == 0
    # the memory line: on the CPU the recorded peak against the model
    mem = v["memory"]
    assert mem["ok"] and mem["measured_bytes"] is None
    assert mem["band"][0] <= mem["trace_peak_bytes"] <= mem["band"][1]
    assert mem["model_bytes"] > 0
    assert v["aot_cache"] is None and v["beats"] >= 5
    snap = v["metrics"]["metrics"]
    assert snap["doctor_kernel_launches_total"]["value"] == 0  # the plain version
    assert snap["doctor_probe_seconds"]["count"] == 1


def test_doctor_cli_hang_and_a_supervisor_without_torch(tmp_path):
    env = dict(os.environ, TKNN_FAULTS="doctor-probe=hang")
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "mpi_knn_tpu_torch", "doctor",
                        "--platform", "cpu", "--timeout", "1", "--report",
                        str(tmp_path / "v.json")],
                       capture_output=True, text=True, cwd=REPO, timeout=120,
                       env=env)
    assert r.returncode == 1, r.stderr[-2000:]
    v = json.loads(r.stdout.strip().splitlines()[-1])
    assert v["ok"] is False and v["status"] == "timeout" and v["probe"] is None
    assert "beat starvation" in v["reason"]
    assert json.loads((tmp_path / "v.json").read_text()) == v
    assert time.monotonic() - t0 < 60
    # the supervisor imports no torch (so it never initializes the card)
    probe = ("import sys; from mpi_knn_tpu_torch.resilience.doctor import main; "
             "rc = main(['--platform', 'cpu', '--timeout', '1']); "
             "print('torch' in sys.modules, rc)")
    r = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                       text=True, cwd=REPO, timeout=120, env=env)
    assert r.stdout.strip().splitlines()[-1] == "False 1"


# ---------------------------------------------------------------------------
# the query CLI under a policy


@pytest.mark.parametrize("extra", [["--degrade-after", "5"], ["--no-nan-sentinel"],
                                   ["--retries", "2", "--degrade-after", "3"],
                                   ["--batch-deadline-ms", "-1"],
                                   ["--retries", "-1"]])
def test_cli_refuses_inert_or_invalid_resilience_knobs(extra, capsys):
    argv = ["--data", "synthetic:64x8c4", "--synthetic", "8", *extra]
    assert serve_cli.main([*argv, "--device", CPU]) == 2
    got = capsys.readouterr().err
    assert jax_serve_cli.main(argv) == 2
    want = capsys.readouterr().err
    assert ("silently inert" in got) == ("silently inert" in want)


def test_cli_serves_under_a_policy_with_a_flight_record_and_metrics(tmp_path,
                                                                     capsys):
    from mpi_knn_tpu.obs.metrics import load_snapshot as jload
    from mpi_knn_tpu.obs.spans import read_flight as jread
    from mpi_knn_tpu.obs.spans import validate_flight as jvalidate

    flight, metrics, report = (str(tmp_path / n) for n in
                               ("f.jsonl", "m.json", "r.json"))
    argv = ["--data", "synthetic:512x32c4", "--synthetic", "100", "--backend",
            "pallas", "--device", CPU, "--batch-deadline-ms", "50000",
            "--retries", "2", "--flight-record", flight, "--metrics-out",
            metrics, "--report", report, "--batch", "40"]
    try:
        with pres.install_faults({"serve-batch": ("transient", 1)}):
            assert serve_cli.main(argv) == 0
    finally:
        ps.set_recorder(None)
    out = capsys.readouterr().out
    assert "batch 0: rows=40 bucket=1024" in out and "retries=1" in out
    doc = json.loads(open(report).read())
    assert doc["resilience"]["ladder"] == [FULL_RUNG, "mixed", "bucket/512"]
    assert doc["resilience"]["retries_total"] == 1
    assert doc["resilience"]["final_rung"] == FULL_RUNG
    assert jvalidate(jread(flight)) == [] and ps.validate_flight(ps.read_flight(flight)) == []
    snap = jload(metrics)
    assert snap["metrics"]["serve_batches_total"]["value"] >= 3
