"""Pods of OS processes through the port's ``torch.distributed`` start-up
(``mpi_knn_tpu_torch/parallel/distributed.py``), the counterpart of the
reference's ``tests/test_multihost.py``.

The file spawns itself as the worker (``python tests/test_torch_multihost.py``
with ``TKNN_MH_WORKER`` set): every process joins a gloo pod on the CPU
through the launch interface's environment variables, drives the ring over
the global mesh (``MH_LOCAL_DEVICES`` logical ranks a process, in process
order), and saves what it got. The pods are the reference's two shapes,
2 processes × 4 ranks (uni, the grid form's plain version among its
forms) and 4 × 2 (bidir), on its data (64×12 from ``default_rng(7)``,
k=4, query_tile=4, corpus_tile=8), and two ``--dp 2`` pods: 2 × 2 (each
dp group inside a process) and 4 × 1 (each group spans two processes).

Each form's result, the same on every process, is held against the JAX
package's single-process serial ``all_knn`` (ids equal, distances within
``rtol=1e-5``, the reference worker's tolerance), and bit for bit against
the port's single-process ring over the same 8 ranks (the dp pods: its
single-process 2 × 2 mesh over 4 logical ranks). The resumable ring
stops after 2 rounds and resumes with per-process (non-shared) checkpoint
directories: process 0's broadcast decides the round. A 2-process sharded
clustered index is held bit for bit against the unsharded index. Each pod
has a timeout that kills every worker and fails with their output.
"""

import contextlib
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER_ENV = "TKNN_MH_WORKER"
POD_TIMEOUT_S = 120
K, Q_TILE, C_TILE = 4, 4, 8


def _data():
    rng = np.random.default_rng(7)
    return rng.standard_normal((64, 12)).astype(np.float32)


def _cfg(schedule, **kw):
    from mpi_knn_tpu_torch import KNNConfig

    return KNNConfig(k=K, query_tile=Q_TILE, corpus_tile=C_TILE,
                     ring_schedule=schedule, **kw)


# each form: (config overrides, all_knn_ring's ``form`` override or None)
FORMS = {
    "ring/xla": ({"backend": "ring"}, None),
    "ring-overlap/xla": ({"backend": "ring-overlap"}, None),
    "ring-overlap/fused": ({"backend": "ring-overlap", "ring_fusion": "fused"}, None),
    "dma": ({"backend": "ring-overlap", "ring_fusion": "fused"}, "dma"),
    "grid": ({"backend": "ring-overlap", "ring_fusion": "fused",
              "ring_fused_rotation": "grid"}, "grid"),
}


def _forms(schedule):
    # the dma and grid forms are uni's (ring_form never picks them under
    # bidir); the blocking schedule is undefined on a 2-D mesh
    if schedule == "bidir":
        return [f for f in FORMS if f not in ("dma", "grid")]
    if schedule == "dp":
        return [f for f in FORMS if f != "ring/xla"]
    return list(FORMS)


def _run_form(X, schedule, form, mesh):
    import torch

    from mpi_knn_tpu_torch.backends.ring import all_knn_ring

    over, override = FORMS[form]
    cfg = _cfg("uni" if schedule == "dp" else schedule, **over)
    d, i = all_knn_ring(X, X, np.arange(len(X), dtype=np.int32), cfg, mesh=mesh,
                        overlap=cfg.backend == "ring-overlap", device="cpu",
                        form=override)
    assert isinstance(d, torch.Tensor)
    return d.numpy(), i.numpy()


def _resumable_cfg(schedule):
    return _cfg("uni" if schedule == "dp" else schedule, backend="ring-overlap",
                ring_fusion="fused")


# ---------------------------------------------------------------------------
# the worker (no JAX here)


def _worker_ring(X, schedule, mesh, tmp, pid, out):
    from mpi_knn_tpu_torch.backends.ring import bidir_rounds
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
    from mpi_knn_tpu_torch.parallel import distributed

    for form in _forms(schedule):
        distributed.reset_exchange_stats()
        out[f"{form}/d"], out[f"{form}/i"] = _run_form(X, schedule, form, mesh)
        out[f"{form}/exchanges"] = np.asarray(distributed.EXCHANGES["exchanges"])
    P = len(mesh[0]) if schedule == "dp" else len(mesh)
    total = bidir_rounds(P)[0] if schedule == "bidir" else P
    ck = os.path.join(tmp, f"ck-proc{pid}")  # per process: not shared
    qids = np.arange(len(X), dtype=np.int32)
    rounds = []
    stop = 1 if schedule == "dp" else 2  # a dp group's ring is 2 rounds
    all_knn_ring_resumable(X, X, qids, _resumable_cfg(schedule), mesh=mesh,
                           checkpoint_dir=ck, stop_after_rounds=stop, device="cpu",
                           progress_cb=lambda r, t: rounds.append(r))
    assert rounds == list(range(1, stop + 1)), rounds
    ck_file = os.path.join(ck, "knn_state.npz")
    assert os.path.exists(ck_file) == (pid == 0), "only process 0 writes"
    rounds2 = []
    d, i = all_knn_ring_resumable(X, X, qids, _resumable_cfg(schedule), mesh=mesh,
                                  checkpoint_dir=ck, device="cpu",
                                  progress_cb=lambda r, t: rounds2.append(r))
    out["resumed_rounds"] = np.asarray(rounds2)
    out["resumable/d"], out["resumable/i"] = d.numpy(), i.numpy()


def _worker_ivf(tmp, out, local):
    from mpi_knn_tpu_torch.ivf import (
        load_ivf_index,
        search_ivf_sharded,
        shard_ivf_index,
    )
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    idx = load_ivf_index(os.path.join(tmp, "index.npz"), device="cpu")
    Q = np.load(os.path.join(tmp, "queries.npy"))
    qids = np.arange(len(Q), dtype=np.int32)
    mesh = make_ring_mesh(local, device="cpu")
    assert mesh.owners == [p for p in (0, 1) for _ in range(local)], mesh.owners
    for cap, name in ((None, "safe"), (2, "tight")):
        sidx = shard_ivf_index(idx, mesh=mesh, route_cap=cap)
        assert sidx.spans_processes
        assert sum(s is not None for s in sidx.slices) == local
        d, i, stats = search_ivf_sharded(sidx, Q, query_ids=qids, device="cpu")
        out[f"{name}/d"], out[f"{name}/i"] = d.numpy(), i.numpy()
        out[f"{name}/stats"] = stats.numpy()
    out.update(_drive_mutation(_mut_index(tmp, mesh=mesh), Q))
    out.update(_drive_session(_mut_index(tmp, mesh=mesh), Q))
    _worker_faults(_mut_index(tmp, mesh=mesh), Q, out)


# ---------------------------------------------------------------------------
# live mutation and a session over the sharded store: one driver for the
# pod's processes and for the one-process store they are held against

MUT_CFG = dict(k=K, partitions=8, nprobe=3, query_tile=8, bucket_headroom=0.5,
               mutation_bucket=16, query_bucket=16, kmeans_iters=8)
SESSION_BATCHES = 16


def _mut_index(tmp, mesh=None, shards=None):
    """The saved mutable index (``MUT_CFG``) sharded over ``mesh`` (the
    pod's) or ``shards`` logical ranks of this process."""
    from mpi_knn_tpu_torch.ivf import load_ivf_index, shard_ivf_index

    idx = load_ivf_index(os.path.join(tmp, "mut_index.npz"), device="cpu")
    return (shard_ivf_index(idx, mesh=mesh) if mesh is not None
            else shard_ivf_index(idx, shards=shards))


def _churn_ops(dim):
    """The churn sequence: upserts of new ids, updates that move rows to
    other partitions, deletes, compaction without and with retrain, and a
    burst at one spot that overflows, compacts and then grows the cap."""
    rng = np.random.default_rng(21)
    ops = []
    for j in range(3):
        new = np.arange(5000 + 16 * j, 5016 + 16 * j)
        ops.append(("upsert", new, (rng.standard_normal((16, dim)) * 4).astype(np.float32)))
        ops.append(("upsert", new[:6], (rng.standard_normal((6, dim)) * 4).astype(np.float32)))
        ops.append(("delete", np.concatenate([np.arange(12 * j, 12 * j + 6), new[10:12]])))
    ops.append(("compact", False))
    ops.append(("compact", True))
    burst = (np.full((1, dim), 3.0) + 0.01 * rng.standard_normal((300, dim))).astype(np.float32)
    ops.append(("upsert", np.arange(9000, 9300), burst))
    return ops


def _store_arrays(index, prefix, out):
    from mpi_knn_tpu_torch.ivf import unshard_ivf_index

    whole = unshard_ivf_index(index)
    for name in ("buckets", "bucket_ids", "bucket_sqs", "centroids", "centroid_sqs"):
        out[f"{prefix}/{name}"] = getattr(whole, name).numpy()
    out[f"{prefix}/cap"] = np.asarray(index.bucket_cap)


def _drive_mutation(index, Q) -> dict:
    """The churn through a session on ``index``; after every step the
    whole store and a search of ``Q``."""
    from mpi_knn_tpu_torch.ivf import search_ivf_sharded
    from mpi_knn_tpu_torch.serve import ServeSession

    out = {}
    sess = ServeSession(index, device="cpu")
    qids = np.arange(len(Q), dtype=np.int32)
    for n, (kind, *args) in enumerate(_churn_ops(index.dim)):
        if kind == "upsert":
            sess.upsert(*args)
        elif kind == "delete":
            sess.delete(*args)
        else:
            sess.compact(retrain=args[0])
        _store_arrays(index, f"churn/{n}", out)
        d, i, _ = search_ivf_sharded(index, Q, query_ids=qids, device="cpu")
        out[f"churn/{n}/d"], out[f"churn/{n}/i"] = d.numpy(), i.numpy()
    out["churn/compactions"] = np.asarray(sess.stats_snapshot()["mutation"]["compactions"])
    return out


def _drive_session(index, Q) -> dict:
    """SESSION_BATCHES 16-row batches through a session, with upserts,
    deletes and a compaction between them; each retired batch's results,
    seq and rung."""
    from mpi_knn_tpu_torch.serve import ServeSession

    rng = np.random.default_rng(22)
    sess = ServeSession(index, device="cpu")
    done = []
    for b in range(SESSION_BATCHES):
        done += sess.submit(Q[(16 * b) % len(Q):][:16])
        if b % 3 == 0:
            sess.upsert(np.arange(6000 + 8 * b, 6008 + 8 * b),
                        (rng.standard_normal((8, index.dim)) * 4).astype(np.float32))
        elif b % 3 == 1:
            sess.delete(np.arange(100 + 4 * b, 104 + 4 * b))
        elif b == 8:
            sess.compact(retrain=True)
    done += sess.drain()
    return {"session/d": np.stack([r.dists for r in done]),
            "session/i": np.stack([r.ids for r in done]),
            "session/seq": np.asarray([r.seq for r in done]),
            "session/rung": np.asarray([r.degraded or "full" for r in done])}


def _worker_faults(index, Q, out):
    """What the pod must refuse, and the decision it must take once: a
    plan that differs on one process (process 1's ids are off by one)
    stops both before any write; a deadline only process 1 breaks sheds
    both processes' ladders at the same seq; the background compactor is
    refused by name; a process that leaves fails the other's next
    collective, named. Runs last: process 1 leaves here."""
    from mpi_knn_tpu_torch.ivf import unshard_ivf_index
    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy
    from mpi_knn_tpu_torch.serve import ServeSession
    from mpi_knn_tpu_torch.serve.mutate import delete_rows, upsert_rows

    pid = distributed.process_index()
    before = unshard_ivf_index(index).bucket_ids.clone()
    ids = np.arange(8000, 8008) + (1 if pid == 1 else 0)
    try:
        upsert_rows(index, ids, Q[:8])
    except distributed.PlanMismatchError as e:
        out["faults/mismatch"] = np.asarray(str(e))
    out["faults/unwritten"] = np.asarray(
        bool((unshard_ivf_index(index).bucket_ids == before).all()))
    pol = ResiliencePolicy(batch_deadline_s=0.0 if pid == 1 else 1e6,
                           degrade_after=2)
    sess = ServeSession(index, resilience=pol, device="cpu")
    done = []
    for b in range(6):
        done += sess.submit(Q[:16])
    done += sess.drain()
    out["faults/rungs"] = np.asarray([r.degraded or "full" for r in done])
    out["faults/shed_after"] = np.asarray([e["after_batch"] for e in sess.degradations])
    try:
        sess.start_compactor()
    except ValueError as e:
        out["faults/compactor"] = np.asarray(str(e))
    # a process that leaves the pod: process 1 skips this delete and shuts
    # down, and process 0's agreement fails at once, naming the operation
    if pid == 0:
        try:
            delete_rows(index, [0])
        except RuntimeError as e:
            out["faults/left"] = np.asarray(str(e))


def _worker() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from mpi_knn_tpu_torch.parallel.distributed import init_multihost, shutdown
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    mode, tmp = os.environ[WORKER_ENV], os.environ["MH_TMPDIR"]
    local = int(os.environ["MH_LOCAL_DEVICES"])
    info = init_multihost(timeout_seconds=60, device="cpu", local_devices=local)
    pid = info["process_id"]
    assert info["num_processes"] == int(os.environ["JAX_NUM_PROCESSES"]), info
    assert info["backend"] == "gloo", info
    out = {}
    try:
        X = _data()
        if mode == "ivf":
            _worker_ivf(tmp, out, local)
        elif mode == "dp":
            from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

            ranks = local * info["num_processes"]
            assert info["devices"] == ranks and info["local_devices"] == local
            mesh = make_mesh2d(2, ranks // 2, device="cpu")
            assert [len(set(g.owners)) for g in mesh] == (
                [1, 1] if local == 2 else [2, 2]), [g.owners for g in mesh]
            _worker_ring(X, mode, mesh, tmp, pid, out)
        else:
            mesh = make_ring_mesh(local, device="cpu")
            assert len(mesh) == local * info["num_processes"]
            _worker_ring(X, mode, mesh, tmp, pid, out)
    finally:
        shutdown()
    np.savez(os.path.join(tmp, f"out-{pid}.npz"), **out)
    print(f"proc {pid} multihost OK", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the test process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pod(tmp: Path, mode: str, num_processes: int, local: int) -> list:
    """Spawn ``num_processes`` workers of ``mode`` against one local
    coordinator; returns each process's saved dict. A worker that fails
    or a pod that outlives its timeout fails the test with every
    worker's output."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.update({WORKER_ENV: mode, "MH_TMPDIR": str(tmp),
                "MH_LOCAL_DEVICES": str(local), "OMP_NUM_THREADS": "1",
                "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                "JAX_NUM_PROCESSES": str(num_processes)})
    procs = [subprocess.Popen([sys.executable, __file__], cwd=REPO,
                              env=dict(env, JAX_PROCESS_ID=str(p)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p in range(num_processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=POD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        partial = [p.communicate()[0] or "" for p in procs]
        pytest.fail("pod workers hung (mismatched exchanges?):\n"
                    + "\n".join(outs + partial))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"proc {pid} multihost OK" in out
    return [dict(np.load(tmp / f"out-{p}.npz")) for p in range(num_processes)]


POD_SHAPES = {"uni": (2, 4), "bidir": (4, 2)}
# --dp 2 pods: each group inside a process (2 × 2), each across two (4 × 1)
DP_SHAPES = {"2x2": (2, 2), "4x1": (4, 1)}


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    return {s: _pod(tmp_path_factory.mktemp(f"pod-{s}"), s, *POD_SHAPES[s])
            for s in POD_SHAPES}


@pytest.fixture(scope="module")
def dp_pods(tmp_path_factory):
    return {s: _pod(tmp_path_factory.mktemp(f"pod-dp-{s}"), "dp", *DP_SHAPES[s])
            for s in DP_SHAPES}


@pytest.fixture(scope="module")
def jax_serial():
    """The JAX package's single-process serial all_knn on the pods' data."""
    import mpi_knn_tpu as jax_pkg

    res = jax_pkg.all_knn(_data(), k=K, query_tile=Q_TILE, corpus_tile=C_TILE,
                          backend="serial")
    return np.asarray(res.dists), np.asarray(res.ids)


@contextlib.contextmanager
def _one_thread():
    """One BLAS thread, as the pods' processes run."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _single_process(schedule, form):
    """The port's single-process ring over the pod's 8 ranks."""
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    X = _data()
    with _one_thread():
        if form == "resumable":
            d, i = all_knn_ring_resumable(
                X, X, np.arange(len(X), dtype=np.int32), _resumable_cfg(schedule),
                mesh=make_ring_mesh(8, device="cpu"), device="cpu")
            return d.numpy(), i.numpy()
        return _run_form(X, schedule, form, make_ring_mesh(8, device="cpu"))


CASES = [(s, f) for s in POD_SHAPES for f in _forms(s) + ["resumable"]]


@pytest.mark.parametrize("schedule,form", CASES)
def test_pod_equals_jax_serial_and_the_single_process_ring(pods, jax_serial,
                                                           schedule, form):
    got = pods[schedule]
    gd, gi = got[0][f"{form}/d"], got[0][f"{form}/i"]
    for other in got[1:]:  # every process holds the whole result
        assert np.array_equal(other[f"{form}/i"], gi)
        assert np.array_equal(other[f"{form}/d"], gd)
    wd, wi = jax_serial
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5)
    sd, si = _single_process(schedule, form)
    assert np.array_equal(gi, si) and np.array_equal(gd, sd)


@pytest.mark.parametrize("schedule,form",
                         [(s, f) for s in POD_SHAPES for f in _forms(s)])
def test_boundary_moves_once_a_rotating_round(pods, schedule, form):
    """A process's boundary moves its traveler once a round that rotates,
    each way under bidir, and not after the last round: the dma form's
    last K4 leaves its outbox unsent, since no round reads it."""
    from mpi_knn_tpu_torch.backends.ring import bidir_rounds

    P = 8
    want = 2 * (bidir_rounds(P)[0] - 1) if schedule == "bidir" else P - 1
    for out in pods[schedule]:
        assert int(out[f"{form}/exchanges"]) == want


@pytest.mark.parametrize("schedule", list(POD_SHAPES))
def test_resume_round_comes_from_process_zeros_broadcast(pods, schedule):
    from mpi_knn_tpu_torch.backends.ring import bidir_rounds

    P = 8
    total = bidir_rounds(P)[0] if schedule == "bidir" else P
    for out in pods[schedule]:
        assert out["resumed_rounds"].tolist() == list(range(3, total + 1))


def _single_process_mesh2d(form):
    """The port's single-process 2 × 2 mesh over 4 logical ranks."""
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    X = _data()
    mesh = make_mesh2d(2, 2, device="cpu")
    with _one_thread():
        if form == "resumable":
            d, i = all_knn_ring_resumable(
                X, X, np.arange(len(X), dtype=np.int32), _resumable_cfg("dp"),
                mesh=mesh, device="cpu")
            return d.numpy(), i.numpy()
        return _run_form(X, "dp", form, mesh)


DP_CASES = [(s, f) for s in DP_SHAPES for f in _forms("dp") + ["resumable"]]


@pytest.mark.parametrize("shape,form", DP_CASES)
def test_dp_pod_equals_jax_serial_and_the_single_process_mesh(dp_pods, jax_serial,
                                                              shape, form):
    """--dp 2 across processes: every process holds the whole result, the
    JAX package's serial ids, and the single-process 2 × 2 mesh's bits."""
    got = dp_pods[shape]
    gd, gi = got[0][f"{form}/d"], got[0][f"{form}/i"]
    for other in got[1:]:
        assert np.array_equal(other[f"{form}/i"], gi)
        assert np.array_equal(other[f"{form}/d"], gd)
    wd, wi = jax_serial
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5)
    sd, si = _single_process_mesh2d(form)
    assert np.array_equal(gi, si) and np.array_equal(gd, sd)


@pytest.mark.parametrize("shape", list(DP_SHAPES))
def test_dp_groups_move_blocks_only_where_they_span_processes(dp_pods, shape):
    """A group inside one process moves nothing through the process group;
    a group across two moves its traveler once a rotating round (P − 1),
    and the resume is process 0's."""
    for out in dp_pods[shape]:
        for form in _forms("dp"):
            want = 0 if shape == "2x2" else 2 - 1
            assert int(out[f"{form}/exchanges"]) == want, form
        assert out["resumed_rounds"].tolist() == [2]


def test_coordinator_that_never_answers_raises_within_the_timeout():
    import time

    from mpi_knn_tpu_torch.parallel.distributed import init_multihost, pod

    addr = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="multi-host init failed") as e:
        init_multihost(coordinator_address=addr, num_processes=2, process_id=1,
                       timeout_seconds=3, device="cpu")
    assert addr in str(e.value) and "processes=2" in str(e.value)
    assert "id=1" in str(e.value)
    assert time.perf_counter() - t0 < 30
    assert pod() is None


def test_single_process_start_up_is_a_no_op(monkeypatch):
    from mpi_knn_tpu_torch.parallel import distributed

    for name in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                 distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    info = distributed.init_multihost(device="cpu")
    assert info == {"process_id": 0, "num_processes": 1, "devices": 1,
                    "local_devices": 1, "backend": None}
    assert distributed.pod() is None and distributed.process_count() == 1
    x = np.arange(6).reshape(3, 2)
    assert np.array_equal(distributed.fetch_global(x), x)


def _fake_pod(monkeypatch, cards, hosts=("h0", "h0"), process_id=0):
    """A pod of len(hosts) processes as process ``process_id`` sees it,
    without a process group."""
    import torch

    from mpi_knn_tpu_torch.parallel import distributed

    cards = [torch.device(c) for c in cards]
    monkeypatch.setattr(distributed, "_POD", distributed.Pod(
        process_id=process_id, num_processes=len(hosts), backend="gloo",
        card=cards[0], nccl=None, startup_seconds=0.0, coordinator="127.0.0.1:1",
        cards=cards, hosts=list(hosts)))


@pytest.mark.parametrize("count,procs,n,want", [
    (1, 2, 2, [["cuda:0", "cuda:0"], ["cuda:0", "cuda:0"]]),
    (4, 2, 2, [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]),
    (4, 4, 1, [["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]]),
    (2, 2, 4, [["cuda:0", "cuda:1", "cuda:0", "cuda:1"]] * 2),
])
def test_cuda_pod_places_n_ranks_a_process_by_the_card_rule(monkeypatch, count,
                                                            procs, n, want):
    """Rank j of process p on card (p·n + j) % device_count."""
    import torch

    from mpi_knn_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    got = [[str(c) for c in distributed.pod_cards(torch.device("cuda"), p, n)]
           for p in range(procs)]
    assert got == want
    assert distributed.pod_cards(torch.device("cpu"), 1, n) == [torch.device("cpu")] * n


@pytest.mark.parametrize("seen,want", [
    ([("h", "cuda", ["GPU-0"]), ("h", "cuda", ["GPU-0"])], "gloo"),
    ([("h", "cuda", ["GPU-0", "GPU-1"]), ("h", "cuda", ["GPU-2", "GPU-3"])],
     "nccl+gloo"),
    ([("h", "cuda", ["GPU-0", "GPU-1"]), ("h", "cuda", ["GPU-1", "GPU-2"])], "gloo"),
    ([("a", "cuda", ["GPU-a0"]), ("b", "cuda", ["GPU-b0"])], "nccl+gloo"),
    ([("h", "cpu", ["cpu"]), ("h", "cpu", ["cpu"])], "gloo"),
    ([("a", "cuda", ["GPU-0"]), ("b", "cuda", ["GPU-0"])], "gloo"),
])
def test_backend_follows_the_card_rule(seen, want):
    """NCCL where no card (by its UUID) is held by two processes, else gloo
    through host memory, whatever host names the processes report."""
    from mpi_knn_tpu_torch.parallel.distributed import backend_of

    assert backend_of(seen) == want


def test_cuda_pod_mesh_takes_each_process_s_ranks(monkeypatch):
    """On a faked CUDA pod of 2 processes × 2 cards the 1-D mesh and the
    2-D grid are every process's cards in process order, ring minor; a
    mesh of more ranks a process than the pod placed is refused by name."""
    import torch.distributed as dist

    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d, make_ring_mesh

    _fake_pod(monkeypatch, ["cuda:0", "cuda:1"])

    def gather(out, obj):
        out[0], out[1] = obj, [f"cuda:{2 + i}" for i in range(len(obj))]

    monkeypatch.setattr(dist, "all_gather_object", gather)
    mesh = make_ring_mesh(device="cuda")
    assert [str(d) for d in mesh] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert mesh.owners == [0, 0, 1, 1] and list(mesh.local_ranks(0)) == [0, 1]
    one = make_ring_mesh(1, device="cuda")
    assert [str(d) for d in one] == ["cuda:0", "cuda:2"] and one.owners == [0, 1]
    grid = make_mesh2d(2, 2, device="cuda")
    assert [[str(d) for d in g] for g in grid] == [["cuda:0", "cuda:1"],
                                                   ["cuda:2", "cuda:3"]]
    assert [g.owners for g in grid] == [[0, 0], [1, 1]]
    across = make_mesh2d(1, 4, device="cuda")
    assert across[0].owners == [0, 0, 1, 1] and across[0].spans_processes()
    with pytest.raises(ValueError, match="the pod placed 2"):
        make_ring_mesh(3, device="cuda")


def test_round_dma_outbox_takes_the_boundary_ranks_copy():
    """K4's plain version at a process boundary: the last rank's traveler
    goes into the outbox, the first rank's landing slot is left for the
    process group, the merges are the ring's; an outbox and a boundary
    transport go together."""
    import torch

    from mpi_knn_tpu_torch.ops import fused_rotation as fr
    from mpi_knn_tpu_torch.ops.topk import init_topk

    rng = np.random.default_rng(3)
    P, q, b, d = 2, 8, 16, 12
    queries = [torch.from_numpy(rng.standard_normal((q, d)).astype(np.float32))
               for _ in range(P)]
    qids = [torch.arange(r * q, (r + 1) * q, dtype=torch.int32) for r in range(P)]
    blocks = [(torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)),
               torch.arange(r * b, (r + 1) * b, dtype=torch.int32), None)
              for r in range(P)]
    carries = [init_topk(q, K, dtype=torch.float32, device="cpu") for _ in range(P)]
    landing = [fr.slot(fr.landing_slots(*t), 0) for t in blocks]
    for t in landing:
        t[0].fill_(-7.0)
        t[1].fill_(-7)
    outbox = fr.landing_buffers(*blocks[-1])
    edge = fr.ring_transport(["cpu"] * P, boundary=True)
    got = fr.fused_round_dma(edge, queries, qids, blocks, carries, landing,
                             c_tile=8, outbox=outbox)
    assert torch.equal(outbox[0], blocks[-1][0]) and torch.equal(outbox[1], blocks[-1][1])
    assert torch.equal(landing[1][0], blocks[0][0])
    assert (landing[0][0] == -7.0).all() and (landing[0][1] == -7).all()
    want = fr.fused_round_dma(fr.ring_transport(["cpu"] * P), queries, qids, blocks,
                              carries, [fr.slot(fr.landing_slots(*t), 0) for t in blocks],
                              c_tile=8)
    for (gd, gi), (wd, wi) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gi, wi)
    with pytest.raises(ValueError, match="outbox goes with a boundary"):
        fr.fused_round_dma(fr.ring_transport(["cpu"] * P), queries, qids, blocks,
                           carries, landing, c_tile=8, outbox=outbox)
    with pytest.raises(ValueError, match="outbox goes with a boundary"):
        fr.fused_round_dma(edge, queries, qids, blocks, carries, landing, c_tile=8)


# ---------------------------------------------------------------------------
# the sharded clustered index across processes: one and two shards a process


@pytest.fixture(scope="module")
def ivf_pod(tmp_path_factory):
    from mpi_knn_tpu_torch.ivf import save_ivf_index
    from tests.test_torch_ivf_sharded import _clustered, _pair

    tmp = tmp_path_factory.mktemp("pod-ivf")
    X = _clustered(np.random.default_rng(0), m=512, d=16, centers=8)
    j, p = _pair(X, k=K, partitions=8, nprobe=3, query_tile=8)
    save_ivf_index(p, str(tmp / "index.npz"))
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.ivf import build_ivf_index

    with _one_thread():
        save_ivf_index(build_ivf_index(X, KNNConfig(**MUT_CFG), device="cpu"),
                       str(tmp / "mut_index.npz"))
    Q = X[:48] + np.float32(0.01)
    np.save(tmp / "queries.npy", Q)
    return j, p, Q, _pod(tmp, "ivf", 2, 1), tmp


@pytest.fixture(scope="module")
def ivf_pod_2x2(ivf_pod):
    """The same index over 2 processes × 2 shards."""
    tmp = ivf_pod[4] / "2x2"
    tmp.mkdir()
    for name in ("index.npz", "mut_index.npz", "queries.npy"):
        (tmp / name).symlink_to(ivf_pod[4] / name)
    return _pod(tmp, "ivf", 2, 2)


def _sharded_q_tile(p, nq, shards=2):
    """The query tile a batch of ``nq`` rows runs at over ``shards``."""
    from mpi_knn_tpu_torch.ivf.sharded import sharded_query_shapes

    return sharded_query_shapes(p.cfg, p.nprobe, p.bucket_cap, p.dim, nq, shards)[0]


@pytest.mark.parametrize("cap", ["safe", "tight"])
def test_two_process_sharded_index_equals_the_unsharded_one(ivf_pod, cap):
    import torch

    from mpi_knn_tpu_torch.ivf import search_ivf, search_ivf_sharded, shard_ivf_index

    _, p, Q, outs, _ = ivf_pod
    qids = np.arange(len(Q), dtype=np.int32)
    with _one_thread():
        one = shard_ivf_index(p, shards=2, route_cap=None if cap == "safe" else 2)
        wd, wi, wstats = search_ivf_sharded(one, Q, query_ids=qids, device="cpu")
    for out in outs:
        assert np.array_equal(out[f"{cap}/i"], wi.numpy())
        assert np.array_equal(out[f"{cap}/d"], wd.numpy())
        assert np.array_equal(out[f"{cap}/stats"], wstats.numpy())
    if cap == "safe":
        assert int(wstats[:, 1].sum()) == 0
        with _one_thread():
            q_tile = _sharded_q_tile(p, len(Q))
            d0, i0 = search_ivf(p, Q, query_ids=qids, device="cpu", query_tile=q_tile)
        assert torch.equal(i0, wi) and torch.equal(d0, wd)
    else:
        assert int(wstats[:, 1].sum()) > 0  # the tight cap drops, counted


def test_two_process_sharded_index_agrees_with_jax_search_ivf(ivf_pod):
    from mpi_knn_tpu import ivf as jivf
    from tests.test_torch_ivf import _assert_same_search

    j, p, Q, outs, _ = ivf_pod
    qids = np.arange(len(Q), dtype=np.int32)
    jd, ji = jivf.search_ivf(j, Q, query_ids=qids)
    _assert_same_search(p, Q, (outs[0]["safe/d"], outs[0]["safe/i"]), (jd, ji))


@pytest.mark.parametrize("cap", ["safe", "tight"])
def test_two_shards_a_process_equal_four_shards_in_one_process(ivf_pod, ivf_pod_2x2,
                                                               cap):
    """2 processes × 2 shards: every process's results and per-shard stats
    bit for bit the one-process 4-shard index (and, at the safe cap, the
    unsharded index at the same query tile)."""
    import torch

    from mpi_knn_tpu_torch.ivf import search_ivf, search_ivf_sharded, shard_ivf_index

    _, p, Q, _, _ = ivf_pod
    qids = np.arange(len(Q), dtype=np.int32)
    with _one_thread():
        one = shard_ivf_index(p, shards=4, route_cap=None if cap == "safe" else 2)
        wd, wi, wstats = search_ivf_sharded(one, Q, query_ids=qids, device="cpu")
    for out in ivf_pod_2x2:
        assert np.array_equal(out[f"{cap}/i"], wi.numpy())
        assert np.array_equal(out[f"{cap}/d"], wd.numpy())
        assert np.array_equal(out[f"{cap}/stats"], wstats.numpy())
    if cap == "safe":
        with _one_thread():
            d0, i0 = search_ivf(p, Q, query_ids=qids, device="cpu",
                                query_tile=_sharded_q_tile(p, len(Q), 4))
        assert torch.equal(i0, wi) and torch.equal(d0, wd)
    else:
        assert int(wstats[:, 1].sum()) > 0


def test_process_spanning_store_refuses_mutation_and_sessions(ivf_pod, ivf_pod_2x2):
    """A store that spans processes takes mutation and serves through a
    session (no longer refused): every process of both pods ran the churn
    and a session to their ends, and the background compactor alone is
    refused by name."""
    for out in ivf_pod[3] + ivf_pod_2x2:
        assert int(out["churn/compactions"]) >= 2
        assert len(out["session/seq"]) == SESSION_BATCHES
        assert "spans processes" in str(out["faults/compactor"])


@contextlib.contextmanager
def _single_mut(tmp, shards):
    """The one-process store of ``shards`` logical ranks, one BLAS thread."""
    with _one_thread():
        yield _mut_index(tmp, shards=shards)


@pytest.fixture(scope="module")
def single_mutation(ivf_pod):
    """The one-process churn and session at 2 and 4 shards, and the
    unsharded store's churn."""
    from mpi_knn_tpu_torch.ivf import load_ivf_index

    tmp, Q = ivf_pod[4], ivf_pod[2]
    got = {}
    for shards in (2, 4):
        with _single_mut(tmp, shards) as one:
            got[shards] = _drive_mutation(one, Q)
        with _single_mut(tmp, shards) as one:
            got[shards].update(_drive_session(one, Q))
    return got


POD_OF = {"2x1": (lambda a, b: a[3], 2), "2x2": (lambda a, b: b, 4)}


@pytest.mark.parametrize("pod", list(POD_OF))
def test_pod_churn_equals_the_one_process_store(ivf_pod, ivf_pod_2x2,
                                                single_mutation, pod):
    """Upserts, partition-moving updates, deletes, compaction with and
    without retrain and an overflow that compacts and then grows the cap,
    on a store of 2 × 1 and 2 × 2 shards over two processes: after every
    step every process's whole store (gathered), centroids and search
    equal the one-process store's of as many shards, bit for bit."""
    pick, shards = POD_OF[pod]
    want = single_mutation[shards]
    steps = len(_churn_ops(16))
    caps = set()
    for out in pick(ivf_pod, ivf_pod_2x2):
        for n in range(steps):
            for key in ("buckets", "bucket_ids", "bucket_sqs", "centroids",
                        "centroid_sqs", "cap", "d", "i"):
                k_ = f"churn/{n}/{key}"
                assert np.array_equal(out[k_], want[k_]), k_
            caps.add(int(out[f"churn/{n}/cap"]))
        assert int(out["churn/compactions"]) == int(want["churn/compactions"]) >= 3
    assert len(caps) >= 2  # the burst grew the cap


@pytest.mark.parametrize("pod", list(POD_OF))
def test_pod_session_equals_the_one_process_session(ivf_pod, ivf_pod_2x2,
                                                    single_mutation, pod):
    """A session on each process of the pod answers SESSION_BATCHES
    batches with mutations between them bit for bit the one-process
    session, every process on the same rung at every seq."""
    pick, shards = POD_OF[pod]
    want = single_mutation[shards]
    outs = pick(ivf_pod, ivf_pod_2x2)
    for out in outs:
        for key in ("session/d", "session/i", "session/seq", "session/rung"):
            assert np.array_equal(out[key], want[key]), key
    assert list(outs[0]["session/seq"]) == list(range(SESSION_BATCHES))


@pytest.mark.parametrize("pod", list(POD_OF))
def test_pod_plan_that_differs_raises_naming_both_digests(ivf_pod, ivf_pod_2x2, pod):
    """Process 1's upsert ids are off by one: both processes raise before
    anything is written, naming process 0's digest and process 1's."""
    outs = POD_OF[pod][0](ivf_pod, ivf_pod_2x2)
    msgs = [str(out["faults/mismatch"]) for out in outs]
    assert msgs[0] == msgs[1] and "upsert plan" in msgs[0]
    digests = re.findall(r"has '([0-9a-f]{16})'", msgs[0])
    assert len(digests) == 2 and digests[0] != digests[1]
    assert all(bool(out["faults/unwritten"]) for out in outs)


@pytest.mark.parametrize("pod", list(POD_OF))
def test_pod_deadline_breach_on_one_process_sheds_both_at_the_same_seq(
        ivf_pod, ivf_pod_2x2, pod):
    """Only process 1's deadline is broken (0 s against process 0's
    1e6 s): the breach is decided once for the pod, so both processes
    shed at the same seqs and serve every batch on the same rung."""
    outs = POD_OF[pod][0](ivf_pod, ivf_pod_2x2)
    assert len(outs[0]["faults/shed_after"]) >= 1
    assert np.array_equal(outs[0]["faults/shed_after"], outs[1]["faults/shed_after"])
    assert np.array_equal(outs[0]["faults/rungs"], outs[1]["faults/rungs"])
    assert "full" != outs[0]["faults/rungs"][-1]


@pytest.mark.parametrize("pod", list(POD_OF))
def test_pod_process_that_leaves_fails_the_collective_naming_it(ivf_pod, ivf_pod_2x2,
                                                                pod):
    """Process 1 leaves the pod where process 0 deletes: process 0's plan
    agreement raises at once, naming the operation, and never hangs (a
    process that stays but never joins fails it within the group's
    timeout the same way)."""
    outs = POD_OF[pod][0](ivf_pod, ivf_pod_2x2)
    msg = str(outs[0]["faults/left"])
    assert msg.startswith("delete plan: the collective across the pod's processes failed")
    assert "faults/left" not in outs[1]


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    sys.exit(_worker())
