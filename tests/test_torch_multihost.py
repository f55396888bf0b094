"""Pods of OS processes through the port's ``torch.distributed`` start-up
(``mpi_knn_tpu_torch/parallel/distributed.py``), the counterpart of the
reference's ``tests/test_multihost.py``.

The file spawns itself as the worker (``python tests/test_torch_multihost.py``
with ``TKNN_MH_WORKER`` set): every process joins a gloo pod on the CPU
through the launch interface's environment variables, drives the ring over
the global mesh (``MH_LOCAL_DEVICES`` logical ranks a process, in process
order), and saves what it got. The pods are the reference's two shapes,
2 processes × 4 ranks (uni) and 4 × 2 (bidir), on its data (64×12 from
``default_rng(7)``, k=4, query_tile=4, corpus_tile=8).

Each form's result, the same on every process, is held against the JAX
package's single-process serial ``all_knn`` (ids equal, distances within
``rtol=1e-5``, the reference worker's tolerance), and bit for bit against
the port's single-process ring over the same 8 ranks. The resumable ring
stops after 2 rounds and resumes with per-process (non-shared) checkpoint
directories: process 0's broadcast decides the round. A 2-process sharded
clustered index is held bit for bit against the unsharded index. Each pod
has a timeout that kills every worker and fails with their output.
"""

import contextlib
import os
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
}


def _forms(schedule):
    # the dma form is uni's (ring_form never picks it under bidir)
    return [f for f in FORMS if schedule == "uni" or f != "dma"]


def _run_form(X, schedule, form, mesh):
    import torch

    from mpi_knn_tpu_torch.backends.ring import all_knn_ring

    over, override = FORMS[form]
    cfg = _cfg(schedule, **over)
    d, i = all_knn_ring(X, X, np.arange(len(X), dtype=np.int32), cfg, mesh=mesh,
                        overlap=cfg.backend == "ring-overlap", device="cpu",
                        form=override)
    assert isinstance(d, torch.Tensor)
    return d.numpy(), i.numpy()


def _resumable_cfg(schedule):
    return _cfg(schedule, backend="ring-overlap", ring_fusion="fused")


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
    P = len(mesh)
    total = bidir_rounds(P)[0] if schedule == "bidir" else P
    ck = os.path.join(tmp, f"ck-proc{pid}")  # per process: not shared
    qids = np.arange(len(X), dtype=np.int32)
    rounds = []
    all_knn_ring_resumable(X, X, qids, _resumable_cfg(schedule), mesh=mesh,
                           checkpoint_dir=ck, stop_after_rounds=2, device="cpu",
                           progress_cb=lambda r, t: rounds.append(r))
    assert rounds == [1, 2], rounds
    ck_file = os.path.join(ck, "knn_state.npz")
    assert os.path.exists(ck_file) == (pid == 0), "only process 0 writes"
    rounds2 = []
    d, i = all_knn_ring_resumable(X, X, qids, _resumable_cfg(schedule), mesh=mesh,
                                  checkpoint_dir=ck, device="cpu",
                                  progress_cb=lambda r, t: rounds2.append(r))
    out["resumed_rounds"] = np.asarray(rounds2)
    out["resumable/d"], out["resumable/i"] = d.numpy(), i.numpy()


def _worker_refusals(X, mesh, out):
    from mpi_knn_tpu_torch import all_knn
    from mpi_knn_tpu_torch import cli as port_cli
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    qids = np.arange(len(X), dtype=np.int32)
    cfg = _cfg("uni", backend="ring-overlap", ring_fusion="fused",
               ring_fused_rotation="grid")
    try:
        all_knn_ring(X, X, qids, cfg, mesh=mesh, device="cpu", form="grid")
    except ValueError as e:
        out["grid_refusal"] = np.asarray(str(e))
    try:
        all_knn(X, config=_cfg("uni", backend="ring-overlap"),
                mesh=make_mesh2d(2, 2, device="cpu"), device="cpu")
    except ValueError as e:
        out["mesh2d_refusal"] = np.asarray(str(e))
    args = port_cli.build_parser().parse_args(
        ["--data", "synthetic:64x8c2", "--k", "3", "--device", "cpu",
         "--devices", "2", "--dp", "2", "--backend", "ring-overlap"])
    try:
        port_cli._run(args, {"num_processes": 2})
    except SystemExit as e:
        out["dp_cli_refusal"] = np.asarray(str(e))


def _worker_ivf(tmp, out):
    import torch

    from mpi_knn_tpu_torch.ivf import (
        load_ivf_index,
        search_ivf_sharded,
        shard_ivf_index,
    )
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh
    from mpi_knn_tpu_torch.serve import ServeSession
    from mpi_knn_tpu_torch.serve.mutate import upsert_rows

    idx = load_ivf_index(os.path.join(tmp, "index.npz"), device="cpu")
    Q = np.load(os.path.join(tmp, "queries.npy"))
    qids = np.arange(len(Q), dtype=np.int32)
    mesh = make_ring_mesh(1, device="cpu")
    assert mesh.owners == [0, 1], mesh.owners
    for cap, name in ((None, "safe"), (2, "tight")):
        sidx = shard_ivf_index(idx, mesh=mesh, route_cap=cap)
        assert sidx.spans_processes
        assert sum(s is not None for s in sidx.slices) == 1
        d, i, stats = search_ivf_sharded(sidx, Q, query_ids=qids, device="cpu")
        out[f"{name}/d"], out[f"{name}/i"] = d.numpy(), i.numpy()
        out[f"{name}/stats"] = stats.numpy()
    try:
        upsert_rows(sidx, [10**6], torch.zeros((1, idx.dim)))
    except ValueError as e:
        out["mutation_refusal"] = np.asarray(str(e))
    try:
        ServeSession(sidx, device="cpu")
    except ValueError as e:
        out["serve_refusal"] = np.asarray(str(e))


def _worker() -> int:
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    from mpi_knn_tpu_torch.parallel.distributed import init_multihost, shutdown
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    mode, tmp = os.environ[WORKER_ENV], os.environ["MH_TMPDIR"]
    local = int(os.environ["MH_LOCAL_DEVICES"])
    info = init_multihost(timeout_seconds=60, device="cpu")
    pid = info["process_id"]
    assert info["num_processes"] == int(os.environ["JAX_NUM_PROCESSES"]), info
    assert info["backend"] == "gloo", info
    out = {}
    try:
        X = _data()
        if mode == "ivf":
            _worker_ivf(tmp, out)
        else:
            mesh = make_ring_mesh(local, device="cpu")
            assert len(mesh) == local * info["num_processes"]
            _worker_ring(X, mode, mesh, tmp, pid, out)
            if pid == 0 or mode == "uni":
                _worker_refusals(X, mesh, out)
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


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    return {s: _pod(tmp_path_factory.mktemp(f"pod-{s}"), s, *POD_SHAPES[s])
            for s in POD_SHAPES}


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


def test_grid_across_processes_is_refused_by_name(pods):
    msg = str(pods["uni"][0]["grid_refusal"])
    assert "ring_fused_rotation='grid'" in msg
    assert "no per-round boundary at which the process group" in msg


def test_dp_across_processes_is_refused_by_name(pods):
    for out in pods["uni"]:
        assert "2-D dp×ring mesh (--dp) across processes" in str(out["mesh2d_refusal"])
        assert "--dp with more than one process" in str(out["dp_cli_refusal"])


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


def test_cuda_pod_refuses_more_than_one_card_a_process(monkeypatch):
    """On CUDA a process of a pod drives one card: a mesh of more ranks a
    process is refused by name before any collective is issued."""
    import torch

    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    monkeypatch.setattr(distributed, "_POD", distributed.Pod(
        process_id=0, num_processes=2, backend="nccl+gloo",
        card=torch.device("cuda", 0), nccl=None, startup_seconds=0.0,
        coordinator="127.0.0.1:1"))
    with pytest.raises(ValueError, match="a process drives one card"):
        make_ring_mesh(2, device="cuda")


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
# the sharded clustered index, one shard a process


@pytest.fixture(scope="module")
def ivf_pod(tmp_path_factory):
    from mpi_knn_tpu_torch.ivf import save_ivf_index
    from tests.test_torch_ivf_sharded import _clustered, _pair

    tmp = tmp_path_factory.mktemp("pod-ivf")
    X = _clustered(np.random.default_rng(0), m=512, d=16, centers=8)
    j, p = _pair(X, k=K, partitions=8, nprobe=3, query_tile=8)
    save_ivf_index(p, str(tmp / "index.npz"))
    Q = X[:48] + np.float32(0.01)
    np.save(tmp / "queries.npy", Q)
    return j, p, Q, _pod(tmp, "ivf", 2, 1)


def _sharded_q_tile(p, nq):
    """The query tile a 2-shard batch of ``nq`` rows runs at."""
    from mpi_knn_tpu_torch.ivf.sharded import sharded_query_shapes

    return sharded_query_shapes(p.cfg, p.nprobe, p.bucket_cap, p.dim, nq, 2)[0]


@pytest.mark.parametrize("cap", ["safe", "tight"])
def test_two_process_sharded_index_equals_the_unsharded_one(ivf_pod, cap):
    import torch

    from mpi_knn_tpu_torch.ivf import search_ivf, search_ivf_sharded, shard_ivf_index

    _, p, Q, outs = ivf_pod
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

    j, p, Q, outs = ivf_pod
    qids = np.arange(len(Q), dtype=np.int32)
    jd, ji = jivf.search_ivf(j, Q, query_ids=qids)
    _assert_same_search(p, Q, (outs[0]["safe/d"], outs[0]["safe/i"]), (jd, ji))


def test_process_spanning_store_refuses_mutation_and_sessions(ivf_pod):
    for out in ivf_pod[3]:
        assert "spans processes cannot honor live mutation" in str(out["mutation_refusal"])
        assert "spans processes is not ported" in str(out["serve_refusal"])


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    sys.exit(_worker())
