"""The grid form (K5) across hosts: the link rule, the host proxy
(``mpi_knn_tpu_torch/parallel/hostlink.py``) and the plain stand-in for
the kernel's side of its protocol
(``ops/fused_rotation.fused_rotation_grid_proxy_reference``), and the
backend rule that reads physical cards.

The file spawns itself as the worker (``TKNN_HL_WORKER``): every process
joins a gloo pod on the CPU through the launch interface's environment
variables, after faking its host name (``socket.gethostname``, patched in
the worker before ``init_multihost``: the package has no switch for it).
Pods: 2 processes × 2 ranks on hosts (h0, h1), so both boundary links
are proxy links, and 4 × 1 on (h0, h0, h1, h1), where each process has
one "ipc" link and one "proxy" link. Each runs the uni grid form over the
4-rank ring on the multihost tests' data (64×12 from ``default_rng(7)``,
k=4, query_tile=4, corpus_tile=8) and is held bit for bit against the
port's single-process 4-rank ring and, tie-aware, against the JAX
package's serial ``all_knn`` (distances within ``rtol=1e-5``). A third pod
has a neighbour that never answers.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
WORKER_ENV = "TKNN_HL_WORKER"
POD_TIMEOUT_S = 120
GRACE_S = 5.0
K, Q_TILE, C_TILE = 4, 4, 8
RANKS = 4

# pod name -> (processes, ranks a process, the hosts the workers report)
PODS = {"2x2": (2, 2, ("h0", "h1")), "4x1": (4, 1, ("h0", "h0", "h1", "h1"))}


def _data():
    rng = np.random.default_rng(7)
    return rng.standard_normal((64, 12)).astype(np.float32)


def _grid(X, mesh):
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring

    cfg = KNNConfig(k=K, query_tile=Q_TILE, corpus_tile=C_TILE, backend="ring-overlap",
                    ring_fusion="fused", ring_fused_rotation="grid")
    d, i = all_knn_ring(X, X, np.arange(len(X), dtype=np.int32), cfg, mesh=mesh,
                        device="cpu", form="grid")
    return d.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# the worker (no JAX here)


def _worker() -> int:
    sys.path.insert(0, str(REPO))
    pid = int(os.environ["JAX_PROCESS_ID"])
    host = os.environ["HL_HOSTS"].split(",")[pid]
    socket.gethostname = lambda: host  # told apart: this worker's own patch
    import torch

    torch.set_num_threads(1)
    from mpi_knn_tpu_torch.ops.fused_rotation import TIMEOUT_S
    from mpi_knn_tpu_torch.parallel import distributed, hostlink, ipc
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    mode, tmp = os.environ[WORKER_ENV], os.environ["HL_TMPDIR"]
    local = int(os.environ["HL_LOCAL"])
    info = distributed.init_multihost(timeout_seconds=60, device="cpu",
                                      local_devices=local)
    assert info["backend"] == "gloo", info
    out = {"hosts": np.asarray(info["hosts"])}
    try:
        mesh = make_ring_mesh(local, device="cpu")
        assert len(mesh) == RANKS
        if mode == "silent":
            if pid == 0:  # process 1 never enters the call
                t0 = time.perf_counter()
                try:
                    _grid(_data(), mesh)
                except RuntimeError as e:
                    out["error"] = np.asarray(str(e))
                out["seconds"] = np.asarray(time.perf_counter() - t0)
                try:  # the transport is not made anew: the pod restarts
                    _grid(_data(), mesh)
                except RuntimeError as e:
                    out["again"] = np.asarray(str(e))
            else:
                time.sleep(TIMEOUT_S + GRACE_S)
        else:
            from mpi_knn_tpu_torch.backends.ring import ProcessSpan

            out["kinds"] = np.asarray(ProcessSpan(mesh).link_kinds())
            for call in range(2):  # the flag words count up across calls
                hostlink.reset_proxy_stats()
                distributed.reset_exchange_stats()
                out[f"d{call}"], out[f"i{call}"] = _grid(_data(), mesh)
            out.update({f"proxy/{k}": np.asarray(v)
                        for k, v in hostlink.PROXY.items()})
            out["exchanges"] = np.asarray(distributed.EXCHANGES["exchanges"])
            out["ipc_active"] = np.asarray(ipc.active())
    finally:
        distributed.shutdown()
    np.savez(os.path.join(tmp, f"out-{pid}.npz"), **out)
    print(f"proc {pid} hostlink OK", flush=True)
    return 0


# ---------------------------------------------------------------------------
# the test process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pod(tmp: Path, mode: str, processes: int, local: int, hosts) -> list:
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env.update({WORKER_ENV: mode, "HL_TMPDIR": str(tmp), "HL_LOCAL": str(local),
                "HL_HOSTS": ",".join(hosts), "OMP_NUM_THREADS": "1",
                "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                "JAX_NUM_PROCESSES": str(processes)})
    procs = [subprocess.Popen([sys.executable, __file__], cwd=REPO,
                              env=dict(env, JAX_PROCESS_ID=str(p)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for p in range(processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=POD_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        partial = [p.communicate()[0] or "" for p in procs]
        pytest.fail("pod workers hung:\n" + "\n".join(outs + partial))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"proc {pid} hostlink OK" in out
    return [dict(np.load(tmp / f"out-{p}.npz")) for p in range(processes)]


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    return {name: _pod(tmp_path_factory.mktemp(f"hl-{name}"), "pod", *shape)
            for name, shape in PODS.items()}


@pytest.fixture(scope="module")
def single_ring():
    """The port's single-process 4-rank grid form, one BLAS thread."""
    import torch

    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _grid(_data(), make_ring_mesh(RANKS, device="cpu"))
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_serial():
    import mpi_knn_tpu as jax_pkg

    res = jax_pkg.all_knn(_data(), k=K, query_tile=Q_TILE, corpus_tile=C_TILE,
                          backend="serial")
    return np.asarray(res.dists), np.asarray(res.ids)


def _assert_tie_aware(gd, gi, wd, wi):
    """Distances within rtol 1e-5 slot by slot; an id may differ from the
    reference's only where its own f64 distance ties the reference's
    distance in that slot."""
    np.testing.assert_allclose(gd, wd, rtol=1e-5)
    X = _data().astype(np.float64)
    rows, cols = np.nonzero(gi != wi)
    for r, j in zip(rows, cols):
        own = ((X[r] - X[gi[r, j]]) ** 2).sum()
        assert np.isclose(own, wd[r, j], rtol=1e-5), (r, j, gi[r], wi[r])


@pytest.mark.parametrize("pod", list(PODS))
def test_grid_across_hosts_equals_the_single_process_ring_and_jax_serial(
        pods, single_ring, jax_serial, pod):
    """Every process, both calls: bit for bit the single-process ring, and
    tie-aware the JAX package's serial all_knn."""
    sd, si = single_ring
    for out in pods[pod]:
        for call in range(2):
            gd, gi = out[f"d{call}"], out[f"i{call}"]
            assert np.array_equal(gi, si) and np.array_equal(gd, sd), (pod, call)
            _assert_tie_aware(gd, gi, *jax_serial)


@pytest.mark.parametrize("pod", list(PODS))
def test_proxy_moves_each_hop_once_and_opens_no_mapping(pods, pod):
    """A proxy link moves P − 1 hops a call, each once, of block + ids +
    norms (16 rows of 12 f32, 16 int32 ids, 16 f32 norms); an "ipc" link
    of the same pod moves its P − 1 through the process group (the plain
    version's hand_on), and nothing maps CUDA IPC memory."""
    block, ids, norms = 16 * 12 * 4, 16 * 4, 16 * 4
    hops = RANKS - 1
    for out in pods[pod]:
        nxt, prv = (str(k) for k in out["kinds"])
        assert bool(out["ipc_active"]) is False
        sent = hops if nxt == "proxy" else 0
        got = hops if prv == "proxy" else 0
        assert int(out["proxy/hops_sent"]) == sent
        assert int(out["proxy/hops_received"]) == got
        assert int(out["proxy/bytes_sent"]) == sent * (block + ids + norms)
        assert int(out["proxy/block_bytes"]) == sent * block
        assert int(out["proxy/ids_bytes"]) == sent * ids
        assert int(out["proxy/norms_bytes"]) == sent * norms
        assert int(out["proxy/calls"]) == (1 if "proxy" in (nxt, prv) else 0)
        ipc_hops = (nxt == "ipc") + (prv == "ipc")
        assert int(out["exchanges"]) == ipc_hops * hops


@pytest.mark.parametrize("pod,kinds", [
    ("2x2", [("proxy", "proxy")] * 2),
    ("4x1", [("ipc", "proxy"), ("proxy", "ipc"), ("ipc", "proxy"), ("proxy", "ipc")]),
])
def test_pod_links_follow_the_hosts(pods, pod, kinds):
    """Each process's (next, previous) link kinds as its workers saw them:
    "proxy" where the neighbour reported another host."""
    assert [tuple(str(k) for k in out["kinds"]) for out in pods[pod]] == kinds


def _fake_pod(monkeypatch, hosts, process_id=0):
    import torch

    from mpi_knn_tpu_torch.parallel import distributed

    monkeypatch.setattr(distributed, "_POD", distributed.Pod(
        process_id=process_id, num_processes=len(hosts), backend="gloo",
        card=torch.device("cpu"), nccl=None, startup_seconds=0.0,
        coordinator="127.0.0.1:1", cards=[torch.device("cpu")], hosts=list(hosts)))


@pytest.mark.parametrize("hosts,pid,want", [
    (("h0", "h1"), 0, ("proxy", "proxy")),
    (("h0", "h0"), 0, ("ipc", "ipc")),
    (("h0", "h0", "h1"), 0, ("ipc", "proxy")),
    (("h0", "h0", "h1"), 1, ("proxy", "ipc")),
    (("h0", "h0", "h1"), 2, ("proxy", "proxy")),
])
def test_link_rule_reads_the_pod_hosts(monkeypatch, hosts, pid, want):
    """The link past a process's last rank and the one before its first:
    "proxy" where that neighbour runs on another host, "ipc" on the same;
    the transport of a grid-form run takes those kinds."""
    import torch

    from mpi_knn_tpu_torch.backends.ring import ProcessSpan
    from mpi_knn_tpu_torch.ops import fused_rotation
    from mpi_knn_tpu_torch.parallel import hostlink
    from mpi_knn_tpu_torch.parallel.mesh import RingMesh

    _fake_pod(monkeypatch, hosts, pid)
    owners = [p for p in range(len(hosts)) for _ in range(2)]
    span = ProcessSpan(RingMesh(["cpu"] * len(owners), owners=owners))
    assert span.link_kinds() == want
    assert hostlink.link_kind(list(hosts), pid, span.next) == want[0]
    t = fused_rotation.RingTransport([torch.device("cpu")] * 2, boundary=True,
                                     links=(span.next, span.prev), kinds=want)
    assert [t.proxied(0), t.proxied(1)] == [k == "proxy" for k in want]


def test_silent_neighbour_fails_the_proxy_within_the_timeout(tmp_path):
    """Process 1 never enters the grid form: process 0's call raises
    within TIMEOUT_S plus a grace, naming its pod, a second call on the
    same transport is refused (its flag words are made once: the pod
    restarts), and neither process hangs (both exit 0 inside the pod's
    limit)."""
    from mpi_knn_tpu_torch.ops.fused_rotation import TIMEOUT_S

    outs = _pod(tmp_path, "silent", 2, 2, ("h0", "h1"))
    msg = str(outs[0]["error"])
    assert float(outs[0]["seconds"]) < TIMEOUT_S + GRACE_S, outs[0]["seconds"]
    assert "the host proxy of process 0 of the pod at 127.0.0.1:" in msg, msg
    assert "(2 processes)" in msg and "every process of the pod fails" in msg
    assert "timed out" in msg or "gloo" in msg
    assert "made once" in str(outs[0]["again"])


@pytest.mark.parametrize("count,hosts,want", [
    (1, ("h0", "h1"), "gloo"),   # one card, told-apart hosts: still shared
    (1, ("h0", "h0"), "gloo"),
    (4, ("h0", "h1"), "nccl+gloo"),
])
def test_backend_rule_reads_physical_cards(monkeypatch, count, hosts, want):
    """The backend rule keys each card on its UUID: processes that report
    distinct hosts on one card share it and take gloo; two cards each take
    NCCL."""
    import types

    import torch

    from mpi_knn_tpu_torch.parallel import distributed

    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=f"GPU-uuid-{i}"))
    seen = [(h, "cuda", distributed.card_ids(
        distributed.pod_cards(torch.device("cuda"), p, 2)))
        for p, h in enumerate(hosts)]
    assert distributed.backend_of(seen) == want


if __name__ == "__main__" and os.environ.get(WORKER_ENV):
    sys.exit(_worker())


def test_protocol_constants_are_the_kernels():
    """The proxy reads and writes K5's flag words from one Python copy of
    the protocol (``ops/fused_rotation.PROTOCOL``); it must be the
    kernel's source's COPY_CTAS and enum Word (on the card ``_lib`` checks
    the built library's ``ring_protocol`` the same way)."""
    import re

    from mpi_knn_tpu_torch.ops import fused_rotation as fr
    from mpi_knn_tpu_torch.parallel import hostlink

    src = (REPO / "mpi_knn_tpu_torch" / "csrc" / "fused_ring_dma.cu").read_text()
    copy_ctas = int(re.search(r"constexpr int COPY_CTAS = (\d+);", src).group(1))
    enum = re.search(r"enum Word \{(.*?)\};", src, re.S).group(1)
    words = {n: int(v) for n, v in re.findall(r"(\w+) = (\d+)", enum)}
    want = (copy_ctas, words["NWORDS"], words["W_ERR"], words["G_FROM_PRED"],
            words["G_FROM_SUCC"], words["G_LANDED"], words["G_FREE"])
    assert fr.PROTOCOL == want
    assert re.search(r"int ring_protocol\(int\* out\)", src)
    assert (hostlink.COPY_CTAS, hostlink.G_LANDED) == (fr.COPY_CTAS, fr.G_LANDED)
    errs = re.search(r"enum Err \{(.*?)\};", src, re.S).group(1)
    # the proxy's error code is the host's own: no kernel wait may use it
    assert fr.ERR_PROXY not in {int(v) for v in re.findall(r"= (\d+)", errs)}
