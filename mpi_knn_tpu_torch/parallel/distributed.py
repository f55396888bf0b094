"""More than one process: start-up through ``torch.distributed`` and the
moves between processes (the JAX package's ``parallel/distributed.py``).

The reference's process model is ``mpirun -np P`` over one
``MPI_COMM_WORLD``: every process runs the same program, and the ring's
ranks are spread over the processes in process order. Here every process
calls :func:`init_multihost` with the coordinator's ``host:port``, the
process count and its own id (or the launch interface's environment
variables ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``), and the process group meets at a TCP rendezvous there.
Process 0 listens on that address. A failed start-up raises
``RuntimeError`` naming the coordinator, the count and the id within
``timeout_seconds``; it never waits at a barrier for ever.

The backend rule, stated once (``backend`` in the start-up info):

- every process on a card of its own: NCCL moves CUDA tensors (a group of
  its own, ``"nccl+gloo"``), gloo host objects (the default group);
- processes that share a card, or run on the CPU: gloo alone (``"gloo"``),
  and a CUDA tensor is staged through host memory on its way: NCCL refuses
  two ranks of one communicator on one device.

The rule reads each process's card after the gloo group has formed, so
every process takes the same branch. No transport is swapped after a
failure. A process drives one card, ``process_id % device_count``; a
pod with several cards a process is not ported (``parallel/mesh.py``
refuses more than one rank a process on CUDA).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device

log = logging.getLogger("mpi_knn_tpu_torch")

ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"


@dataclasses.dataclass
class Pod:
    """The joined processes, as this process sees them."""

    process_id: int
    num_processes: int
    backend: str  # "gloo" or "nccl+gloo"
    card: torch.device  # this process's device: its card, or the CPU
    nccl: object | None  # the NCCL group for CUDA tensors, else None
    startup_seconds: float
    coordinator: str
    # seconds of the last gather of a result across processes
    gather_seconds: float = 0.0


_POD: Optional[Pod] = None


def pod() -> Optional[Pod]:
    """The joined pod, or None in a single-process run."""
    return _POD


def process_count() -> int:
    return _POD.num_processes if _POD is not None else 1


def process_index() -> int:
    return _POD.process_id if _POD is not None else 0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def wants_multihost(coordinator_address=None, num_processes=None) -> bool:
    """Whether the arguments or the launch environment ask for more than
    one process."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    return coordinator_address is not None or (
        num_processes is not None and num_processes > 1)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_seconds: int = 300,
                   device=DEFAULT_DEVICE) -> dict:
    """Join (or skip, in a single-process run) the process group.

    With no arguments, reads ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` and does nothing when none
    asks for more than one process. ``device`` is the kind the process
    runs on ("cuda" unless the caller asks for the CPU); on CUDA the
    process takes card ``process_id % device_count``.

    Returns {process_id, num_processes, devices, local_devices, backend}
    (with ``card``, ``coordinator`` and ``startup_seconds`` in a pod) for
    the run report.
    """
    global _POD
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID)
    dev = resolve_device(device)
    if not wants_multihost(coordinator_address, num_processes):
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        return {"process_id": 0, "num_processes": 1, "devices": n,
                "local_devices": n, "backend": None}
    if _POD is not None:
        raise RuntimeError("this process has joined a process group already")
    where = (f"coordinator={coordinator_address}, processes={num_processes}, "
             f"id={process_id}")
    if coordinator_address is None or num_processes is None or process_id is None:
        raise RuntimeError(
            f"multi-host init failed ({where}): a process group needs the "
            "coordinator's host:port, the process count and this process's id")
    if not 0 <= process_id < num_processes:
        raise RuntimeError(f"multi-host init failed ({where}): the id must lie "
                           f"in [0, {num_processes})")
    if dev.type == "cuda":
        mine = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(mine)
    else:
        mine = dev
    t0 = time.perf_counter()
    timeout = datetime.timedelta(seconds=timeout_seconds)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                rank=process_id, world_size=num_processes,
                                timeout=timeout)
        host = socket.gethostname()
        seen = [None] * num_processes
        dist.all_gather_object(seen, (host, dev.type, str(mine)))
        used = [(h, c) for h, kind, c in seen if kind == "cuda"]
        own_cards = (all(kind == "cuda" for _, kind, _ in seen)
                     and len(set(used)) == len(used))
        nccl = None
        if own_cards:
            nccl = dist.new_group(backend="nccl", timeout=timeout)
            # form the communicator now, inside the start-up's timeout
            probe = torch.ones(1, device=mine)
            dist.all_reduce(probe, group=nccl)
            torch.cuda.synchronize(mine)
            if int(probe.item()) != num_processes:
                raise RuntimeError(f"NCCL probe summed {probe.item()}")
    except Exception as e:  # surface, never hang at a barrier
        if dist.is_initialized():
            dist.destroy_process_group()
        raise RuntimeError(f"multi-host init failed ({where}): {e}") from e
    p = _POD = Pod(process_id=process_id, num_processes=num_processes,
                   backend="nccl+gloo" if nccl is not None else "gloo",
                   card=mine, nccl=nccl,
                   startup_seconds=time.perf_counter() - t0,
                   coordinator=coordinator_address)
    info = {"process_id": p.process_id, "num_processes": p.num_processes,
            "devices": num_processes, "local_devices": 1, "backend": p.backend,
            "card": str(p.card), "coordinator": p.coordinator,
            "startup_seconds": p.startup_seconds}
    log.info("distributed: process %d/%d over %s, %d global devices (%d local)",
             info["process_id"], info["num_processes"], info["backend"],
             info["devices"], info["local_devices"])
    return info


def shutdown() -> None:
    """Leave the process group (every process calls it at its end)."""
    global _POD
    if _POD is not None and dist.is_initialized():
        dist.destroy_process_group()
    _POD = None


def _require_pod() -> Pod:
    if _POD is None:
        raise RuntimeError("no process group: call init_multihost first")
    return _POD


def _staged(t: torch.Tensor) -> bool:
    """Whether ``t`` travels through host memory (a CUDA tensor without
    an NCCL group)."""
    return t.device.type == "cuda" and _require_pod().nccl is None


def _group_of(t: torch.Tensor):
    p = _require_pod()
    return p.nccl if t.device.type == "cuda" and p.nccl is not None else None


# point-to-point exchanges of this process: count, bytes sent, and host
# seconds from each one's issue to its wait's return. Staged through host
# memory, the clock starts once the card has finished the work that wrote
# the tensors sent (the sending stream is synchronized first), and
# ``d2h_seconds`` / ``h2d_seconds`` are the copies' shares of ``seconds``
# (the rest is gloo's transfer and, where the exchange was issued before a
# merge, that merge's issue). A copy from pageable host memory waits for
# the work queued before it on the stream, so under overlap the H2D share
# includes the round's merge. Over NCCL ``seconds`` is the host's issue
# and wait only, the transfer running on NCCL's stream.
EXCHANGES = {"exchanges": 0, "bytes_sent": 0, "seconds": 0.0,
             "d2h_seconds": 0.0, "h2d_seconds": 0.0}


def reset_exchange_stats() -> None:
    EXCHANGES.update(exchanges=0, bytes_sent=0, seconds=0.0, d2h_seconds=0.0,
                     h2d_seconds=0.0)


class Exchange:
    """Sends and receives between processes, issued at once: ``wait``
    makes their results visible in stream order (NCCL: the current stream
    waits for NCCL's; staged: the host buffers land on the card)."""

    def __init__(self, works, landings, t0: float):
        self.works = works
        self.landings = landings  # (device tensor, host buffer)
        self.t0 = t0

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        t1 = time.perf_counter()
        for dst, buf in self.landings:
            dst.copy_(buf)
        if self.landings:
            EXCHANGES["h2d_seconds"] += time.perf_counter() - t1
        if self.t0 is not None:
            EXCHANGES["seconds"] += time.perf_counter() - self.t0
        self.works, self.landings, self.t0 = [], [], None


def exchange(sends, recvs) -> Exchange:
    """Point-to-point moves: ``sends`` (tensor, process, tag) go out,
    ``recvs`` (tensor, process, tag) are written, all issued now. Every
    process must issue its matching ops in the same order. A CUDA tensor
    moves by NCCL when the pod has it, else through a host copy."""
    staged = [t for t, _, _ in sends if _staged(t)]
    if staged:  # the work that wrote them is not the exchange's
        torch.cuda.current_stream(staged[0].device).synchronize()
    t0 = time.perf_counter()
    ops, landings = [], []
    for t, peer, tag in sends:
        EXCHANGES["bytes_sent"] += t.numel() * t.element_size()
        if _staged(t):
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer,
                              group=_group_of(t), tag=tag))
    if staged:
        EXCHANGES["d2h_seconds"] += time.perf_counter() - t0
    for t, peer, tag in recvs:
        dst = t
        if _staged(t):
            t = torch.empty(t.shape, dtype=t.dtype)
            landings.append((dst, t))
        ops.append(dist.P2POp(dist.irecv, t, peer, group=_group_of(t), tag=tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    EXCHANGES["exchanges"] += 1
    return Exchange(works, landings, t0)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (equal shapes), concatenated along rows in
    process order, on ``t``'s device."""
    p = _require_pod()
    src = t.cpu() if _staged(t) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(p.num_processes)]
    dist.all_gather(parts, src, group=_group_of(src))
    return torch.cat(parts).to(t.device)


def all_to_all_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``'s leading axis cut into one equal part per process, part j to
    process j; returns the parts received, in process order, with ``t``'s
    shape, on its device."""
    src = t.cpu() if _staged(t) else t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=_group_of(src))
    return out.to(t.device)


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` on every process (host objects, gloo)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_host(a: np.ndarray, src: int = 0) -> np.ndarray:
    """Process ``src``'s array on every process; the others pass an array
    of the same shape and dtype (host memory, gloo)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    dist.broadcast(t, src=src)
    return t.numpy()


def fetch_global(a) -> np.ndarray:
    """A host copy of a result, which every process holds whole: the
    port's ``all_knn`` gathers every process's rows before it returns (the
    reference's ``process_allgather`` branch), so a tensor or array passes
    straight through to numpy."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
