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

A process drives ``local_devices`` ranks (``init_multihost(...,
local_devices=n)``, the JAX report's ``local_devices``). The card rule,
stated once: on CUDA, rank ``j`` of process ``p`` runs on card ``(p·n +
j) % device_count`` (``Pod.cards``). On one card that is ``cuda:0`` n
times in every process; on four cards with 2 processes × 2 ranks it is
cards {0, 1} and {2, 3}. On the CPU every rank is the CPU device.

The backend rule, stated once (``backend`` in the start-up info), reads
every process's cards by their physical identity (``card_ids``: each
card's UUID), never by the host name, so processes that report distinct
hosts on one card still share it:

- no card held by two processes: NCCL moves CUDA tensors (a
  group of its own, ``"nccl+gloo"``), gloo host objects (the default
  group). NCCL binds one card a process: a CUDA tensor on another of the
  process's cards is staged through the process's first card (``Pod.card``)
  on its way, one copy between the two cards (``EXCHANGES["hop_bytes"]``);
- a card shared by two processes, or the CPU: gloo alone (``"gloo"``), and
  a CUDA tensor is staged through host memory on its way: NCCL refuses two
  ranks of one communicator on one device.

The rule reads every process's cards after the gloo group has formed, so
every process takes the same branch. No transport is swapped after a
failure. Every process's hostname is kept (``Pod.hosts``): it decides the
kind of each link of the grid form's transport across processes, stated
once in ``parallel/hostlink.link_kind``: ``"ipc"`` where the neighbouring
process runs on the same host (CUDA IPC, ``parallel/ipc.py``), ``"proxy"``
where it does not (a host proxy over gloo, ``parallel/hostlink.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import hashlib
import logging
import os
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.utils.op_trace import note_transfer

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
    card: torch.device  # this process's first device (NCCL's card), or the CPU
    nccl: object | None  # the NCCL group for CUDA tensors, else None
    startup_seconds: float
    coordinator: str
    # every rank's device in this process (the card rule), and every
    # process's hostname in process order
    cards: list = dataclasses.field(default_factory=list)
    hosts: list = dataclasses.field(default_factory=list)
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
                   device=DEFAULT_DEVICE, local_devices: int = 1) -> dict:
    """Join (or skip, in a single-process run) the process group.

    With no arguments, reads ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` and does nothing when none
    asks for more than one process. ``device`` is the kind the process
    runs on ("cuda" unless the caller asks for the CPU); the process
    drives ``local_devices`` ranks, on CUDA on the cards of the card rule
    (the module's docstring).

    Returns {process_id, num_processes, devices, local_devices, backend}
    (with ``card``, ``cards``, ``hosts``, ``coordinator`` and
    ``startup_seconds`` in a pod) for the run report.
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
    if local_devices < 1:
        raise RuntimeError(f"multi-host init failed ({where}): local_devices "
                           f"must be >= 1, got {local_devices}")
    cards = pod_cards(dev, process_id, local_devices)
    mine = cards[0]
    if dev.type == "cuda":
        torch.cuda.set_device(mine)
    t0 = time.perf_counter()
    timeout = datetime.timedelta(seconds=timeout_seconds)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                rank=process_id, world_size=num_processes,
                                timeout=timeout)
        host = socket.gethostname()
        seen = [None] * num_processes
        dist.all_gather_object(seen, (host, dev.type, card_ids(cards)))
        hosts = [h for h, _, _ in seen]
        nccl = None
        if backend_of(seen) == "nccl+gloo":
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
                   coordinator=coordinator_address, cards=cards, hosts=hosts)
    info = {"process_id": p.process_id, "num_processes": p.num_processes,
            "devices": num_processes * local_devices,
            "local_devices": local_devices, "backend": p.backend,
            "card": str(p.card), "cards": [str(c) for c in cards],
            "hosts": hosts, "coordinator": p.coordinator,
            "startup_seconds": p.startup_seconds}
    log.info("distributed: process %d/%d over %s, %d global devices (%d local)",
             info["process_id"], info["num_processes"], info["backend"],
             info["devices"], info["local_devices"])
    return info


def backend_of(seen) -> str:
    """The backend rule over every process's (host, device kind, the
    physical identities of its distinct cards): NCCL for CUDA tensors where
    every process is on cards and no card is held by two processes, else
    gloo alone. The host name is not read: a card is known by its UUID."""
    used = [c for _, kind, cs in seen if kind == "cuda" for c in cs]
    own_cards = (all(kind == "cuda" for _, kind, _ in seen)
                 and len(set(used)) == len(used))
    return "nccl+gloo" if own_cards else "gloo"


def card_ids(cards) -> list:
    """The sorted physical identities of ``cards``' distinct devices: each
    CUDA card's UUID (``torch.cuda.get_device_properties(i).uuid``), the
    device's name off the cards."""
    return sorted({str(torch.cuda.get_device_properties(c.index).uuid)
                   if c.type == "cuda" else str(c) for c in cards})


def pod_cards(dev: torch.device, process_id: int, n: int) -> list:
    """The devices of process ``process_id``'s ``n`` ranks: on CUDA card
    ``(process_id·n + j) % device_count`` for rank j, else ``dev`` n
    times."""
    if dev.type != "cuda":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", (process_id * n + j) % count) for j in range(n)]


def shutdown() -> None:
    """Leave the process group (every process calls it at its end). The
    mappings of other processes' memory (``parallel/ipc.py``) are closed
    first, between two barriers: no process frees what another still maps,
    and none closes a mapping a kernel of its neighbour still writes
    through. A teardown that fails (a neighbour gone) is logged, and this
    process's memory is then left to its exit."""
    global _POD
    if _POD is not None and dist.is_initialized():
        from mpi_knn_tpu_torch.parallel import ipc

        if ipc.active():
            try:
                for c in dict.fromkeys(_POD.cards):
                    if c.type == "cuda":
                        torch.cuda.synchronize(c)
                dist.barrier()
                ipc.close_mappings()
                dist.barrier()
                ipc.free_exports()
            except Exception as e:  # never mask the error that ended the run
                log.warning("distributed: the CUDA IPC teardown failed: %s", e)
        from mpi_knn_tpu_torch.ops.fused_rotation import drop_process_transports

        drop_process_transports()  # a proxy link's buffers are this pod's
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


def _hops(t: torch.Tensor) -> bool:
    """Whether ``t`` moves by NCCL from a card other than the process's
    NCCL card, and so is staged through that card."""
    p = _require_pod()
    return p.nccl is not None and t.device.type == "cuda" and t.device != p.card


def _nccl_side(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the process group sends it: a host copy where it is
    staged, a copy on the NCCL card where it hops, else ``t`` itself."""
    if _staged(t):
        return t.cpu().contiguous()
    if _hops(t):
        EXCHANGES["hop_bytes"] += t.numel() * t.element_size()
        return t.to(_require_pod().card).contiguous()
    return t.contiguous()


# point-to-point exchanges of this process: count, bytes sent, and host
# seconds from each one's issue to its wait's return. Staged through host
# memory, the clock starts once the card has finished the work that wrote
# the tensors sent (the sending stream is synchronized first), and
# ``d2h_seconds`` / ``h2d_seconds`` are the copies' shares of ``seconds``
# (the rest is gloo's transfer and, where the exchange was issued before a
# merge, that merge's issue). A copy from pageable host memory waits for
# the work queued before it on the stream, so under overlap the H2D share
# includes the round's merge. Over NCCL ``seconds`` is the host's issue
# and wait only, the transfer running on NCCL's stream; ``hop_bytes`` are
# the bytes copied between a process's own cards on the way to or from
# its NCCL card.
EXCHANGES = {"exchanges": 0, "bytes_sent": 0, "seconds": 0.0,
             "d2h_seconds": 0.0, "h2d_seconds": 0.0, "hop_bytes": 0}


def reset_exchange_stats() -> None:
    EXCHANGES.update(exchanges=0, bytes_sent=0, seconds=0.0, d2h_seconds=0.0,
                     h2d_seconds=0.0, hop_bytes=0)


class Exchange:
    """Sends and receives between processes, issued at once: ``wait``
    makes their results visible in stream order (NCCL: the current stream
    waits for NCCL's, and what landed on the NCCL card for another card
    is copied there; staged: the host buffers land on the card)."""

    def __init__(self, works, landings, t0: float, hops=()):
        self.works = works
        self.landings = landings  # (device tensor, host buffer)
        self.hops = list(hops)  # (tensor on another card, NCCL card buffer)
        self.t0 = t0

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for dst, buf in self.hops:
            dst.copy_(buf)
        t1 = time.perf_counter()
        for dst, buf in self.landings:
            dst.copy_(buf)
        if self.landings:
            EXCHANGES["h2d_seconds"] += time.perf_counter() - t1
        if self.t0 is not None:
            EXCHANGES["seconds"] += time.perf_counter() - self.t0
        self.works, self.landings, self.hops, self.t0 = [], [], [], None


def exchange(sends, recvs) -> Exchange:
    """Point-to-point moves: ``sends`` (tensor, process, tag) go out,
    ``recvs`` (tensor, process, tag) are written, all issued now. Every
    process must issue its matching ops in the same order. A CUDA tensor
    moves by NCCL when the pod has it (through the NCCL card, from and to
    the process's other cards), else through a host copy."""
    staged = [t for t, _, _ in sends if _staged(t)]
    if staged:  # the work that wrote them is not the exchange's
        torch.cuda.current_stream(staged[0].device).synchronize()
    t0 = time.perf_counter()
    ops, landings, hops = [], [], []
    for t, peer, tag in sends:
        EXCHANGES["bytes_sent"] += t.numel() * t.element_size()
        note_transfer("collective", op="send", peer=peer,
                      bytes=t.numel() * t.element_size())
        t = _nccl_side(t)
        ops.append(dist.P2POp(dist.isend, t, peer, group=_group_of(t), tag=tag))
    if staged:
        EXCHANGES["d2h_seconds"] += time.perf_counter() - t0
    for t, peer, tag in recvs:
        dst = t
        if _staged(t):
            t = torch.empty(t.shape, dtype=t.dtype)
            landings.append((dst, t))
        elif _hops(t):
            EXCHANGES["hop_bytes"] += t.numel() * t.element_size()
            t = torch.empty(t.shape, dtype=t.dtype, device=_require_pod().card)
            hops.append((dst, t))
        ops.append(dist.P2POp(dist.irecv, t, peer, group=_group_of(t), tag=tag))
    works = dist.batch_isend_irecv(ops) if ops else []
    EXCHANGES["exchanges"] += 1
    return Exchange(works, landings, t0, hops)


def swap_host(sends, recvs) -> None:
    """Point-to-point moves of host tensors through gloo, outside the
    exchange counts (set-up messages such as ``parallel/ipc.py``'s
    handles): ``sends`` / ``recvs`` as :func:`exchange` takes them, waited
    for here."""
    ops = ([dist.P2POp(dist.isend, t, peer, tag=tag) for t, peer, tag in sends]
           + [dist.P2POp(dist.irecv, t, peer, tag=tag) for t, peer, tag in recvs])
    for w in dist.batch_isend_irecv(ops) if ops else []:
        w.wait()


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (equal shapes), concatenated along rows in
    process order, on ``t``'s device."""
    p = _require_pod()
    src = _nccl_side(t)
    parts = [torch.empty_like(src) for _ in range(p.num_processes)]
    note_transfer("collective", op="all_gather",
                  bytes=src.numel() * src.element_size())
    dist.all_gather(parts, src, group=_group_of(src))
    return torch.cat(parts).to(t.device)


def all_to_all_rows(t: torch.Tensor) -> torch.Tensor:
    """``t``'s leading axis cut into one equal part per process, part j to
    process j; returns the parts received, in process order, with ``t``'s
    shape, on its device."""
    src = _nccl_side(t)
    out = torch.empty_like(src)
    note_transfer("collective", op="all_to_all",
                  bytes=src.numel() * src.element_size())
    dist.all_to_all_single(out, src, group=_group_of(src))
    return out.to(t.device)


# the collectives of live mutation and of a session over a store that
# spans processes (this process's side): agreements on a plan or a batch
# (count, bytes of the values gathered), and moves of packed store rows
# (count, bytes sent to other processes, host seconds)
COLLECTIVES = {"agreements": 0, "agreement_bytes": 0, "row_moves": 0,
               "row_bytes_sent": 0, "row_seconds": 0.0}


def reset_collective_stats() -> None:
    COLLECTIVES.update(agreements=0, agreement_bytes=0, row_moves=0,
                       row_bytes_sent=0, row_seconds=0.0)


class PlanMismatchError(RuntimeError):
    """The processes of a pod reached one operation with different plans
    (or at different points of their call sequence): a store they share
    would diverge, so the operation stops on every process instead."""


@contextlib.contextmanager
def collective(op: str):
    """Name ``op`` in the error of a collective that fails. A process that
    never joins fails the others within the process group's timeout
    (``init_multihost(timeout_seconds=)``), and one that left fails them at
    once: either way every waiting process raises, naming the operation,
    and none hangs."""
    try:
        yield
    except PlanMismatchError:
        raise
    except Exception as e:
        raise RuntimeError(
            f"{op}: the collective across the pod's processes failed (a "
            "process that never joins fails it within the process group's "
            f"timeout): {type(e).__name__}: {e}") from e


def all_gather_object(obj, op: str) -> list:
    """Every process's host ``obj``, in process order (gloo), as the
    collective ``op``."""
    seen = [None] * _require_pod().num_processes
    with collective(op):
        dist.all_gather_object(seen, obj)
    return seen


def digest_of(*parts) -> str:
    """A short digest of host arrays (dtype, shape and bytes; None
    counts): what the processes compare to agree on a plan."""
    h = hashlib.sha256()
    for a in parts:
        if a is None:
            h.update(b"none")
            continue
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def agree(op: str, value: str) -> None:
    """Every process's ``value`` of ``op`` (a plan's digest, a batch's
    sequence and rung) must equal process 0's: one gather of the values,
    and a :class:`PlanMismatchError` on every process naming both values
    where one differs."""
    seen = all_gather_object(value, op)
    COLLECTIVES["agreements"] += 1
    COLLECTIVES["agreement_bytes"] += sum(len(str(v)) for v in seen)
    bad = [p for p, v in enumerate(seen) if v != seen[0]]
    if bad:
        raise PlanMismatchError(
            f"{op}: the processes disagree: process 0 has {seen[0]!r}, "
            f"process {bad[0]} has {seen[bad[0]]!r}; every process must make "
            "the same calls with the same arguments in the same order")


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` on every process (host objects, gloo)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_host(a: np.ndarray, src: int = 0) -> np.ndarray:
    """Process ``src``'s array on every process; the others pass an array
    of the same shape and dtype (host memory, gloo)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    note_transfer("collective", op="broadcast", bytes=t.numel() * t.element_size())
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
