"""The ring's device mesh: an ordered list of ``torch.device``s, one per
ring rank (the JAX package's 1-D ``jax.sharding.Mesh``), and the 2-D
(dp × ring) grid of them (``make_mesh2d``: queries shard over every
device, each dp group runs its own ring over its replica of the corpus).

In one process the ring runs single-controller: the process holds every
rank's shards and moves each block to the next rank's device. On CUDA the
mesh takes the visible cards in order, and asking for more than are
visible raises. On the CPU ``num_devices=P`` gives P logical ranks on the
one CPU device, the counterpart of the JAX tests' virtual host mesh. A
mesh may name one card several times; its ranks then share the card and
no bytes move between them.

After ``parallel/distributed.init_multihost`` the mesh spans every
process's ranks in process order (the JAX package's mesh over
``jax.devices()``): ``num_devices`` counts each process's ranks (logical
ranks on the CPU; on CUDA the first ``num_devices`` of the cards the pod's
card rule gave the process, default all of them), and
``RingMesh.owners`` records the process that owns each rank. A process
holds and drives only its own ranks; the devices it records for another
process's ranks are that process's names for them. ``make_mesh2d`` in a
pod builds the (dp × ring) grid over the same global ranks, ring axis
minor (the JAX rule): a dp group may lie inside one process or span
several, and each group's ``RingMesh`` has its own ``owners``.

The in-kernel ring transport (``ring_fusion="fused"`` on cards: K4, K5)
stores straight into the next card's memory, so it needs peer access
between every pair of ring neighbours on distinct cards:
``enable_peer_access`` turns it on, and raises for a pair without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mpi_knn_tpu_torch.device import DEFAULT_DEVICE


class RingMesh(list):
    """An ordered list of ``torch.device``s with the ring axis's name and,
    across processes, the process that owns each rank (``owners``; None
    in one process). Owners run in process order, each process's ranks
    consecutive (a dp group's ring may start at any process)."""

    def __init__(self, devices, axis_name: str = "ring", owners=None):
        super().__init__(torch.device(d) for d in devices)
        if not self:
            raise ValueError("a ring mesh needs at least one device")
        self.axis_name = axis_name
        self.axis_names = (axis_name,)
        self.owners = None if owners is None else [int(o) for o in owners]
        if self.owners is not None and (
                len(self.owners) != len(self) or self.owners[0] < 0
                or any(b not in (a, a + 1) for a, b in zip(self.owners, self.owners[1:]))):
            raise ValueError(
                f"ring owners {self.owners} must name, rank by rank, processes "
                "in order, each process's ranks consecutive")

    def spans_processes(self) -> bool:
        return self.owners is not None and len(set(self.owners)) > 1

    def local_ranks(self, process_id: int) -> range:
        """The ranks ``process_id`` owns (every rank in one process)."""
        if self.owners is None:
            return range(len(self))
        mine = [r for r, o in enumerate(self.owners) if o == process_id]
        return range(mine[0], mine[-1] + 1) if mine else range(0)


class Mesh2D(list):
    """A (dp × ring) grid of ``torch.device``s: one :class:`RingMesh` per dp
    group, the ring on the minor axis. A grid may name one card several
    times, as a ring mesh may."""

    def __init__(self, grid, dp_axis: str = "dp", ring_axis: str = "ring",
                 owners=None):
        super().__init__(RingMesh(row, ring_axis,
                                  owners=None if owners is None else owners[g])
                         for g, row in enumerate(grid))
        if not self or len({len(r) for r in self}) != 1:
            raise ValueError("a 2-D mesh needs dp >= 1 groups of one ring size")
        self.axis_names = (dp_axis, ring_axis)

    @property
    def shape(self) -> tuple[int, int]:
        return len(self), len(self[0])

    def flat(self) -> list:
        """Every device in (dp, ring) order: the order of the query shards."""
        return [d for row in self for d in row]


def is_mesh2d(mesh) -> bool:
    """A 2-D mesh: a :class:`Mesh2D` or a list of device lists."""
    return isinstance(mesh, Mesh2D) or (
        mesh is not None and any(isinstance(d, (list, tuple)) for d in mesh))


def as_mesh2d(mesh) -> Mesh2D:
    return mesh if isinstance(mesh, Mesh2D) else Mesh2D(mesh)


def mesh_size(mesh) -> int:
    """Devices of a 1-D or 2-D mesh."""
    return len(as_mesh2d(mesh).flat()) if is_mesh2d(mesh) else len(mesh)


def make_ring_mesh(num_devices: Optional[int] = None, axis_name: str = "ring",
                   devices: Optional[Sequence] = None,
                   device=DEFAULT_DEVICE) -> RingMesh:
    """A mesh over the first ``num_devices`` of ``devices`` (default: the
    visible cards when ``device`` is CUDA, one CPU rank per requested rank
    when it is the CPU). In a pod of processes, and with ``devices`` not
    given, every process's ranks in process order (see the module's
    docstring)."""
    from mpi_knn_tpu_torch.parallel import distributed

    kind = torch.device(device).type
    if devices is None and distributed.process_count() > 1:
        return _pod_mesh(num_devices, axis_name, kind)
    if devices is None:
        if kind == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(kind)] * (num_devices or 1)
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, only {len(devices)} visible"
            )
        devices = devices[:num_devices]
    return RingMesh(devices, axis_name)


def _pod_mesh(num_devices, axis_name: str, kind: str) -> RingMesh:
    """Every process's ranks in process order: ``num_devices`` logical CPU
    ranks each, or the first ``num_devices`` of each process's cards
    (default all). Every process must ask for the same count."""
    import torch.distributed as dist

    from mpi_knn_tpu_torch.parallel import distributed

    if kind == "cuda":
        cards = distributed.pod().cards
        n = len(cards) if num_devices is None else num_devices
        if n > len(cards):
            raise ValueError(
                f"{n} ranks a process, but the pod placed {len(cards)} "
                f"({[str(c) for c in cards]}): pass local_devices={n} to "
                "init_multihost (--devices on the CLI)")
        mine = list(cards[:n])
    else:
        mine = [torch.device(kind)] * (num_devices or 1)
    every = [None] * distributed.process_count()
    dist.all_gather_object(every, [str(d) for d in mine])
    if len({len(ds) for ds in every}) != 1:
        raise ValueError(f"every process of a pod drives as many ranks: got "
                         f"{[len(ds) for ds in every]}")
    devices = [d for ds in every for d in ds]
    owners = [p for p, ds in enumerate(every) for _ in ds]
    return RingMesh(devices, axis_name, owners=owners)


def make_mesh2d(dp: int, ring: int, dp_axis: str = "dp",
                ring_axis: str = "ring", devices: Optional[Sequence] = None,
                device=DEFAULT_DEVICE) -> Mesh2D:
    """A (dp × ring) grid over the first dp·ring of ``devices`` (default: the
    visible cards when ``device`` is CUDA, logical ranks on the CPU): the
    queries shard over every device, the corpus rings within each dp group,
    so query throughput and corpus capacity scale apart. The ring is the
    minor axis: a group's ranks are consecutive devices. In a pod of
    processes, and with ``devices`` not given, the grid is over every
    process's ranks (dp·ring / processes each), in process order."""
    from mpi_knn_tpu_torch.parallel import distributed

    if dp < 1 or ring < 1:
        raise ValueError(f"a 2-D mesh needs dp, ring >= 1, got {dp}×{ring}")
    need = dp * ring
    kind = torch.device(device).type
    procs = distributed.process_count()
    if devices is None and procs > 1:
        if need % procs:
            raise ValueError(f"a {dp}×{ring} mesh over {procs} processes: "
                             f"{need} ranks do not split evenly")
        flat = _pod_mesh(need // procs, ring_axis, kind)
        return Mesh2D([flat[g * ring:(g + 1) * ring] for g in range(dp)],
                      dp_axis, ring_axis,
                      owners=[flat.owners[g * ring:(g + 1) * ring] for g in range(dp)])
    if devices is None:
        if kind == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(kind)] * need
    devices = list(devices)
    if need > len(devices):
        raise ValueError(
            f"requested {dp}×{ring}={need} devices, only {len(devices)} visible")
    return Mesh2D([devices[g * ring:(g + 1) * ring] for g in range(dp)],
                  dp_axis, ring_axis)


def enable_peer_access(devices: Sequence) -> None:
    """Enable peer access both ways between every pair of ring neighbours
    that lie on distinct cards. A pair the hardware cannot join raises
    ``ValueError`` naming both cards: there is no quiet switch to another
    transport. Ranks that share a card need nothing."""
    cards = [torch.device(d) for d in devices]
    pairs = set()
    for r, a in enumerate(cards):
        b = cards[(r + 1) % len(cards)]
        if a.type == b.type == "cuda" and a != b:
            pairs |= {(a.index, b.index), (b.index, a.index)}
    if not pairs:
        return
    from mpi_knn_tpu_torch.ops.fused_rotation import _lib

    lib = _lib()
    for a, b in sorted(pairs):
        if not torch.cuda.can_device_access_peer(a, b):
            raise ValueError(
                f"cuda:{a} and cuda:{b} are ring neighbours without peer "
                "access: the in-kernel ring transport stores into the next "
                "card's memory and needs it")
        rc = lib.ring_enable_peer_access(a, b)
        if rc != 0:
            raise RuntimeError(
                f"enabling peer access from cuda:{a} to cuda:{b} failed: "
                f"cudaError {rc}")
