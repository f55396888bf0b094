"""The ring backends (``backend="ring"`` and ``"ring-overlap"``): the JAX
package's ``backends/ring.py``, run by one controlling process.

The corpus is padded and cut into one block per ring rank, the queries
into one shard per rank. Rank r keeps its query shard, its carry and its
current block on ``mesh[r]``. Every round each rank merges its resident
block into its carry, then the blocks move one rank on: P rounds for the
``"uni"`` schedule, so every rank merges every block once. The ``"bidir"``
schedule sends every block both ways at once and takes ⌊P/2⌋+1 rounds; its
degenerate rounds (round 0, and for even P the antipodal block arriving
from both sides) merge once.

Who moves the blocks is the transport form, chosen by ``ring_form`` as the
JAX package chooses between its ppermutes and the kernel's own copies:

- ``"dma"`` (fused, uni, exact, ``ring_fused_rotation="round"``, every rank
  on a card): each round is one launch of K4 (``ops/fused_rotation.
  fused_round_dma``) per card, which merges and copies the resident block
  into the successor's landing slot; two slots per rank, swapped each
  round. On the f32 wire K4 runs the wgmma tile, on the bf16 and int8
  wires the mma.sync one.
- ``"grid"`` (fused, ``ring_fused_rotation="grid"``, on cards): the whole
  rotation is one launch of K5 per card.
- ``"driver"``, otherwise: the blocks move with ``Tensor.to(mesh[r + 1])``.
  Under ``ring-overlap`` a round's copies start on side streams before its
  compute, so the transfer runs under the merge; under ``ring`` they start
  after the compute, with a sync between (the reference's compute-then-send
  schedule). When two ranks share a device the block is handed on and no
  bytes move.

The per-round merge of the driver form is the serial backend's tile loop
(``ring_fusion="xla"``, through ``knn_chunk_update``) or the fused block
merge of ``ops/fused_ring.py`` (``"fused"``: K3a, K3b), on an f32, bf16 or
int8 wire. Where the merge is exact (K3a, K4, K5), ``RingRun`` stages the
squared norms of each rank's queries and block once per call, and each
block's norms travel with it as a fourth part of its traveler: for the
mma.sync tile by ``fused_ring.stage_wire_norms``; for the dma form on the
f32 wire by K4's prologue ``fused_rotation.stage_round_planes``, which
also writes the TF32 hi/lo planes its wgmma tile reads, and those travel
as the fifth and sixth parts. The two prologues' norms are equal bit for
bit (K4's tile is promoted every 8 deep, as the mma.sync one), so the
resumable ring's last round (K3a) may take K4's. At ``matmul_precision``
"default" / "high" every merge (K3a, K4, K5 and the xla form's product)
takes that precision; K4 then runs the mma.sync tile on every wire and
its travelers carry norms alone. Padding and tiling come from
``ring_tiles``, so the layouts are the JAX package's. ``RingRun`` holds
one call's ranks and runs its rounds; the resumable ring
(``backends/ring_resumable.py``) drives the same rounds one at a time, and
``ring_serve`` runs one serving batch's rotation against travelers staged
once by a resident index (``serve/index.py``), with the landing slots the
engine keeps per bucket.

On a 2-D (dp × ring) mesh (``parallel/mesh.make_mesh2d``) the queries
shard over every device in (dp, ring) order, and each dp group runs its
own ring, with its own transport and flag words, over its replica of the
corpus blocks (the JAX package's ``P((dp, ring))`` queries against a
corpus sharded over the ring axis only); the groups' rounds are issued in
turn, round by round. The blocking schedule is undefined there, as in the
JAX package.

Across processes (a mesh from ``parallel/mesh.make_ring_mesh`` after
``parallel/distributed.init_multihost``: every process's ranks in process
order), a process places and drives only its own ranks (``ProcessSpan``);
every process reads the whole corpus. Links inside a process keep their
transport. The one link whose successor lies in the next process moves
its traveler through the process group (``distributed.exchange``: NCCL
between processes on cards of their own, else gloo through host memory):
forward only under uni, both ways under bidir, issued before the round's
merge under overlap. In the dma form K4 still merges the resident block
and copies it, but the boundary rank's copy goes into a local outbox with
the landing slot's layout, which the process group then moves into the
next process's landing slot before the next launch (stream order; the
outbox is written again only after its send has completed). After the
last round no launch reads a landing slot, so that round's outbox stays
where it is: K4 still launches every round, and the boundary moves P − 1
times. The call returns the whole result on every process, gathered
after the rotation (``distributed.Pod.gather_seconds``). A process may
hold several ranks (cards, or one card named several times): between its
own ranks K4 keeps its in-kernel stores (peer stores between cards, plain
stores on one card), and only the boundary takes the outbox. The grid
form (K5) keeps its one launch a card, and on cards the process group
moves no block between rounds: each boundary link's kind is decided once
from the pod's hostnames (``ProcessSpan.link_kinds``). Across the processes of one
host (``"ipc"``) the last rank streams into the next process's first
landing slot over CUDA IPC (``parallel/ipc.py``); across hosts
(``"proxy"``) it streams into an outbox on its own card, and a host proxy
thread moves each hop over gloo during the launch
(``parallel/hostlink.py``). On the CPU the grid form's plain version
hands each round's block to the process group over an "ipc" link, and
runs the plain stand-in for the kernel's side of the proxy protocol
beside the same proxy over a "proxy" link.

A 2-D mesh across processes (``make_mesh2d`` in a pod) runs each dp group
as above: a group inside one process is a single-process ring there
(each group its own transport key), a group that spans processes has its
own ``ProcessSpan``; a process runs only the groups it holds ranks of.
The result is gathered across processes once, every process's ranks in
(group, rank) order, which is process order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mpi_knn_tpu_torch.backends.serial import knn_chunk_update, torch_dtype
from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.ops.fused_ring import (
    fused_block_merge,
    merges_exactly,
    stage_wire_norms,
)
from mpi_knn_tpu_torch.ops.fused_rotation import (
    fused_rotation_grid,
    fused_round_dma,
    landing_buffers,
    landing_slots,
    ring_transport,
    slot,
    stage_round_planes,
    traveler,
    uses_planes,
)
from mpi_knn_tpu_torch.ops.quant import (
    dequantize_rows,
    quantize_rows,
    row_wire_bytes,
)
from mpi_knn_tpu_torch.ops.topk import init_topk
from mpi_knn_tpu_torch.parallel import distributed
from mpi_knn_tpu_torch.parallel.hostlink import link_kind
from mpi_knn_tpu_torch.parallel.mesh import (
    RingMesh,
    as_mesh2d,
    is_mesh2d,
    make_ring_mesh,
)
from mpi_knn_tpu_torch.parallel.partition import make_global_ids, pad_rows_any
from mpi_knn_tpu_torch.shapes import ring_tiles
from mpi_knn_tpu_torch.utils.op_trace import note_transfer


def bidir_rounds(num_dev: int) -> tuple[int, int]:
    """Round plan of the bidirectional schedule: ``(rounds, bwd_limit)``.
    ``rounds = ⌊P/2⌋ + 1``; the backward traveler merges on rounds
    ``1 <= r < bwd_limit = ⌈P/2⌉``, so every block merges exactly once."""
    return num_dev // 2 + 1, -(-num_dev // 2)


def blocking_undefined_on_mesh_error(mesh_axes) -> ValueError:
    """The refusal of the blocking schedule on a multi-axis mesh, dp = 1
    included, in the JAX package's words."""
    return ValueError(
        "the blocking schedule (backend='ring' / overlap=False) is "
        f"undefined on a multi-axis mesh (axes {tuple(mesh_axes)}): the "
        "optimization barrier can pin only the rotating block there, so "
        "the requested compute-then-send sequencing would silently run as "
        "the overlap schedule. The 1-D ring is the only defined blocking "
        "A/B object — use backend='ring-overlap' with --dp, or drop --dp."
    )


def fused_blocking_undefined_error() -> ValueError:
    """The refusal of ``ring_fusion="fused"`` under the blocking schedule,
    in the JAX package's words."""
    return ValueError(
        "ring_fusion='fused' is undefined under the blocking schedule "
        "(backend='ring' / overlap=False): the fused kernel streams the "
        "next block over ICI while the current one is on the MXU — there "
        "is no compute-then-send sequencing to certify. Use "
        "backend='ring-overlap', or ring_fusion='xla' for the blocking "
        "A/B baseline."
    )


def ring_wire_bytes_per_batch(cfg: KNNConfig, c_pad: int, dim: int,
                              ring_n: int) -> int:
    """Bytes one full rotation moves between ranks, summed over ranks,
    priced at the wire type plus the int32 id row that rides along."""
    b = c_pad // ring_n
    if cfg.ring_transfer_dtype == "int8":
        row = row_wire_bytes(dim, "int8")
    else:
        itemsize = torch_dtype(cfg.ring_transfer_dtype or cfg.dtype).itemsize
        row = row_wire_bytes(dim, None, itemsize)
    block_bytes = b * row + b * 4
    if cfg.ring_schedule == "bidir":
        rounds, _ = bidir_rounds(ring_n)
        hops = 2 * (rounds - 1) * ring_n
    else:
        hops = (ring_n - 1) * ring_n
    return hops * block_bytes


def quantize_ring_block(corpus_p: torch.Tensor):
    """The int8 wire's quantization of the padded corpus, once, before the
    rotation: ((c_pad, d) int8 codes, (c_pad,) f32 scales)."""
    return quantize_rows(corpus_p, "int8")


def _mesh_devices(mesh) -> list:
    if is_mesh2d(mesh):
        raise ValueError(
            "ring serving and the resident ring index take a 1-D ring mesh; "
            "a 2-D dp×ring mesh runs through all_knn")
    if getattr(mesh, "owners", None) is not None and mesh.spans_processes():
        raise ValueError(
            "ring serving and the resident ring index run in one process; "
            "a ring mesh that spans processes runs through all_knn")
    return [torch.device(d) for d in mesh]


class ProcessSpan:
    """Where this process's ranks lie on a ring mesh that spans processes:
    ``local`` (its consecutive ranks), the ring size ``P``, and the
    processes that own the next rank past its last (``next``) and the rank
    before its first (``prev``)."""

    def __init__(self, mesh):
        self.P = len(mesh)
        self.local = mesh.local_ranks(distributed.process_index())
        self.next = mesh.owners[self.local.stop % self.P]
        self.prev = mesh.owners[(self.local.start - 1) % self.P]

    def link_kinds(self) -> tuple:
        """The kinds of the link past this process's last rank and of the
        one before its first, by the link rule
        (``parallel/hostlink.link_kind`` over the pod's hostnames):
        ("ipc" or "proxy", "ipc" or "proxy")."""
        hosts, me = distributed.pod().hosts, distributed.process_index()
        return (link_kind(hosts, me, self.next), link_kind(hosts, me, self.prev))

    def hand_on(self, leaving, arriving) -> None:
        """The grid form's plain version over an "ipc" link: ``leaving``
        to the next process and ``arriving`` from the previous one, either
        None where only the other link is "ipc"."""
        none = (None,) * 6
        self.exchange(none if leaving is None else leaving,
                      none if arriving is None else arriving, 1).wait()

    def exchange(self, leaving, arriving, shift: int):
        """Issue the boundary's move of one traveler: ``leaving`` to the
        process ``shift`` steps on, ``arriving`` (buffers of its layout)
        from the process ``shift`` steps back. Tags keep the two
        directions apart."""
        to, frm = (self.next, self.prev) if shift == 1 else (self.prev, self.next)
        tag = 0 if shift == 1 else 8
        return distributed.exchange(
            [(t, to, tag + j) for j, t in enumerate(leaving) if t is not None],
            [(t, frm, tag + j) for j, t in enumerate(arriving) if t is not None])


def ring_span(mesh):
    """The :class:`ProcessSpan` of a ring (a 1-D mesh or one dp group)
    that spans processes, else None."""
    if mesh is None or is_mesh2d(mesh) or getattr(mesh, "owners", None) is None:
        return None
    return ProcessSpan(mesh) if mesh.spans_processes() else None


def across_processes(groups) -> bool:
    """Whether a call's rings lie across the processes of a pod (its
    result is then gathered from every process)."""
    return any(getattr(g, "owners", None) is not None for g in groups) and (
        distributed.process_count() > 1)


# the parts of a traveler, in its tuple's order (the transport log's names)
TRAVELER_PARTS = ("block", "ids", "scale", "norms", "hi", "lo")


class _Transport:
    """Moves every rank's traveler to the rank ``shift`` steps on. Under
    overlap a copy between two cards runs on side streams, started before
    the round's compute; ``land`` makes the receivers' streams wait for it.
    Under blocking the copies wait for every device's compute. With a
    ``span`` the traveler that leaves the process goes through the
    process group, and ``land`` waits for what arrives."""

    def __init__(self, devices, overlap: bool, span=None):
        self.devices = devices
        self.overlap = overlap
        cards = {d for d in devices if d.type == "cuda"}
        self.side = {d: torch.cuda.Stream(d) for d in cards} if overlap else {}
        self.cards = cards
        self.landed = []
        self.span = span
        self.pending = []

    def rotate(self, travelers, shift: int):
        P = len(self.devices)
        if not self.overlap:
            for d in self.cards:
                torch.cuda.synchronize(d)
        out = [None] * P
        for r in range(P):
            dst = r + shift
            if self.span is None:
                dst %= P
            elif not 0 <= dst < P:
                continue  # leaves the process
            for part, t in zip(TRAVELER_PARTS, travelers[r]):
                if t is not None:
                    note_transfer("send", src=r, dst=dst, shift=shift, part=part,
                                  bytes=t.numel() * t.element_size())
            out[dst] = tuple(self._move(t, self.devices[r], self.devices[dst])
                             for t in travelers[r])
        if self.span is not None:
            src, dst = (P - 1, 0) if shift == 1 else (0, P - 1)
            arriving = tuple(None if t is None else
                             torch.empty_like(t, device=self.devices[dst])
                             for t in travelers[src])
            self.pending.append(self.span.exchange(travelers[src], arriving, shift))
            out[dst] = arriving
        return out

    def _move(self, t, src, dst):
        if t is None or src == dst:
            return t
        if not self.overlap:
            return t.to(dst)
        s_src, s_dst = self.side[src], self.side[dst]
        s_src.wait_stream(torch.cuda.current_stream(src))
        with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
            moved = t.to(dst, non_blocking=True)
        t.record_stream(s_src)
        self.landed.append((moved, dst))
        return moved

    def land(self):
        note_transfer("wait")
        for x in self.pending:
            x.wait()
        self.pending = []
        for d, s in self.side.items():
            torch.cuda.current_stream(d).wait_stream(s)
        for t, d in self.landed:
            t.record_stream(torch.cuda.current_stream(d))
        self.landed = []


def _merge(queries, qids, held, carry, cfg: KNNConfig, q_tile, c_tile,
           q_norms=None):
    """One rank's merge of one resident block (a traveler) into its carry."""
    blk, blk_ids, scl, b_norms = traveler(held)[:4]
    if cfg.ring_fusion == "fused":
        return fused_block_merge(queries, qids, blk, blk_ids, scl, *carry,
                                 cfg=cfg, q_tile=q_tile, c_tile=c_tile,
                                 query_norms=q_norms, block_norms=b_norms)
    if scl is not None:
        blk = dequantize_rows(blk, scl)
    blk = blk.to(queries.dtype)
    ql, dim = queries.shape
    d, i = knn_chunk_update(
        queries.reshape(-1, q_tile, dim), qids.reshape(-1, q_tile),
        blk.reshape(-1, c_tile, dim), blk_ids.reshape(-1, c_tile),
        carry[0].reshape(-1, q_tile, cfg.k), carry[1].reshape(-1, q_tile, cfg.k),
        cfg)
    return d.reshape(ql, cfg.k), i.reshape(ql, cfg.k)


def grid_off_card_error() -> ValueError:
    """The refusal of ``ring_fused_rotation="grid"`` off the cards, in the
    JAX package's words with "a CUDA card" for "TPU"."""
    return ValueError(
        "ring_fused_rotation='grid' runs the whole rotation as one "
        "kernel launch on a CUDA card with real inter-device copies and "
        "cannot be emulated on the CPU — use ring_fused_rotation="
        "'round' off a CUDA card"
    )


def grid_resumable_error() -> ValueError:
    """The resumable ring's refusal of the grid form, in the JAX package's
    words."""
    return ValueError(
        "ring_fused_rotation='grid' runs the whole rotation as ONE "
        "kernel launch — there is no per-round boundary for the "
        "resumable driver to checkpoint at; use "
        "ring_fused_rotation='round' with backend='ring-resumable'"
    )


def ring_form(cfg: KNNConfig, devices) -> str:
    """Who moves the blocks: ``"dma"`` (K4 each round), ``"grid"`` (K5,
    the whole rotation) or ``"driver"`` (``Tensor.to`` between rounds).
    The JAX package's rule (its ``backends/ring.py:211-217, 429``), with
    "every rank on a CUDA card" for "on a TPU"; the grid form off the cards
    raises as the JAX package's does off the TPU."""
    fused = cfg.ring_fusion == "fused"
    on_cards = all(torch.device(d).type == "cuda" for d in devices)
    if fused and cfg.ring_fused_rotation == "grid":
        if not on_cards:
            raise grid_off_card_error()
        return "grid"
    if (fused and cfg.ring_schedule == "uni"
            and cfg.precision_policy == "exact"
            and cfg.ring_fused_rotation == "round" and on_cards):
        return "dma"
    return "driver"


def staged_parts(cfg: KNNConfig, form: str, c_tile: int, wire_dtype) -> tuple:
    """What a ring of ``form`` reads beside each traveler's block: ("norms",)
    where the merge is exact (K3a, K4, K5), ("norms", "planes") for K4's
    wgmma tile (the dma form on the f32 wire at "highest"), else ()."""
    if not (cfg.ring_fusion == "fused" and merges_exactly(cfg, c_tile)):
        return ()
    if form == "dma" and uses_planes(wire_dtype, cfg.matmul_precision):
        return ("norms", "planes")
    return ("norms",)


def stage_travelers(parts: tuple, ts):
    """Per rank (block, ids, scale) -> the traveler (block, ids, scale,
    norms, hi, lo) with the prologue outputs ``parts`` asks for, each once:
    K4's own prologue for planes (its norms with them), else the exact
    prologue's norms."""
    if "planes" in parts:
        return [(b, i, s, n, hi, lo)
                for (b, i, s), (hi, lo, n) in zip(
                    ts, (stage_round_planes(b) for b, _, _ in ts))]
    return [(b, i, s, stage_wire_norms(b, s) if parts else None, None, None)
            for b, i, s in ts]


class RingRun:
    """One call's ring: each rank's query shard, carry and traveler(s),
    and the transport of ``form``. ``round`` runs one round of the
    schedule; ``rotation_grid`` the whole uni rotation (the grid form);
    ``rotate`` the whole schedule. Travelers are (block, ids, scale, norms,
    hi, lo): the norms are staged here, once per call, where the merge is
    exact, else None; the planes for K4's wgmma tile, else None.
    ``staged`` travelers (full 6-tuples, as ``stage_travelers`` makes them
    once for a resident index) are taken as they are, and are only ever
    read: the rounds after the first read the landing ``slots`` (per rank
    ``landing_slots`` of its traveler), made here when not given."""

    def __init__(self, cfg: KNNConfig, devices, overlap: bool, form: str,
                 q_sh, qid_sh, travelers, carries, q_tile: int, c_tile: int,
                 staged: bool = False, slots=None, group: int = 0, span=None):
        self.cfg, self.devices, self.overlap, self.form = (
            cfg, devices, overlap, form)
        self.span = span
        self.q_sh, self.qid_sh = q_sh, qid_sh
        self.carries = carries
        self.q_tile, self.c_tile = q_tile, c_tile
        self.shifts = (1, -1) if len(travelers) == 2 else (1,)
        parts = staged_parts(cfg, form, c_tile, travelers[0][0][0].dtype)
        self.q_planes = None
        if "planes" in parts:
            q_staged = [stage_round_planes(q) for q in q_sh]
            self.q_norms = [n for _, _, n in q_staged]
            self.q_planes = [(hi, lo) for hi, lo, _ in q_staged]
        else:
            self.q_norms = ([stage_wire_norms(q, None) for q in q_sh] if parts
                            else [None] * len(q_sh))

        def with_norms(ts):
            return list(ts) if staged else stage_travelers(parts, ts)

        # per direction: per rank (blk, ids, scale, norms); a backward
        # traveler that starts as the forward one shares its norms
        self.travelers = [with_norms(travelers[0])]
        if len(travelers) == 2:
            self.travelers.append(self.travelers[0] if travelers[1] is travelers[0]
                                  else with_norms(travelers[1]))
        if form == "driver":
            self.transport = _Transport(devices, overlap, span)
        else:
            grid_links = span is not None and form == "grid"
            self.transport = ring_transport(
                devices, group, boundary=span is not None,
                links=(span.next, span.prev) if grid_links else None,
                kinds=span.link_kinds() if grid_links else None)
            self.slots = (slots if slots is not None
                          else [landing_slots(*t) for t in self.travelers[0]])
            self.parity = 0
            # the boundary rank's copy-out, moved on by the process group
            self.outbox = (landing_buffers(*self.travelers[0][-1])
                           if span is not None and form == "dma" else None)

    def _merge_all(self, held):
        for r in range(len(self.devices)):
            note_transfer("merge", rank=r)
            self.carries[r] = _merge(self.q_sh[r], self.qid_sh[r], held[r],
                                     self.carries[r], self.cfg, self.q_tile,
                                     self.c_tile, self.q_norms[r])

    def _kernel_kw(self):
        return dict(c_tile=self.c_tile, exclude_self=self.cfg.exclude_self,
                    exclude_zero=self.cfg.exclude_zero,
                    zero_eps=self.cfg.zero_eps, query_norms=self.q_norms,
                    precision=self.cfg.matmul_precision)

    def round(self, merge_bwd: bool, rotate: bool, last: bool = False):
        """Merge the resident block(s), and move them on when ``rotate``
        (the dma form's ``last`` round leaves its outbox unsent)."""
        note_transfer("round", rotate=rotate, merge_bwd=merge_bwd, form=self.form)
        if self.form == "dma" and rotate:
            land = [slot(s, self.parity) for s in self.slots]
            self.carries = fused_round_dma(
                self.transport, self.q_sh, self.qid_sh, self.travelers[0],
                self.carries, land, query_planes=self.q_planes,
                outbox=self.outbox, **self._kernel_kw())
            if self.span is not None and not last:
                # the outbox into the next process's landing slot, before
                # the next launch reads it or rewrites the outbox
                self.span.exchange(self.outbox, land[0], 1).wait()
            self.travelers[0] = land
            self.parity ^= 1
            return
        if self.form == "dma":  # a last round that moves nothing: K3a
            self._merge_all(self.travelers[0])
            return

        def rotate_all():
            return [self.transport.rotate(t, s)
                    for t, s in zip(self.travelers, self.shifts)]

        if self.overlap and rotate:
            nxt = rotate_all()  # started before the compute
        self._merge_all(self.travelers[0])
        if merge_bwd:
            self._merge_all(self.travelers[1])
        if rotate:
            self.travelers = nxt if self.overlap else rotate_all()
            self.transport.land()

    def rotation_grid(self):
        span = self.span
        self.carries = fused_rotation_grid(
            self.transport, self.q_sh, self.qid_sh, self.travelers[0],
            self.carries, self.slots, **self._kernel_kw(),
            ring_size=None if span is None else span.P,
            hand_on=None if span is None else span.hand_on)

    def rotate(self):
        """The whole schedule: one K5 launch per card (grid), or its rounds
        (the dma form moves the block every round, the last included, as
        the reference's scan does, but for the last round's boundary move
        across processes, which nothing reads)."""
        rotate_groups([self])

    def schedule(self) -> list:
        """The rounds of the whole schedule: (merge_bwd, rotate) each."""
        P = len(self.devices) if self.span is None else self.span.P
        rounds, bwd_limit = (bidir_rounds(P) if self.cfg.ring_schedule == "bidir"
                             else (P, 0))
        return [(1 <= rnd < bwd_limit, self.form == "dma" or rnd < rounds - 1)
                for rnd in range(rounds)]



def rotate_groups(runs) -> None:
    """The whole schedule of every dp group's ring: one K5 launch per card
    and group (grid), or round by round, each round issued for every group
    in turn (the dma form moves the block every round, the last included,
    as the reference's scan does)."""
    if runs[0].form == "grid":
        for run in runs:
            run.rotation_grid()
        return
    rounds = runs[0].schedule()
    for rnd, (merge_bwd, rotate) in enumerate(rounds):
        for run in runs:
            run.round(merge_bwd=merge_bwd, rotate=rotate,
                      last=rnd == len(rounds) - 1)


def ring_shards(cfg: KNNConfig, corpus, queries, query_ids, devices,
                start_round: int = 0):
    """Pad and place one call's operands on a 1-D ring: returns (q_tile,
    c_tile, q_sh, qid_sh, travelers), the travelers as they stand after
    ``start_round`` rounds (rank i holds block i − r, and under bidir also
    block i + r: the padded corpus rolled r blocks each way)."""
    q_tile, c_tile, [(q_sh, qid_sh, travelers)] = ring_layout(
        cfg, corpus, queries, query_ids, [devices], start_round)
    return q_tile, c_tile, q_sh, qid_sh, travelers


def ring_layout(cfg: KNNConfig, corpus, queries, query_ids, groups,
                start_round: int = 0, local=None):
    """:func:`ring_shards` over dp groups of P devices each: the queries
    padded for dp·P shards in (group, rank) order, the corpus blocks
    replicated to every group. Returns (q_tile, c_tile, per group (q_sh,
    qid_sh, travelers)), each a list over the group's ranks ``local[g]``
    (default every rank: across processes, the ranks this process owns;
    empty for a group it holds none of)."""
    dp, P = len(groups), len(groups[0])
    m, dim = corpus.shape
    nq = queries.shape[0]
    q_tile, c_tile, q_pad, c_pad = ring_tiles(cfg, m, nq, dp, P)
    dtype = torch_dtype(cfg.dtype)
    b, ql = c_pad // P, q_pad // (dp * P)
    shift = start_round * b

    corpus_p = pad_rows_any(corpus, c_pad, dtype=dtype)
    ids = torch.from_numpy(make_global_ids(m, c_pad))

    def wire_rows(s):
        rows = torch.roll(corpus_p, s, 0) if s else corpus_p
        rid = torch.roll(ids, s, 0) if s else ids
        scale = None
        if cfg.ring_transfer_dtype == "int8":
            rows, scale = quantize_ring_block(rows)
        elif cfg.ring_transfer_dtype is not None:
            rows = rows.to(torch_dtype(cfg.ring_transfer_dtype))
        return rows, rid, scale

    def traveler_blocks(wire, devices, ranks):
        rows, rid, scale = wire
        return [(rows[r * b:(r + 1) * b].to(devices[r]),
                 rid[r * b:(r + 1) * b].to(devices[r]),
                 None if scale is None else scale[r * b:(r + 1) * b].to(devices[r]))
                for r in ranks]

    fwd = wire_rows(shift)
    bwd = wire_rows(-shift) if cfg.ring_schedule == "bidir" and shift else None
    queries_p = pad_rows_any(queries, q_pad, dtype=dtype)
    qids_p = pad_rows_any(np.asarray(query_ids, dtype=np.int32), q_pad,
                          fill=-1)
    out = []
    for g, devices in enumerate(groups):
        ranks = range(P) if local is None else local[g]
        travelers = [traveler_blocks(fwd, devices, ranks)]
        if cfg.ring_schedule == "bidir":
            travelers.append(traveler_blocks(bwd, devices, ranks) if bwd is not None
                             else travelers[0])
        base = g * P
        q_sh = [queries_p[(base + r) * ql:(base + r + 1) * ql].to(devices[r])
                for r in ranks]
        qid_sh = [qids_p[(base + r) * ql:(base + r + 1) * ql].to(devices[r])
                  for r in ranks]
        out.append((q_sh, qid_sh, travelers))
    return q_tile, c_tile, out


def ring_mesh(cfg: KNNConfig, mesh, dev):
    """The call's mesh: ``mesh``, or ``num_devices`` ranks (every
    process's, in a pod of processes)."""
    if mesh is None:
        mesh = make_ring_mesh(cfg.num_devices, axis_name=cfg.mesh_axis,
                              device=dev)
    return mesh if isinstance(mesh, RingMesh) else RingMesh(mesh, cfg.mesh_axis)


def ring_devices(cfg: KNNConfig, mesh, dev) -> list:
    return _mesh_devices(ring_mesh(cfg, mesh, dev))


def ring_groups(cfg: KNNConfig, mesh, dev, overlap: bool) -> list:
    """The dp groups a ring call runs, each a :class:`RingMesh` (one group
    on a 1-D mesh; across processes each with its owners). The blocking
    schedule on a 2-D mesh raises, dp = 1 included."""
    if not is_mesh2d(mesh):
        return [ring_mesh(cfg, mesh, dev)]
    mesh = as_mesh2d(mesh)
    if not overlap:
        raise blocking_undefined_on_mesh_error(mesh.axis_names)
    return list(mesh)


def local_ranks(groups) -> list:
    """Per group, the ranks this process drives (every rank in one
    process; none of a group that lies in other processes)."""
    return [g.local_ranks(distributed.process_index()) for g in groups]


def group_runs(groups):
    """(g, this process's devices, span) of every group this process holds
    ranks of."""
    for g, (mesh, ranks) in enumerate(zip(groups, local_ranks(groups))):
        if len(ranks):
            yield g, [torch.device(mesh[r]) for r in ranks], ring_span(mesh)


def all_knn_ring(corpus, queries, query_ids, cfg: KNNConfig, mesh=None,
                 overlap: bool = True, device=DEFAULT_DEVICE, form=None):
    """Pad and shard corpus and queries over the ring (each dp group's ring
    on a 2-D mesh), rotate, gather the carries. ``form`` overrides
    ``ring_form`` (the CPU tests run the dma and grid forms over logical
    ranks on the kernels' plain versions). On a mesh that spans processes
    each process drives its own ranks and every process returns the whole
    result. Returns ((q, k) dists, (q, k) ids) on ``device``."""
    dev = torch.device(device)
    groups = ring_groups(cfg, mesh, dev, overlap)
    if cfg.ring_fusion == "fused" and not overlap:
        raise fused_blocking_undefined_error()
    form = form or ring_form(cfg, groups[0])
    q_tile, c_tile, parts = ring_layout(cfg, corpus, queries, query_ids, groups,
                                        local=local_ranks(groups))
    acc = torch.float64 if torch_dtype(cfg.dtype) == torch.float64 else torch.float32
    runs = []
    for g, devices, span in group_runs(groups):
        q_sh, qid_sh, travelers = parts[g]
        carries = [init_topk(q.shape[0], cfg.k, dtype=acc, device=d)
                   for q, d in zip(q_sh, devices)]
        runs.append(RingRun(cfg, devices, overlap, form, q_sh, qid_sh,
                            travelers, carries, q_tile, c_tile, group=g,
                            span=span))
    rotate_groups(runs)
    return gathered(runs, dev, queries.shape[0], across_processes(groups))


def gathered(runs, dev, nq: int, across: bool = False):
    """Every group's carries in (group, rank) order, cut to ``nq`` rows;
    ``across`` processes, every process's, gathered on each (process
    order is (group, rank) order: a process's ranks are consecutive)."""
    best_d = torch.cat([c[0].to(dev) for run in runs for c in run.carries])
    best_i = torch.cat([c[1].to(dev) for run in runs for c in run.carries])
    if across:
        t0 = time.perf_counter()
        best_d = distributed.all_gather_rows(best_d)
        best_i = distributed.all_gather_rows(best_i)
        distributed.pod().gather_seconds = time.perf_counter() - t0
    return best_d[:nq], best_i[:nq]


def ring_serve(q_sh, qid_sh, carries, shards, cfg: KNNConfig, devices,
               overlap: bool, q_tile: int, c_tile: int, slots=None):
    """One serving batch's full rotation against a corpus that stays
    sharded across batches (the JAX package's ``ring_serve_sharded``):
    batch-owned shards and carries first, the resident index after.
    ``shards`` are per rank the travelers ``stage_travelers`` staged once
    at build; they are only read (the dma and grid forms copy them into
    ``slots``, per rank ``landing_slots`` of its traveler, which the
    engine keeps per bucket). ``carries`` are read, never written. Returns
    the per-rank final carries."""
    if cfg.ring_fusion == "fused" and not overlap:
        raise fused_blocking_undefined_error()
    form = ring_form(cfg, devices)
    travelers = [shards]
    if cfg.ring_schedule == "bidir":
        travelers.append(shards)
    run = RingRun(cfg, devices, overlap, form, q_sh, qid_sh, travelers,
                  list(carries), q_tile, c_tile, staged=True, slots=slots)
    run.rotate()
    return run.carries
