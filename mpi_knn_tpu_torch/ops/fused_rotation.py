"""The ring's in-kernel transport: the wrappers of the two Hopper kernels in
``csrc/fused_ring_dma.cu``, their plain PyTorch versions, and the per-mesh
barrier state they share.

- ``fused_round_dma`` replaces ``mpi_knn_tpu/ops/pallas_ring.py::
  fused_round_dma`` (K4): one ring round for every rank of a mesh. Each
  rank merges its resident block into its carry exactly (K3a's merge), and
  the same launch copies the block, its ids and (int8 wire) its scales into
  the landing buffers of the rank's ring successor.
- ``fused_rotation_grid`` replaces ``fused_rotation_grid`` (K5): the whole
  P-round uni rotation in one launch per card, over two slots per rank;
  float wires only.

Both take ``precision`` (the config's ``matmul_precision``), counted as
``fused_round_dma[default]`` and so on. On the f32 wire at "default" and
"high" both run ``csrc/knn_wgmma_bf16.cuh``'s bf16 wgmma tile (one pass on
the RNE planes, or the lo.hi + hi.lo passes then hi.hi on the hi / lo
planes) with K3a's merge; on the other wires, and K5 at "highest", K3a's
mma.sync tile at the precision.

A rank's traveler is (block, ids, scale or None, norms or None, hi or
None, lo or None): the norms are the exact prologue's squared norms of the
decoded block, made once per call and moved with the block by the kernels
themselves, as its ids are. On the f32 wire K4 reads planes of the
queries and of the block by TMA, and the block's travel with it: at
"highest" the TF32 hi/lo planes of ``stage_round_planes`` (K4's tile is
``csrc/knn_wgmma.cuh``'s), at "default" / "high" the bf16 planes of
``fused_knn.stage_planes`` (lo None at "default"), each prologue with its
norms (``stage_ring_planes`` picks). On the other wires, and in K5, the
norms come from ``fused_ring.stage_wire_norms`` and the planes are None:
K5 at "default" / "high" writes the planes of each round's block (and of
its queries) into a scratch of its own on each card, so its slots and
what crosses cards or processes stay the f32 wire's. A traveler without
what its kernel reads is staged by the wrapper (one prologue launch), and
the queries likewise (``query_norms``, ``query_planes``). The plain
versions compute their own norms in f32 and copy whatever the traveler
holds.

A process drives every rank of its ring, or, on a ring that spans
processes, its own ranks. A launch covers every rank its card holds,
so a round of K4 is one launch per distinct card (``launches = rounds ×
cards`` in each process) and K5 is one launch per card. Where the last
rank's successor lies in another process (``RingTransport(boundary=
True)``), K4 stores that rank's copy into a local ``outbox`` with the
landing slot's layout (``landing_buffers``), in stream order on its card,
and the caller's process group moves it on; the other links keep the
in-kernel stores and flags. K5's transport across processes
(``RingTransport(links=(next, prev), kinds=(next kind, prev kind))``)
keeps the in-kernel protocol on both boundary links. The link kind is
decided once from the pod's hostnames (``parallel/hostlink.link_kind``):
an ``"ipc"`` link (the neighbour on this host) stores into the next
process's first rank's landing slots and signals its flag words through
pointers mapped by CUDA IPC (``parallel/ipc.py``), and the first rank's
slots and the first and last ranks' flag words are this process's
exports; a ``"proxy"`` link (the neighbour on another host) points the
last rank's stores at an outbox of two slots and its remote adds at a
mirror row, both on its own card, points the first rank's remote adds at
a mirror row on its card, and lands into the caller's slots, while a
host proxy thread carries each hop over gloo during the launch
(``parallel/hostlink.py``). Such a transport's flag words are made once
and never made anew: a timed-out wait fails the pod. The plain version
across processes (CPU pods) hands each round's outgoing block to the
process group over an ``"ipc"`` link (``hand_on``), and runs the plain
stand-in for the kernel's side of the proxy protocol
(``fused_rotation_grid_proxy_reference``) beside the same proxy where a
link is a ``"proxy"`` one.
The flag words the kernels signal
each other through live on each card and are made once per mesh
(``ring_transport``); they only count up, so nothing is reset between calls.
A timed-out wait inside a kernel raises ``RuntimeError`` here once the
card's stream has synchronized, and the mesh's words are made anew.

A wrapper takes its plain version only because the tensors it was given lie
on the CPU; for CUDA tensors it launches the kernel or raises. Each launch
adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.ops.distance import precision_code, resolve_precision
from mpi_knn_tpu_torch.ops.fused_knn import (
    PRECISION_FORMS,
    split_width,
    stage_planes,
    stage_tf32_split_reference,
    staged_width,
)
from mpi_knn_tpu_torch.ops.fused_ring import (
    _WIRE,
    _check,
    block_merge_exact_reference,
    stage_wire_norms,
)
from mpi_knn_tpu_torch.utils.op_trace import note_launch, tensor_bytes

LAUNCHES = {"fused_round_dma": 0, "fused_rotation_grid": 0,
            "fused_round_dma[default]": 0, "fused_rotation_grid[default]": 0,
            "fused_round_dma[high]": 0, "fused_rotation_grid[high]": 0,
            "stage_tf32_split[ring]": 0}

TIMEOUT_S = 10.0  # bound of every spin-wait inside the kernels

# the ring's protocol, stated once on this side (csrc/fused_ring_dma.cu's
# COPY_CTAS and enum Word; ``_lib`` checks them against the built library)
COPY_CTAS = 8  # K5's copy items a hop, each one landed add
NWORDS = 16    # flag words of one rank
W_ERR, G_FROM_PRED, G_FROM_SUCC, G_LANDED, G_FREE = 5, 6, 7, 8, 9
PROTOCOL = (COPY_CTAS, NWORDS, W_ERR, G_FROM_PRED, G_FROM_SUCC, G_LANDED, G_FREE)
ERR_PROXY = 6  # the card's error word after a host proxy's failure
_ERRORS = {1: "the neighbour barrier", 2: "the predecessor's block to land",
           3: "its own copy-out", 4: "the barrier CTA", 5: "a slot release",
           ERR_PROXY: "the host proxy"}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Rank(ctypes.Structure):
    """csrc/fused_ring_dma.cu's ``struct Rank``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "qids", "blk", "scale", "bids", "carry_d", "carry_i", "out_d",
        "out_i", "dst_blk", "dst_scale", "dst_bids", "flags", "succ_flags",
        "pred_flags", "slot_blk", "slot_bids", "cbuf_d", "cbuf_i", "qn", "bn",
        "dst_bn", "slot_bn", "qh", "ql", "bh", "bl", "dst_bh", "dst_bl",
        "sbn")] + [
        ("succ_remote", ctypes.c_int), ("pred_remote", ctypes.c_int)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, with its C signatures set once at first load."""
    return configure(_build.load("fused_ring_dma"))


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of csrc/fused_ring_dma.cu and check
    its Rank layout and protocol against this module's."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("round_dma_launch", "rotation_grid_launch"):
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] + [i32] * 9 + [ctypes.c_float, i32,
                                            ctypes.c_longlong, ptr, i32, ptr])
        fn.restype = i32
    lib.round_stage_split_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.ring_enable_peer_access.argtypes = [i32, i32]
    lib.ring_kernel_plan.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    lib.ring_protocol.argtypes = [ctypes.POINTER(i32)]
    for name in ("ring_enable_peer_access", "ring_max_local", "ring_protocol",
                 "ring_rank_bytes", "ring_kernel_plan", "round_stage_split_launch"):
        getattr(lib, name).restype = i32
    if lib.ring_rank_bytes() != ctypes.sizeof(_Rank):
        raise RuntimeError("csrc/fused_ring_dma.cu's Rank and _Rank differ")
    built = (ctypes.c_int * len(PROTOCOL))()
    if lib.ring_protocol(built) != len(PROTOCOL) or tuple(built) != PROTOCOL:
        raise RuntimeError("csrc/fused_ring_dma.cu's COPY_CTAS and flag words "
                           f"{tuple(built)} differ from PROTOCOL {PROTOCOL}")
    return lib


def _card(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class RingTransport:
    """The barrier state of one ring mesh: which ranks each card holds,
    which ring links cross cards, and the flag words on each card.

    ``cross_card[r]`` says whether rank r reaches its successor through the
    cross-card protocol (barrier, system-scope flags). By default a link
    crosses where the two ranks' cards differ; naming it for ranks on one
    card runs the same protocol within the card. With ``boundary`` the
    ranks are one process's part of a longer ring: the last rank's
    successor and the first rank's predecessor lie in other processes, so
    that link takes no flags (K4 writes an outbox on the last rank's card,
    and the process group fills the first rank's landing slot). K5's
    boundary transport has ``links`` (the next and previous processes) and
    their ``kinds`` ("ipc" or "proxy" each, the module's docstring).
    """

    def __init__(self, devices, cross_card=None, boundary: bool = False,
                 links=None, kinds=None):
        self.devices = [_card(torch.device(d)) for d in devices]
        P = len(self.devices)
        if cross_card is None:
            cross_card = [self.devices[r] != self.devices[(r + 1) % P]
                          for r in range(P)]
        if links is not None and not boundary:
            raise ValueError("links to other processes go with a boundary transport")
        if boundary:
            # K5 across processes keeps the flag protocol on the boundary
            # link (mapped pointers, or a proxy's buffers); K4 hands that
            # link to an outbox
            cross_card = list(cross_card[:P - 1]) + [links is not None]
        self.boundary = boundary
        self.links = links  # (next process, previous process), or None
        self.kinds = (None if links is None
                      else tuple(kinds) if kinds is not None else ("ipc", "ipc"))
        if self.kinds is not None and not set(self.kinds) <= {"ipc", "proxy"}:
            raise ValueError(f"a link is 'ipc' or 'proxy', got {self.kinds}")
        self.mapped = {}  # per slot layout: (own first-rank slots, successor's)
        self.remote_flags = None  # (successor's words, predecessor's words)
        self.mirror = (None, None)  # a proxy link's rows: (next side, prev side)
        self.outboxes = {}  # a proxy link's outbox, per layout
        self.succ_remote = [bool(c) for c in cross_card]
        self.pred_remote = [self.succ_remote[(r - 1) % P] for r in range(P)]
        self.cards = list(dict.fromkeys(self.devices))
        self.local = {c: [r for r in range(P) if self.devices[r] == c]
                      for c in self.cards}
        self.flags = None
        self.epoch = 0   # K4 rounds run on this mesh
        self.calls = 0   # K5 launches per card run on this mesh

    def proxied(self, side: int) -> bool:
        """Whether the link past the last rank (side 0) or before the first
        (side 1) is a proxy link."""
        return self.kinds is not None and self.kinds[side] == "proxy"

    def _ensure_flags(self):
        if self.flags is not None:
            return
        from mpi_knn_tpu_torch.parallel.mesh import enable_peer_access

        on_cards = all(c.type == "cuda" for c in self.cards)
        if on_cards:
            lib = _lib()
            for card in self.cards:
                if len(self.local[card]) > lib.ring_max_local():
                    raise ValueError(
                        f"{card} holds {len(self.local[card])} ring ranks; one "
                        f"launch takes at most {lib.ring_max_local()}")
            enable_peer_access(self.devices)
        if self.links is not None and self.calls:
            raise RuntimeError(
                "the grid form's flag words across processes are made once: "
                "a timed-out wait fails the pod; restart every process")
        if self.links is None or "ipc" not in self.kinds or not on_cards:
            self.flags = {c: torch.zeros((len(self.local[c]), NWORDS),
                                         dtype=torch.int32, device=c)
                          for c in self.cards}
        else:
            from mpi_knn_tpu_torch.parallel import ipc

            self.flags = {}
            for c in self.cards:
                shape = (len(self.local[c]), NWORDS)
                buf = ipc.alloc(c, ipc.carved_bytes([(shape, torch.int32)]))
                self.flags[c] = ipc.carve(buf, [(shape, torch.int32)])[0]
                self.flags[c].zero_()
        if self.links is not None:
            # a proxy link's mirror rows: the adds the kernel makes to a
            # neighbour's words, on the card of the rank that makes them
            self.mirror = tuple(
                torch.zeros(NWORDS, dtype=torch.int32, device=dev)
                if self.proxied(side) else None
                for side, dev in ((0, self.devices[-1]), (1, self.devices[0])))
            for c in self.cards:
                if c.type == "cuda":  # zero before any neighbour can signal
                    torch.cuda.synchronize(c)
        self.epoch = self.calls = 0

    def flag_row(self, r: int) -> torch.Tensor:
        """Rank r's flag words (a row of its card's table)."""
        card = self.devices[r]
        return self.flags[card][self.local[card].index(r)]

    def bind_links(self, own, block, ids, norms):
        """For K5 across processes on cards: the first rank's two landing
        slots and the successor's, per link kind. Over an "ipc" link the
        first rank's slots are exported (made once per layout) and the
        successor process's are pointers mapped into the last rank's card;
        the handles move between the neighbours once per layout
        (``parallel/ipc.py``). Over a "proxy" link the first rank lands into
        ``own`` (the caller's slots) and the last rank stores into this
        transport's outbox (made once per layout, ``outbox``). Returns
        (own slots (blk, ids, None, norms), successor's (blk, ids, norms)
        pointers or tensors)."""
        from mpi_knn_tpu_torch.parallel import distributed, ipc

        key = (tuple(block.shape), block.dtype)
        if key not in self.mapped:
            self._ensure_flags()
            parts = [((2,) + tuple(block.shape), block.dtype),
                     ((2,) + tuple(ids.shape), ids.dtype),
                     ((2,) + tuple(norms.shape), norms.dtype)]
            first, last = self.devices[0], self.devices[-1]
            nxt, prv = self.links
            sends, recvs = [], []
            exported = succ = None
            if not self.proxied(1):
                exported = ipc.carve(ipc.alloc(first, ipc.carved_bytes(parts)), parts)
                from_prev = ipc.empty_records(1)
                sends.append((ipc.pack([self.flag_row(0)] + exported), prv, 100))
                recvs.append((from_prev, prv, 101))
            if not self.proxied(0):
                from_next = ipc.empty_records(4)
                last_row = self.flag_row(len(self.devices) - 1)
                sends.append((ipc.pack([last_row]), nxt, 101))
                recvs.append((from_next, nxt, 100))
            distributed.swap_host(sends, recvs)
            if self.proxied(0):
                succ = self.outbox(block, ids, norms)
                succ_words = self.mirror[0].data_ptr()
            else:
                mapped = ipc.open_records(from_next, last)
                succ, succ_words = tuple(mapped[1:]), mapped[0]
            pred_words = (self.mirror[1].data_ptr() if self.proxied(1)
                          else ipc.open_records(from_prev, first)[0])
            self.remote_flags = (succ_words, pred_words)
            self.mapped[key] = (None if exported is None else _as_traveler(exported),
                                succ)
        exported, succ = self.mapped[key]
        return (tuple(own[:4]) if exported is None else exported), succ

    def outbox(self, *parts):
        """The outbox of a proxy link past the last rank: two slots in the
        layout of ``parts`` (block, ids, norms) on the last rank's device
        (where its stores and the proxy's copy out run), made once per
        layout."""
        key = tuple((tuple(t.shape), t.dtype) for t in parts)
        if key not in self.outboxes:
            self.outboxes[key] = tuple(
                torch.empty((2,) + tuple(t.shape), dtype=t.dtype,
                            device=self.devices[-1]) for t in parts)
        return self.outboxes[key]

    def succ_words(self, r: int):
        """Address of rank r's successor's flag words."""
        if self.links is not None and r == len(self.devices) - 1:
            return self.remote_flags[0]
        return self.words((r + 1) % len(self.devices))

    def pred_words(self, r: int):
        """Address of rank r's predecessor's flag words."""
        if self.links is not None and r == 0:
            return self.remote_flags[1]
        return self.words((r - 1) % len(self.devices))

    def words(self, r: int) -> int:
        """Address of rank r's flag words."""
        return self.flag_row(r).data_ptr()

    def raise_on_error(self, name: str):
        """Read each card's error word (this waits for its stream); on an
        error drop the flag words, so the next call starts from zero."""
        for card in self.cards:
            code = int(self.flags[card][0, W_ERR].item())
            if code:
                self.flags = None
                raise RuntimeError(
                    f"{name}: neighbour barrier timed out on {card} "
                    f"(waiting for {_ERRORS.get(code, code)}); " + (
                        "the ring's flag words were reset" if self.links is None
                        else _POD_FAILS))

    def host_proxy(self, landing, outbox, ring_size: int, timeout_s: float):
        """The host proxy of this call (``parallel/hostlink.py``) over the
        proxy links, or None where both links are "ipc". ``landing`` /
        ``outbox``: the first rank's slots and the last rank's outbox, each
        (blk, ids, norms) of (2, ...) tensors."""
        if not (self.proxied(0) or self.proxied(1)):
            return None
        from mpi_knn_tpu_torch.parallel import distributed, hostlink

        nxt, prv = self.links
        pod = distributed.pod()
        where = (f"process {distributed.process_index()} of the pod at "
                 f"{pod.coordinator} ({pod.num_processes} processes)"
                 if pod is not None else "this process")
        return hostlink.HostProxy(
            nxt=nxt if self.proxied(0) else None,
            prv=prv if self.proxied(1) else None,
            outbox=outbox if self.proxied(0) else None,
            landing=landing if self.proxied(1) else None, mirror=self.mirror,
            last_row=self.flag_row(len(self.devices) - 1),
            first_row=self.flag_row(0),
            err_words=[self.flags[c][0] for c in self.cards], G=self.calls,
            P=ring_size, timeout_s=timeout_s, where=where)

    def fail_proxy(self, name: str, e: Exception):
        """A proxy that failed: the flag words are dropped (the next call
        on this transport is refused: the pod restarts) and ``name`` raises
        on every process of the pod."""
        self.flags = None
        raise RuntimeError(f"{name}: {e}; {_POD_FAILS}") from e


_POD_FAILS = ("the ring spans processes: every process of the pod fails, and "
              "the pod restarts")


_TRANSPORTS: dict = {}


def ring_transport(devices, group: int = 0, boundary: bool = False,
                   links=None, kinds=None) -> RingTransport:
    """The ring's transport state, made once per ring: per mesh and, on a
    2-D mesh, per dp group (each group's ring has flag words of its own,
    even where two groups name the same cards); ``boundary`` for one
    process's ranks of a ring that spans processes, and ``links`` (the
    next and previous processes) with their ``kinds`` for K5's transport
    across them."""
    cards = tuple(_card(torch.device(d)) for d in devices)
    links = None if links is None else tuple(links)
    kinds = None if links is None else tuple(kinds or ("ipc", "ipc"))
    key = (group, cards, boundary or links is not None, links, kinds)
    if key not in _TRANSPORTS:
        _TRANSPORTS[key] = RingTransport(cards, boundary=key[2], links=links,
                                         kinds=kinds)
    return _TRANSPORTS[key]


def drop_process_transports() -> None:
    """Forget every transport with links to other processes (their flag
    words and slots are this process's, exported over an "ipc" link and
    freed at the pod's end)."""
    for key in [k for k, t in _TRANSPORTS.items() if t.links is not None]:
        del _TRANSPORTS[key]


def traveler(t):
    """A traveler as (block, ids, scale, norms, hi, lo), each of the last
    four None where it has none."""
    t = tuple(t)
    return t + (None,) * (6 - len(t))


def landing_slots(block, ids, scale, norms=None, hi=None, lo=None):
    """Two landing slots in the layout of one rank's traveler: ((2, b, d)
    block, (2, b) ids, (2, b) scales, (2, b) norms, (2, b, dp) planes hi
    and lo, each None where the traveler has none), on its device."""
    def two(t):
        return None if t is None else t.new_empty((2,) + tuple(t.shape))

    return tuple(two(t) for t in (block, ids, scale, norms, hi, lo))


def landing_buffers(block, ids, scale, norms=None, hi=None, lo=None):
    """One landing slot's buffers in the layout of a traveler: a traveler
    of empty tensors (None where it has none), on its device. K4's outbox
    at a process boundary."""
    return tuple(None if t is None else torch.empty_like(t)
                 for t in (block, ids, scale, norms, hi, lo))


def slot(slots, i: int):
    """Slot i of ``landing_slots``: a traveler, each part None where the
    slots have none."""
    return tuple(None if t is None else t[i] for t in traveler(slots))


def stage_round_planes(rows):
    """K4's prologue on an f32 (n, d) row set -> (hi, lo, norms): the TF32
    planes ((n, split_width(d)) f32, x = hi + lo, zero past d) and the (n,)
    f32 squared norms, on the card the diagonal of K4's own wgmma tile
    (8-deep promotion, built in ``csrc/fused_ring_dma.cu``)."""
    if rows.dtype != torch.float32 or rows.ndim != 2 or not rows.is_contiguous():
        raise TypeError("rows must be a contiguous 2-D float32 tensor")
    n, d = rows.shape
    width = split_width(d)
    if rows.device.type == "cpu":
        return stage_tf32_split_reference(rows, width)
    hi, lo = (torch.empty((n, width), dtype=torch.float32, device=rows.device)
              for _ in range(2))
    norms = torch.empty(n, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().round_stage_split_launch(rows.data_ptr(), hi.data_ptr(),
                                             lo.data_ptr(), norms.data_ptr(), n,
                                             d, width, stream)
    if rc != 0:
        raise RuntimeError(f"stage_tf32_split[ring] launch failed: cudaError {rc}")
    note_launch(LAUNCHES, "stage_tf32_split[ring]", lambda: dict(
        operands=(rows,), outputs=(hi, lo, norms), precision="tf32-split",
        bytes=tensor_bytes(rows, hi, lo, norms)))
    return hi, lo, norms


def stage_ring_planes(rows, precision=None):
    """K4's prologue on the f32 wire at ``precision`` -> (hi, lo, norms):
    at "highest" ``stage_round_planes`` (TF32 planes), at "default" /
    "high" ``fused_knn.stage_planes`` (bf16 planes of pitch
    ``staged_width(d)``, lo None at "default", and the f32 norms of
    ``stage_norms``)."""
    p = resolve_precision(precision)
    return stage_round_planes(rows) if p == "highest" else stage_planes(rows, p)


def kernel_name(base: str, precision=None) -> str:
    """The launch-count name of K4 or K5 (``base``) at a matmul precision."""
    p = resolve_precision(precision)
    return base if p == "highest" else f"{base}[{p}]"


def uses_planes(wire_dtype) -> bool:
    """Whether K4 runs a wgmma tile on planes its travelers carry: the f32
    wire, at every precision (TF32 hi/lo at "highest", bf16 at "default" /
    "high")."""
    return wire_dtype == torch.float32


def ring_kernel_plan(which: str, wire_dtype, n_local: int, q_local: int,
                     k: int, precision=None) -> dict:
    """The launch plan of K4 (``which="round"``) or K5 (``"grid"``) over
    n_local ranks on the current card: query rows per merge group (the
    wgmma forms: 128; K4's others 128, or 64 where 128-row groups would not
    fill the card's resident slots; K5's mma.sync forms: 64), the grid
    (persistent for the wgmma forms and K5), the items per round (merge
    items, plus copy items
    where CTAs or work items take them), the kernel's registers, spilled
    bytes a thread and CTAs per SM, the copy units per round, whether the
    tile is a wgmma one, and the dynamic shared bytes a CTA."""
    out = (ctypes.c_int * 9)()
    rc = _lib().ring_kernel_plan(0 if which == "round" else 1, _WIRE[wire_dtype],
                                 precision_code(precision), n_local, q_local, k, out)
    if rc != 0:
        raise RuntimeError(f"ring_kernel_plan failed: cudaError {rc}")
    return dict(zip(("rows_per_group", "grid", "items_per_round", "registers",
                     "spilled_bytes", "ctas_per_sm", "copy_units", "wgmma_tile",
                     "smem_bytes"), out))


def _ptr(t):
    """A tensor's address (an int is one already: a mapped pointer)."""
    return None if t is None else t if isinstance(t, int) else t.data_ptr()


def _check_ring(queries, query_ids, blocks, carries):
    """Validates one call's operands (travelers as ``traveler`` makes
    them); returns whether they lie on the CPU."""
    P = len(queries)
    if not (len(query_ids) == len(blocks) == len(carries) == P >= 1):
        raise ValueError("one query shard, block and carry per rank")
    on_cpu = [q.device.type == "cpu" for q in queries]
    if any(on_cpu) and not all(on_cpu):
        raise ValueError("a ring's ranks lie all on the CPU or all on cards")
    for r in range(P):
        blk, ids, scl = blocks[r][:3]
        _check(queries[r], query_ids[r], blk, ids, scl)
        cd, ci = carries[r]
        if (cd.dtype != torch.float32 or ci.dtype != torch.int32
                or cd.shape != ci.shape or cd.shape[0] != queries[r].shape[0]
                or cd.device != queries[r].device):
            raise TypeError("each carry must be (q_local, k) float32 and int32 "
                            "on its rank's device")
    shapes = {(q.shape, b[0].shape, b[0].dtype, c[0].shape)
              for q, b, c in zip(queries, blocks, carries)}
    if len(shapes) != 1:
        raise ValueError("every rank's shard, block and carry must match")
    return all(on_cpu)


def _check_landing(blocks, landing):
    """The landing buffers match the predecessor's traveler (block, ids,
    scale); a norms or plane buffer, where there is one, matches its
    counterpart."""
    P = len(blocks)
    for r in range(P):
        want = blocks[(r - 1) % P]
        got = landing[r]
        for j, (w, g) in enumerate(zip(want, got)):
            if j >= 3 and (w is None or g is None):
                continue
            if (w is None) != (g is None) or (w is not None and (
                    g.shape != w.shape or g.dtype != w.dtype
                    or not g.is_contiguous())):
                raise ValueError(
                    "landing buffers must match the predecessor's traveler")


def _card_norms(queries, blocks, query_norms):
    """On cards, for the mma.sync tile: the query norms and every
    traveler's block norms, staged where the caller has none."""
    qn = (list(query_norms) if query_norms is not None
          else [stage_wire_norms(q, None) for q in queries])
    blocks = [b if b[3] is not None
              else b[:3] + (stage_wire_norms(b[0], b[2]),) + b[4:]
              for b in blocks]
    return qn, blocks


def _plane_form(d: int, precision):
    """The planes of K4's prologue at ``precision`` for rows of width d:
    (dtype, pitch, whether lo is staged)."""
    p = resolve_precision(precision)
    if p == "highest":
        return torch.float32, split_width(d), True
    return torch.bfloat16, staged_width(d), p == "high"


def _check_staged(rows, norms, hi, lo, precision=None):
    """K4's prologue outputs for ``rows`` at ``precision``: (n,) float32
    norms and (n, pitch) planes (``_plane_form``; lo None at "default"),
    contiguous on the rows' device."""
    n, d = rows.shape
    dtype, width, two = _plane_form(d, precision)
    parts = [(norms, torch.float32, (n,)), (hi, dtype, (n, width))]
    if two:
        parts.append((lo, dtype, (n, width)))
    elif lo is not None:
        raise TypeError("the \"default\" planes have no lo plane")
    for t, want, shape in parts:
        if (t is None or t.dtype != want or tuple(t.shape) != shape
                or t.device != rows.device or not t.is_contiguous()):
            raise TypeError(f"K4's staged norms and planes at {resolve_precision(precision)!r} "
                            f"must be contiguous float32 (n,) and {dtype} (n, {width}) "
                            f"on {rows.device}")


def _card_planes(queries, blocks, query_norms, query_planes, precision=None):
    """On cards, for K4's wgmma tiles: the query planes and norms and every
    traveler's planes and norms at ``precision``, staged by its prologue
    (``stage_ring_planes``) where the caller has none."""
    two = _plane_form(1, precision)[2]
    if query_planes is None:
        staged = [stage_ring_planes(q, precision) for q in queries]
        query_planes = [s[:2] for s in staged]
        query_norms = [s[2] for s in staged]
    if query_norms is None:
        raise TypeError("query_planes need the query_norms of the same prologue")
    for q, n, (hi, lo) in zip(queries, query_norms, query_planes):
        _check_staged(q, n, hi, lo, precision)
    out = []
    for b in blocks:
        if b[4] is None or (two and b[5] is None) or b[3] is None:
            hi, lo, norms = stage_ring_planes(b[0], precision)
            b = b[:3] + (norms, hi, lo)
        _check_staged(b[0], *b[3:], precision)
        if b[3].data_ptr() % 16 and resolve_precision(precision) != "highest":
            # the bf16 tile loads the norms by TMA, from a 16-byte boundary:
            # the second of two landing slots lies off one when the block's
            # rows are no multiple of 4 (never at ring_tiles' main shapes)
            b = b[:3] + (b[3].clone(),) + b[4:]
        out.append(b)
    return list(query_norms), list(query_planes), out


# ---------------------------------------------------------------- K4

def fused_round_dma(ring: RingTransport, queries, query_ids, blocks, carries,
                    landing, *, c_tile: int, exclude_self: bool = True,
                    exclude_zero: bool = True, zero_eps: float = 0.0,
                    timeout_s: float = TIMEOUT_S, query_norms=None,
                    query_planes=None, precision=None, outbox=None):
    """One ring round of every rank: rank r's resident ``blocks[r]`` (a
    traveler) merged exactly into ``carries[r]`` = (d, i), and copied (its
    norms and planes too, where the landing has buffers for them) into
    ``landing[(r + 1) % P]``, the last rank's into ``outbox`` instead where
    one is given (its successor lies in another process: ``ring`` must be
    a boundary transport). Returns the merged carries; the landing buffers
    then hold each rank's next resident block. On the f32 wire the card's
    merge reads the planes of the queries (``query_planes``, one (hi, lo)
    per rank, with ``query_norms`` from the same prologue) and of the block,
    both of ``stage_ring_planes`` at ``precision``; on the other wires only
    the norms."""
    blocks = [traveler(b) for b in blocks]
    landing = [traveler(t) for t in landing]
    cpu = _check_ring(queries, query_ids, blocks, carries)
    _check_landing(blocks, landing)
    if (outbox is not None) != ring.boundary:
        raise ValueError("an outbox goes with a boundary transport "
                         "(ring_transport(..., boundary=True)), and only with it")
    if outbox is not None:
        outbox = traveler(outbox)
        _check_landing([blocks[-1]], [outbox])
    if blocks[0][0].shape[0] % c_tile:
        raise ValueError("caller must pad the block to a c_tile multiple")
    kw = dict(c_tile=c_tile, exclude_self=exclude_self,
              exclude_zero=exclude_zero, zero_eps=zero_eps, precision=precision)
    if cpu:
        return fused_round_dma_reference(queries, query_ids, blocks, carries,
                                         landing, outbox=outbox, **kw)
    P = len(queries)
    if uses_planes(blocks[0][0].dtype):
        qn, qp, blocks = _card_planes(queries, blocks, query_norms, query_planes,
                                      precision)
    else:
        (qn, blocks), qp = _card_norms(queries, blocks, query_norms), [(None, None)] * P
    ring._ensure_flags()
    ring.epoch += 1
    carries = [(cd.contiguous(), ci.contiguous()) for cd, ci in carries]
    outs = [(torch.empty_like(cd), torch.empty_like(ci)) for cd, ci in carries]
    land_of = [landing[(r + 1) % P] for r in range(P)]  # the successor's
    if outbox is not None:
        land_of[-1] = outbox
    ranks = _ranks(ring, queries, query_ids, blocks, carries, outs, qn,
                   dst_blk=[t[0] for t in land_of], dst_bids=[t[1] for t in land_of],
                   dst_scale=[t[2] for t in land_of], dst_bn=[t[3] for t in land_of],
                   dst_bh=[t[4] for t in land_of], dst_bl=[t[5] for t in land_of],
                   qh=[t[0] for t in qp], ql=[t[1] for t in qp])
    moved = [tensor_bytes(*(b for b, dst in zip(blocks[r], land_of[r])
                            if dst is not None)) for r in range(P)]
    _launch_per_card(ring, "round_dma_launch", kernel_name("fused_round_dma", precision),
                     ranks, queries, blocks, carries, kw, ring.epoch, timeout_s,
                     side=(outs, 1, moved))
    return outs


def fused_round_dma_reference(queries, query_ids, blocks, carries, landing,
                              *, c_tile, exclude_self=True, exclude_zero=True,
                              zero_eps=0.0, precision=None, outbox=None):
    """Plain PyTorch version of ``fused_round_dma`` (any device): K3a's
    plain merge for every rank (which reads neither norms nor planes), then
    each rank's traveler copied into its successor's landing buffers (the
    last rank's into ``outbox`` where one is given)."""
    blocks = [traveler(b) for b in blocks]
    out = [block_merge_exact_reference(
        queries[r], query_ids[r], *b[:3], *carries[r], c_tile=c_tile,
        exclude_self=exclude_self, exclude_zero=exclude_zero,
        zero_eps=zero_eps, precision=precision) for r, b in enumerate(blocks)]
    P = len(blocks)
    for r in range(P):
        land = outbox if outbox is not None and r == P - 1 else landing[(r + 1) % P]
        for dst, src in zip(traveler(land), blocks[r]):
            if src is not None and dst is not None:
                dst.copy_(src)
    return out


def _ranks(ring, queries, query_ids, blocks, carries, outs, qn, **per_rank):
    """One ``_Rank`` per ring rank: the operands and flag words every
    launch takes, plus (or in place of them) the tensors of ``per_rank``
    (field -> one per rank)."""
    def fields(r):
        f = dict(
            q=_ptr(queries[r]), qn=_ptr(qn[r]), qids=_ptr(query_ids[r]),
            blk=_ptr(blocks[r][0]), bids=_ptr(blocks[r][1]),
            scale=_ptr(blocks[r][2]), bn=_ptr(blocks[r][3]),
            bh=_ptr(blocks[r][4]), bl=_ptr(blocks[r][5]),
            carry_d=_ptr(carries[r][0]), carry_i=_ptr(carries[r][1]),
            out_d=_ptr(outs[r][0]), out_i=_ptr(outs[r][1]),
            flags=ring.words(r), succ_flags=ring.succ_words(r),
            pred_flags=ring.pred_words(r),
            succ_remote=int(ring.succ_remote[r]),
            pred_remote=int(ring.pred_remote[r]))
        f.update({name: _ptr(ts[r]) for name, ts in per_rank.items()})
        return f

    return [_Rank(**fields(r)) for r in range(len(queries))]


def _grid_scratch(queries, blocks, precision):
    """K5's staging scratch on the f32 wire at "default" / "high", per
    rank on its device: the query planes hi, lo (Q, pitch) and the block
    planes hi, lo (B, pitch) bf16 (lo None at "default"), and the block
    norms (B,) f32, which its launch writes each round (K5's planes do not
    travel). None per field elsewhere."""
    fields = ("qh", "ql", "bh", "bl", "sbn")
    if blocks[0][0].dtype != torch.float32 or resolve_precision(precision) == "highest":
        return {}
    _, width, two = _plane_form(queries[0].shape[1], precision)

    def planes(n, dev):
        return tuple(torch.empty((n, width), dtype=torch.bfloat16, device=dev)
                     if i == 0 or two else None for i in range(2))

    per = []
    for q, b in zip(queries, blocks):
        per.append((*planes(q.shape[0], q.device), *planes(b[0].shape[0], q.device),
                    torch.empty(b[0].shape[0], dtype=torch.float32, device=q.device)))
    return {name: [t[j] for t in per] for j, name in enumerate(fields)}


def _launch_per_card(ring, fn_name, name, ranks, queries, blocks, carries, kw,
                     epoch, timeout_s, ring_size=None, *, side, proxy=None):
    """One launch per card over the ranks it holds, then the error check.
    ``ring_size`` is the whole ring's (default: this call's ranks). A host
    ``proxy`` (K5 over a proxy link) is started before the launches and
    joined once every card has synchronized; its failure raises first.
    ``side`` = (outs, rounds, per rank bytes it sends) for the side-band
    record: the logical FLOPs of ``rounds`` merges a rank and the wire
    bytes the kernel moves itself."""
    outs, rounds, moved = side

    def record(local):
        return lambda: dict(
            operands=[t for r in local for t in (queries[r], *blocks[r],
                                                 *carries[r])],
            outputs=[t for r in local for t in outs[r]],
            flops=rounds * sum(2 * queries[r].shape[0] * blocks[r][0].shape[0]
                               * queries[r].shape[1] for r in local),
            precision=PRECISION_FORMS[resolve_precision(kw["precision"])],
            bytes=sum(tensor_bytes(queries[r], *blocks[r], *carries[r], *outs[r])
                      for r in local),
            wire_bytes=sum(moved[r] for r in local), ranks=len(local))

    lib = _lib()
    fn = getattr(lib, fn_name)
    q0, blk0, (cd0, _) = queries[0], blocks[0][0], carries[0]
    if proxy is not None:
        proxy.start()
    for card in ring.cards:
        local = ring.local[card]
        arr = (_Rank * len(local))(*(ranks[r] for r in local))
        err = ring.flags[card][0, W_ERR]
        with torch.cuda.device(card):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(ctypes.cast(arr, ctypes.c_void_p), len(local),
                    q0.shape[0], blk0.shape[0], q0.shape[1], cd0.shape[1],
                    _WIRE[blk0.dtype], ring_size or len(queries),
                    int(kw["exclude_self"]),
                    int(kw["exclude_zero"]), float(kw["zero_eps"]), epoch,
                    int(timeout_s * 1e9), err.data_ptr(),
                    precision_code(kw["precision"]), stream)
        if rc != 0:
            ring.flags = None
            if proxy is not None:
                proxy.abort()
            raise RuntimeError(f"{name} launch failed on {card}: cudaError {rc}")
        note_launch(LAUNCHES, name, record(local))
    if proxy is not None:
        _finish_proxy(ring, proxy, name)
    ring.raise_on_error(name)


def _finish_proxy(ring, proxy, name: str) -> None:
    """Synchronize every card of ``ring`` (the kernels have ended: their
    waits are bounded), then join the proxy; its failure raises."""
    from mpi_knn_tpu_torch.parallel.hostlink import ProxyFailed

    for card in ring.cards:
        if card.type == "cuda":
            torch.cuda.synchronize(card)
    if any(int(ring.flags[c][0, W_ERR]) for c in ring.cards):
        proxy.stop.set()  # the kernel has left: no word it would raise comes
    try:
        proxy.finish()
    except ProxyFailed as e:
        ring.fail_proxy(name, e)


# ---------------------------------------------------------------- K5

def float_wire_only_error(dtype) -> ValueError:
    """The refusal of a non-float block at K5's boundary, in the JAX
    package's words."""
    return ValueError(
        "ring_fused_rotation='grid' supports float wire formats only "
        "(f32/bf16): the grid kernel casts slot bytes straight into "
        f"the distance dot, got block dtype {dtype}"
    )


def fused_rotation_grid(ring: RingTransport, queries, query_ids, blocks,
                        carries, slots, *, c_tile: int,
                        exclude_self: bool = True, exclude_zero: bool = True,
                        zero_eps: float = 0.0, timeout_s: float = TIMEOUT_S,
                        query_norms=None, precision=None, ring_size=None,
                        hand_on=None):
    """The whole uni rotation: P rounds in which every rank merges its
    resident block, round 0 its own ``blocks[r]`` = (block, ids, None[,
    norms]) and round j the block in its slot j % 2 of ``slots[r]``
    (``landing_slots``), while the resident block streams (with its norms)
    into the successor's slot (j + 1) % 2. Returns the final carries.

    On a ring that spans processes these are this process's ranks,
    ``ring_size`` is the whole ring's P and ``ring`` a transport with
    ``links`` and their kinds. On cards, over an "ipc" link the last rank
    streams into the next process's first rank's slots over CUDA IPC (the
    first rank's slots are the transport's exports, in place of
    ``slots[0]``); over a "proxy" link it streams into the transport's
    outbox and the first rank lands into ``slots[0]``, while a host proxy
    (``parallel/hostlink.py``) carries every hop during the one launch.
    The plain version calls ``hand_on(outbox, landing)`` each round but
    the last over "ipc" links, which moves the last rank's outgoing
    traveler to the next process and fills the first rank's ``landing``
    from the previous one (one side None where only that link is "ipc"),
    and runs ``fused_rotation_grid_proxy_reference`` beside the same
    proxy where a link is a "proxy" one."""
    blocks = [traveler(b) for b in blocks]
    slots = [traveler(s) for s in slots]
    for blk, _, scl, *_ in blocks:
        if not blk.dtype.is_floating_point or scl is not None:
            raise float_wire_only_error(blk.dtype)
    cpu = _check_ring(queries, query_ids, blocks, carries)
    for b, s in zip(blocks, slots):
        if s[2] is not None or any(
                t.shape[1:] != x.shape or t.shape[0] != 2 or t.dtype != x.dtype
                or not t.is_contiguous() for t, x in ((s[0], b[0]), (s[1], b[1]))):
            raise ValueError("slots must be landing_slots of the rank's block")
    if blocks[0][0].shape[0] % c_tile:
        raise ValueError("caller must pad the block to a c_tile multiple")
    kw = dict(c_tile=c_tile, exclude_self=exclude_self,
              exclude_zero=exclude_zero, zero_eps=zero_eps, precision=precision)
    if ring.boundary and (ring.links is None or (cpu and hand_on is None)):
        raise ValueError("the grid form across processes needs a transport "
                         "with links (and, off the cards, hand_on)")
    if cpu and ring.links is not None and (ring.proxied(0) or ring.proxied(1)):
        return fused_rotation_grid_proxy_reference(
            ring, queries, query_ids, blocks, carries, slots, ring_size=ring_size,
            hand_on=hand_on, timeout_s=timeout_s, **kw)
    if cpu:
        return fused_rotation_grid_reference(queries, query_ids, blocks,
                                             carries, slots, ring_size=ring_size,
                                             hand_on=hand_on, **kw)
    P = len(queries)
    qn, blocks = _card_norms(queries, blocks, query_norms)
    slots = [s if s[3] is not None else s[:3] + (b[3].new_empty((2,) + tuple(b[3].shape)),)
             for s, b in zip(slots, blocks)]
    succ = [slots[(r + 1) % P] for r in range(P)]
    if ring.links is not None:
        own, remote = ring.bind_links(slots[0], *(blocks[0][j] for j in (0, 1, 3)))
        slots[0] = own
        succ[-1] = (remote[0], remote[1], None, remote[2])
    ring._ensure_flags()
    ring.calls += 1
    rounds = ring_size or P
    proxy = None if ring.links is None else ring.host_proxy(
        (slots[0][0], slots[0][1], slots[0][3]), succ[-1][:2] + succ[-1][3:],
        rounds, timeout_s)
    carries = [(cd.contiguous(), ci.contiguous()) for cd, ci in carries]
    outs = [(torch.empty_like(cd), torch.empty_like(ci)) for cd, ci in carries]
    cbufs = [(cd.new_empty((2,) + tuple(cd.shape)),
              ci.new_empty((2,) + tuple(ci.shape))) for cd, ci in carries]
    ranks = _ranks(ring, queries, query_ids, blocks, carries, outs, qn,
                   dst_blk=[s[0] for s in succ], dst_bids=[s[1] for s in succ],
                   dst_bn=[s[3] for s in succ],
                   slot_blk=[s[0] for s in slots], slot_bids=[s[1] for s in slots],
                   slot_bn=[s[3] for s in slots],
                   cbuf_d=[c[0] for c in cbufs], cbuf_i=[c[1] for c in cbufs],
                   **_grid_scratch(queries, blocks, precision))
    moved = [(rounds - 1) * tensor_bytes(b[0], b[1], b[3]) for b in blocks]
    _launch_per_card(ring, "rotation_grid_launch",
                     kernel_name("fused_rotation_grid", precision),
                     ranks, queries, blocks, carries, kw, ring.calls, timeout_s,
                     ring_size=ring_size, side=(outs, rounds, moved), proxy=proxy)
    return outs


def fused_rotation_grid_reference(queries, query_ids, blocks, carries, slots,
                                  *, c_tile, exclude_self=True,
                                  exclude_zero=True, zero_eps=0.0,
                                  precision=None, ring_size=None, hand_on=None):
    """Plain PyTorch version of ``fused_rotation_grid`` (any device): the P
    rounds of ``fused_round_dma_reference``, rank by rank, with no stream
    in the last round. With ``hand_on`` the ranks are one process's part
    of a ring of ``ring_size``: the last rank's traveler goes into an
    outbox each round, which ``hand_on`` moves to the next process."""
    P = ring_size or len(blocks)
    kw = dict(c_tile=c_tile, exclude_self=exclude_self,
              exclude_zero=exclude_zero, zero_eps=zero_eps, precision=precision)
    held = [traveler(b) for b in blocks]
    for r in range(P):
        if r < P - 1:
            land = [slot(s, (r + 1) % 2) for s in slots]
            outbox = None if hand_on is None else landing_buffers(*held[-1])
            carries = fused_round_dma_reference(queries, query_ids, held,
                                                carries, land, outbox=outbox, **kw)
            if hand_on is not None:
                hand_on(outbox, land[0])
            held = land
        else:
            carries = [block_merge_exact_reference(
                queries[i], query_ids[i], *b[:3], *carries[i], **kw)
                for i, b in enumerate(held)]
    return carries


def fused_rotation_grid_proxy_reference(ring: RingTransport, queries, query_ids,
                                        blocks, carries, slots, *, ring_size,
                                        hand_on, c_tile, exclude_self=True,
                                        exclude_zero=True, zero_eps=0.0,
                                        precision=None, timeout_s=TIMEOUT_S):
    """Plain stand-in for K5's side of the host-proxy protocol
    (``parallel/hostlink.py``), on CPU ranks: this process's ranks of a
    ring of ``ring_size`` whose boundary has a "proxy" link. It makes, in
    the kernel's order, what the kernel makes: the barrier's adds to the
    mirror rows and its waits on its own words; per round the waits for a
    free outbox slot and for the landed hop, the merges (K3a's plain
    merge, as ``fused_rotation_grid_reference``), the stores of every
    rank's traveler into its successor's slot, the last rank's into the
    outbox in ``COPY_CTAS`` parts with a landed add after each, and the
    first rank's slot release. The proxy of the call runs beside it on
    the same tensors. An "ipc" link of the same process moves through
    ``hand_on`` as in the plain version. A wait that times out sets the
    error word and the rotation stops, as the kernel does; the proxy's
    failure, then the error word, raise."""
    P, n = ring_size, len(blocks)
    kw = dict(c_tile=c_tile, exclude_self=exclude_self,
              exclude_zero=exclude_zero, zero_eps=zero_eps, precision=precision)
    held = [traveler(b) for b in blocks]
    ring._ensure_flags()
    ring.calls += 1
    G, frees = ring.calls, max(P - 2, 0)
    nxt_p, prv_p = ring.proxied(0), ring.proxied(1)
    m_next, m_prev = ring.mirror
    first, last = ring.flag_row(0), ring.flag_row(n - 1)
    err = ring.flags[ring.cards[0]][0]

    def parts(t):
        return tuple(x for x in (t[0], t[1], t[3]) if x is not None)

    outbox = ring.outbox(*parts(held[-1])) if nxt_p else None
    proxy = ring.host_proxy(parts(slots[0]), outbox, P, timeout_s).start()

    def wait(row, word, target, code) -> bool:
        t0 = time.perf_counter()
        while int(row[word]) < target:
            if time.perf_counter() - t0 > timeout_s:
                if not int(err[W_ERR]):
                    err[W_ERR] = code
                return False
            time.sleep(1e-4)
        return True

    def landed():
        m_next[G_LANDED] += 1

    def rotate():
        nonlocal carries, held
        if prv_p:
            m_prev[G_FROM_SUCC] += 1
        if nxt_p:
            m_next[G_FROM_PRED] += 1
        if ((nxt_p and not wait(last, G_FROM_SUCC, G, 1))
                or (prv_p and not wait(first, G_FROM_PRED, G, 1))):
            return
        for r in range(P):
            if int(err[W_ERR]):
                return  # every rank leaves at the same round
            if r >= 1:
                if nxt_p and r <= P - 2 and not wait(
                        last, G_FREE, (G - 1) * frees + r, 5):
                    return
                if prv_p and not wait(first, G_LANDED,
                                      ((G - 1) * (P - 1) + r) * COPY_CTAS, 2):
                    return
                if not prv_p:  # the "ipc" link's hop r - 1, off the cards
                    hand_on(None, slot(slots[0], r % 2))
            carries = [block_merge_exact_reference(
                queries[i], query_ids[i], *b[:3], *carries[i], **kw)
                for i, b in enumerate(held)]
            if r == P - 1:
                return
            nxt = (r + 1) % 2
            for i in range(n):
                if i < n - 1:
                    _store(slot(slots[i + 1], nxt), held[i])
                elif nxt_p:
                    _store(_as_traveler([t[nxt] for t in outbox]), held[i], landed)
                else:
                    out = landing_buffers(*held[i])
                    _store(out, held[i])
                    hand_on(out, None)
            if prv_p and r < P - 2:  # round r's reads of slot r % 2 retired
                m_prev[G_FREE] += 1
            held = [slot(s, nxt) for s in slots]

    name = kernel_name("fused_rotation_grid", precision)
    try:
        rotate()
    finally:
        _finish_proxy(ring, proxy, name)
    ring.raise_on_error(name)
    return carries


def _as_traveler(parts):
    """(block, ids[, norms]) as a traveler."""
    return (parts[0], parts[1], None, parts[2] if len(parts) > 2 else None)


def _store(dst, src, after_part=None):
    """A traveler's block, ids and norms into ``dst``'s buffers, in
    ``COPY_CTAS`` equal parts of each, ``after_part`` called after each
    part (the kernel's copy items and their landed adds)."""
    pairs = [(d.view(-1), s.reshape(-1)) for d, s in zip(
        (dst[0], dst[1], dst[3]), (src[0], src[1], src[3]))
        if d is not None and s is not None]
    for part in range(COPY_CTAS):
        for d, s in pairs:
            a, b = s.numel() * part // COPY_CTAS, s.numel() * (part + 1) // COPY_CTAS
            d[a:b].copy_(s[a:b])
        if after_part is not None:
            after_part()
