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

A rank's traveler is (block, ids, scale or None, norms or None, hi or
None, lo or None): the norms are the exact prologue's squared norms of the
decoded block, made once per call and moved with the block by the kernels
themselves, as its ids are. On the f32 wire K4 runs the wgmma tile of
``csrc/knn_wgmma.cuh``, which reads TF32 hi/lo planes of the queries and
of the block by TMA: its prologue ``stage_round_planes`` writes them with
the norms, and the planes travel too. On the other wires, and in K5, the
norms come from ``fused_ring.stage_wire_norms`` and the planes are None.
A traveler without what its kernel reads is staged by the wrapper (one
prologue launch), and the queries likewise (``query_norms``,
``query_planes``). The plain versions compute their own norms in f32 and
copy whatever the traveler holds.

One process drives every rank. A launch covers every rank its card holds,
so a round of K4 is one launch per distinct card (``launches = rounds ×
cards``) and K5 is one launch per card. The flag words the kernels signal
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

import torch

from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.ops.fused_knn import split_width, stage_tf32_split_reference
from mpi_knn_tpu_torch.ops.fused_ring import (
    _WIRE,
    _check,
    block_merge_exact_reference,
    stage_wire_norms,
)

LAUNCHES = {"fused_round_dma": 0, "fused_rotation_grid": 0,
            "stage_tf32_split[ring]": 0}

TIMEOUT_S = 10.0  # bound of every spin-wait inside the kernels

# flag words of one rank (csrc/fused_ring_dma.cu, enum Word)
_W_ERR = 5
_ERRORS = {1: "the neighbour barrier", 2: "the predecessor's block to land",
           3: "its own copy-out", 4: "the barrier CTA", 5: "a slot release"}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Rank(ctypes.Structure):
    """csrc/fused_ring_dma.cu's ``struct Rank``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "q", "qids", "blk", "scale", "bids", "carry_d", "carry_i", "out_d",
        "out_i", "dst_blk", "dst_scale", "dst_bids", "flags", "succ_flags",
        "pred_flags", "slot_blk", "slot_bids", "cbuf_d", "cbuf_i", "qn", "bn",
        "dst_bn", "slot_bn", "qh", "ql", "bh", "bl", "dst_bh", "dst_bl")] + [
        ("succ_remote", ctypes.c_int), ("pred_remote", ctypes.c_int)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, with its C signatures set once at first load."""
    lib = _build.load("fused_ring_dma")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("round_dma_launch", "rotation_grid_launch"):
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] + [i32] * 9 + [ctypes.c_float, i32,
                                            ctypes.c_longlong, ptr, ptr])
        fn.restype = i32
    lib.round_stage_split_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.ring_enable_peer_access.argtypes = [i32, i32]
    lib.ring_kernel_plan.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    for name in ("ring_enable_peer_access", "ring_max_local", "ring_words",
                 "ring_rank_bytes", "ring_kernel_plan", "round_stage_split_launch"):
        getattr(lib, name).restype = i32
    if lib.ring_rank_bytes() != ctypes.sizeof(_Rank):
        raise RuntimeError("csrc/fused_ring_dma.cu's Rank and _Rank differ")
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
    card runs the same protocol within the card.
    """

    def __init__(self, devices, cross_card=None):
        self.devices = [_card(torch.device(d)) for d in devices]
        P = len(self.devices)
        if cross_card is None:
            cross_card = [self.devices[r] != self.devices[(r + 1) % P]
                          for r in range(P)]
        self.succ_remote = [bool(c) for c in cross_card]
        self.pred_remote = [self.succ_remote[(r - 1) % P] for r in range(P)]
        self.cards = list(dict.fromkeys(self.devices))
        self.local = {c: [r for r in range(P) if self.devices[r] == c]
                      for c in self.cards}
        self.flags = None
        self.epoch = 0   # K4 rounds run on this mesh
        self.calls = 0   # K5 launches per card run on this mesh

    def _ensure_flags(self):
        if self.flags is not None:
            return
        from mpi_knn_tpu_torch.parallel.mesh import enable_peer_access

        lib = _lib()
        for card in self.cards:
            if len(self.local[card]) > lib.ring_max_local():
                raise ValueError(
                    f"{card} holds {len(self.local[card])} ring ranks; one "
                    f"launch takes at most {lib.ring_max_local()}")
        enable_peer_access(self.devices)
        words = lib.ring_words()
        self.flags = {c: torch.zeros((len(self.local[c]), words),
                                     dtype=torch.int32, device=c)
                      for c in self.cards}
        self.epoch = self.calls = 0

    def words(self, r: int) -> int:
        """Address of rank r's flag words."""
        card = self.devices[r]
        row = self.local[card].index(r)
        t = self.flags[card]
        return t.data_ptr() + row * t.shape[1] * t.element_size()

    def raise_on_error(self, name: str):
        """Read each card's error word (this waits for its stream); on an
        error drop the flag words, so the next call starts from zero."""
        for card in self.cards:
            code = int(self.flags[card][0, _W_ERR].item())
            if code:
                self.flags = None
                raise RuntimeError(
                    f"{name}: neighbour barrier timed out on {card} "
                    f"(waiting for {_ERRORS.get(code, code)}); the ring's "
                    "flag words were reset")


_TRANSPORTS: dict = {}


def ring_transport(devices) -> RingTransport:
    """The mesh's transport state, made once per mesh."""
    key = tuple(_card(torch.device(d)) for d in devices)
    if key not in _TRANSPORTS:
        _TRANSPORTS[key] = RingTransport(key)
    return _TRANSPORTS[key]


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
    LAUNCHES["stage_tf32_split[ring]"] += 1
    return hi, lo, norms


def ring_kernel_plan(which: str, wire_dtype, n_local: int, q_local: int,
                     k: int) -> dict:
    """The launch plan of K4 (``which="round"``) or K5 (``"grid"``) over
    n_local ranks on the current card: query rows per merge group (K4's f32
    form: 128; its other forms 128, or 64 where 128-row groups would not
    fill the card's resident slots; K5: 64), the grid (persistent for K4's
    f32 form and K5), the items per round (merge items, plus copy items
    where CTAs or work items take them), the kernel's registers, spilled
    bytes a thread and CTAs per SM, the copy units per round and whether
    the tile is the wgmma one."""
    out = (ctypes.c_int * 8)()
    rc = _lib().ring_kernel_plan(0 if which == "round" else 1, _WIRE[wire_dtype],
                                 n_local, q_local, k, out)
    if rc != 0:
        raise RuntimeError(f"ring_kernel_plan failed: cudaError {rc}")
    return dict(zip(("rows_per_group", "grid", "items_per_round", "registers",
                     "spilled_bytes", "ctas_per_sm", "copy_units", "wgmma_tile"),
                    out))


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def _check_staged(rows, norms, hi, lo):
    """K4's prologue outputs for ``rows``: (n,) norms and (n, split_width(d))
    planes, contiguous float32 on the rows' device."""
    n, d = rows.shape
    for t, shape in ((norms, (n,)), (hi, (n, split_width(d))), (lo, (n, split_width(d)))):
        if (t is None or t.dtype != torch.float32 or tuple(t.shape) != shape
                or t.device != rows.device or not t.is_contiguous()):
            raise TypeError(f"K4's staged norms and planes must be contiguous float32 "
                            f"(n,) and (n, {split_width(d)}) on {rows.device}")


def _card_planes(queries, blocks, query_norms, query_planes):
    """On cards, for K4's wgmma tile: the query planes and norms and every
    traveler's planes and norms, staged by its prologue where the caller
    has none (norms and planes then come from one launch)."""
    if query_planes is None:
        staged = [stage_round_planes(q) for q in queries]
        query_planes = [s[:2] for s in staged]
        query_norms = [s[2] for s in staged]
    if query_norms is None:
        raise TypeError("query_planes need the query_norms of the same prologue")
    for q, n, (hi, lo) in zip(queries, query_norms, query_planes):
        _check_staged(q, n, hi, lo)
    out = []
    for b in blocks:
        if b[4] is None or b[5] is None or b[3] is None:
            hi, lo, norms = stage_round_planes(b[0])
            b = b[:3] + (norms, hi, lo)
        _check_staged(b[0], *b[3:])
        out.append(b)
    return list(query_norms), list(query_planes), out


# ---------------------------------------------------------------- K4

def fused_round_dma(ring: RingTransport, queries, query_ids, blocks, carries,
                    landing, *, c_tile: int, exclude_self: bool = True,
                    exclude_zero: bool = True, zero_eps: float = 0.0,
                    timeout_s: float = TIMEOUT_S, query_norms=None,
                    query_planes=None):
    """One ring round of every rank: rank r's resident ``blocks[r]`` (a
    traveler) merged exactly into ``carries[r]`` = (d, i), and copied (its
    norms and planes too, where the landing has buffers for them) into
    ``landing[(r + 1) % P]``. Returns the merged carries; the landing
    buffers then hold each rank's next resident block. On the f32 wire the
    card's merge reads the planes of the queries (``query_planes``, one (hi,
    lo) per rank, with ``query_norms`` from the same prologue) and of the
    block (``stage_round_planes``)."""
    blocks = [traveler(b) for b in blocks]
    landing = [traveler(t) for t in landing]
    cpu = _check_ring(queries, query_ids, blocks, carries)
    _check_landing(blocks, landing)
    if blocks[0][0].shape[0] % c_tile:
        raise ValueError("caller must pad the block to a c_tile multiple")
    kw = dict(c_tile=c_tile, exclude_self=exclude_self,
              exclude_zero=exclude_zero, zero_eps=zero_eps)
    if cpu:
        return fused_round_dma_reference(queries, query_ids, blocks, carries,
                                         landing, **kw)
    P = len(queries)
    if blocks[0][0].dtype == torch.float32:
        qn, qp, blocks = _card_planes(queries, blocks, query_norms, query_planes)
    else:
        (qn, blocks), qp = _card_norms(queries, blocks, query_norms), [(None, None)] * P
    ring._ensure_flags()
    ring.epoch += 1
    carries = [(cd.contiguous(), ci.contiguous()) for cd, ci in carries]
    outs = [(torch.empty_like(cd), torch.empty_like(ci)) for cd, ci in carries]
    land_of = [landing[(r + 1) % P] for r in range(P)]  # the successor's
    ranks = _ranks(ring, queries, query_ids, blocks, carries, outs, qn,
                   dst_blk=[t[0] for t in land_of], dst_bids=[t[1] for t in land_of],
                   dst_scale=[t[2] for t in land_of], dst_bn=[t[3] for t in land_of],
                   dst_bh=[t[4] for t in land_of], dst_bl=[t[5] for t in land_of],
                   qh=[t[0] for t in qp], ql=[t[1] for t in qp])
    _launch_per_card(ring, "round_dma_launch", "fused_round_dma", ranks,
                     queries, blocks, carries, kw, ring.epoch, timeout_s)
    return outs


def fused_round_dma_reference(queries, query_ids, blocks, carries, landing,
                              *, c_tile, exclude_self=True, exclude_zero=True,
                              zero_eps=0.0):
    """Plain PyTorch version of ``fused_round_dma`` (any device): K3a's
    plain merge for every rank (which reads neither norms nor planes), then
    each rank's traveler copied into its successor's landing buffers."""
    blocks = [traveler(b) for b in blocks]
    out = [block_merge_exact_reference(
        queries[r], query_ids[r], *b[:3], *carries[r], c_tile=c_tile,
        exclude_self=exclude_self, exclude_zero=exclude_zero,
        zero_eps=zero_eps) for r, b in enumerate(blocks)]
    P = len(blocks)
    for r in range(P):
        for dst, src in zip(traveler(landing[(r + 1) % P]), blocks[r]):
            if src is not None and dst is not None:
                dst.copy_(src)
    return out


def _ranks(ring, queries, query_ids, blocks, carries, outs, qn, **per_rank):
    """One ``_Rank`` per ring rank: the operands and flag words every
    launch takes, plus the tensors of ``per_rank`` (field -> one per
    rank)."""
    P = len(queries)
    return [_Rank(
        q=_ptr(queries[r]), qn=_ptr(qn[r]), qids=_ptr(query_ids[r]),
        blk=_ptr(blocks[r][0]), bids=_ptr(blocks[r][1]),
        scale=_ptr(blocks[r][2]), bn=_ptr(blocks[r][3]),
        bh=_ptr(blocks[r][4]), bl=_ptr(blocks[r][5]),
        carry_d=_ptr(carries[r][0]), carry_i=_ptr(carries[r][1]),
        out_d=_ptr(outs[r][0]), out_i=_ptr(outs[r][1]),
        flags=ring.words(r), succ_flags=ring.words((r + 1) % P),
        pred_flags=ring.words((r - 1) % P),
        succ_remote=int(ring.succ_remote[r]),
        pred_remote=int(ring.pred_remote[r]),
        **{name: _ptr(ts[r]) for name, ts in per_rank.items()})
        for r in range(P)]


def _launch_per_card(ring, fn_name, name, ranks, queries, blocks, carries, kw,
                     epoch, timeout_s):
    """One launch per card over the ranks it holds, then the error check."""
    lib = _lib()
    fn = getattr(lib, fn_name)
    q0, blk0, (cd0, _) = queries[0], blocks[0][0], carries[0]
    for card in ring.cards:
        local = ring.local[card]
        arr = (_Rank * len(local))(*(ranks[r] for r in local))
        err = ring.flags[card][0, _W_ERR]
        with torch.cuda.device(card):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(ctypes.cast(arr, ctypes.c_void_p), len(local),
                    q0.shape[0], blk0.shape[0], q0.shape[1], cd0.shape[1],
                    _WIRE[blk0.dtype], len(queries), int(kw["exclude_self"]),
                    int(kw["exclude_zero"]), float(kw["zero_eps"]), epoch,
                    int(timeout_s * 1e9), err.data_ptr(), stream)
        if rc != 0:
            ring.flags = None
            raise RuntimeError(f"{name} launch failed on {card}: cudaError {rc}")
        LAUNCHES[name] += 1
    ring.raise_on_error(name)


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
                        query_norms=None):
    """The whole uni rotation: P rounds in which every rank merges its
    resident block, round 0 its own ``blocks[r]`` = (block, ids, None[,
    norms]) and round j the block in its slot j % 2 of ``slots[r]``
    (``landing_slots``), while the resident block streams (with its norms)
    into the successor's slot (j + 1) % 2. Returns the final carries."""
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
              exclude_zero=exclude_zero, zero_eps=zero_eps)
    if cpu:
        return fused_rotation_grid_reference(queries, query_ids, blocks,
                                             carries, slots, **kw)
    P = len(queries)
    qn, blocks = _card_norms(queries, blocks, query_norms)
    slots = [s if s[3] is not None else s[:3] + (b[3].new_empty((2,) + tuple(b[3].shape)),)
             for s, b in zip(slots, blocks)]
    ring._ensure_flags()
    ring.calls += 1
    carries = [(cd.contiguous(), ci.contiguous()) for cd, ci in carries]
    outs = [(torch.empty_like(cd), torch.empty_like(ci)) for cd, ci in carries]
    cbufs = [(cd.new_empty((2,) + tuple(cd.shape)),
              ci.new_empty((2,) + tuple(ci.shape))) for cd, ci in carries]
    ranks = _ranks(ring, queries, query_ids, blocks, carries, outs, qn,
                   dst_blk=[slots[(r + 1) % P][0] for r in range(P)],
                   dst_bids=[slots[(r + 1) % P][1] for r in range(P)],
                   dst_bn=[slots[(r + 1) % P][3] for r in range(P)],
                   slot_blk=[s[0] for s in slots], slot_bids=[s[1] for s in slots],
                   slot_bn=[s[3] for s in slots],
                   cbuf_d=[c[0] for c in cbufs], cbuf_i=[c[1] for c in cbufs])
    _launch_per_card(ring, "rotation_grid_launch", "fused_rotation_grid",
                     ranks, queries, blocks, carries, kw, ring.calls, timeout_s)
    return outs


def fused_rotation_grid_reference(queries, query_ids, blocks, carries, slots,
                                  *, c_tile, exclude_self=True,
                                  exclude_zero=True, zero_eps=0.0):
    """Plain PyTorch version of ``fused_rotation_grid`` (any device): the P
    rounds of ``fused_round_dma_reference``, rank by rank, with no stream
    in the last round."""
    P = len(blocks)
    kw = dict(c_tile=c_tile, exclude_self=exclude_self,
              exclude_zero=exclude_zero, zero_eps=zero_eps)
    held = [traveler(b) for b in blocks]
    for r in range(P):
        if r < P - 1:
            land = [slot(s, (r + 1) % 2) for s in slots]
            carries = fused_round_dma_reference(queries, query_ids, held,
                                                carries, land, **kw)
            held = land
        else:
            carries = [block_merge_exact_reference(
                queries[i], query_ids[i], *b[:3], *carries[i], **kw)
                for i, b in enumerate(held)]
    return carries
