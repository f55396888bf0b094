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
engine keeps per bucket. A dp×ring mesh and a multi-process
``torch.distributed`` form are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.backends.serial import (
    cap_corpus_tile,
    knn_chunk_update,
    torch_dtype,
)
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
from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh
from mpi_knn_tpu_torch.parallel.partition import (
    make_global_ids,
    pad_rows_any,
    pad_to_multiple,
)


def bidir_rounds(num_dev: int) -> tuple[int, int]:
    """Round plan of the bidirectional schedule: ``(rounds, bwd_limit)``.
    ``rounds = ⌊P/2⌋ + 1``; the backward traveler merges on rounds
    ``1 <= r < bwd_limit = ⌈P/2⌉``, so every block merges exactly once."""
    return num_dev // 2 + 1, -(-num_dev // 2)


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


def ring_tiles(cfg: KNNConfig, m: int, nq: int, dp: int, ring_n: int):
    """Per-rank tile sizes and padded global sizes: (q_tile, c_tile,
    q_pad, c_pad), the JAX package's policy."""
    num_dev = dp * ring_n
    c_tile = min(cfg.corpus_tile, -(-m // ring_n))
    q_tile = min(cfg.query_tile, -(-nq // num_dev))
    c_tile = cap_corpus_tile(q_tile, c_tile, cfg.max_tile_elems)
    c_pad = pad_to_multiple(m, ring_n * c_tile)
    q_pad = pad_to_multiple(nq, num_dev * q_tile)
    return q_tile, c_tile, q_pad, c_pad


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
    if any(isinstance(d, (list, tuple)) for d in mesh):
        raise ValueError(
            "a 2-D dp×ring mesh: not yet ported to mpi_knn_tpu_torch "
            "(see ROADMAP.md)")
    return [torch.device(d) for d in mesh]


class _Transport:
    """Moves every rank's traveler to the rank ``shift`` steps on. Under
    overlap a copy between two cards runs on side streams, started before
    the round's compute; ``land`` makes the receivers' streams wait for it.
    Under blocking the copies wait for every device's compute."""

    def __init__(self, devices, overlap: bool):
        self.devices = devices
        self.overlap = overlap
        cards = {d for d in devices if d.type == "cuda"}
        self.side = {d: torch.cuda.Stream(d) for d in cards} if overlap else {}
        self.cards = cards
        self.landed = []

    def rotate(self, travelers, shift: int):
        P = len(self.devices)
        if not self.overlap:
            for d in self.cards:
                torch.cuda.synchronize(d)
        out = [None] * P
        for r in range(P):
            dst = (r + shift) % P
            out[dst] = tuple(self._move(t, self.devices[r], self.devices[dst])
                             for t in travelers[r])
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
                 staged: bool = False, slots=None):
        self.cfg, self.devices, self.overlap, self.form = (
            cfg, devices, overlap, form)
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
            self.transport = _Transport(devices, overlap)
        else:
            self.transport = ring_transport(devices)
            self.slots = (slots if slots is not None
                          else [landing_slots(*t) for t in self.travelers[0]])
            self.parity = 0

    def _merge_all(self, held):
        for r in range(len(self.devices)):
            self.carries[r] = _merge(self.q_sh[r], self.qid_sh[r], held[r],
                                     self.carries[r], self.cfg, self.q_tile,
                                     self.c_tile, self.q_norms[r])

    def _kernel_kw(self):
        return dict(c_tile=self.c_tile, exclude_self=self.cfg.exclude_self,
                    exclude_zero=self.cfg.exclude_zero,
                    zero_eps=self.cfg.zero_eps, query_norms=self.q_norms,
                    precision=self.cfg.matmul_precision)

    def round(self, merge_bwd: bool, rotate: bool):
        """Merge the resident block(s), and move them on when ``rotate``."""
        if self.form == "dma" and rotate:
            land = [slot(s, self.parity) for s in self.slots]
            self.carries = fused_round_dma(
                self.transport, self.q_sh, self.qid_sh, self.travelers[0],
                self.carries, land, query_planes=self.q_planes,
                **self._kernel_kw())
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
        self.carries = fused_rotation_grid(
            self.transport, self.q_sh, self.qid_sh, self.travelers[0],
            self.carries, self.slots, **self._kernel_kw())

    def rotate(self):
        """The whole schedule: one K5 launch per card (grid), or its rounds
        (the dma form moves the block every round, the last included, as
        the reference's scan does)."""
        if self.form == "grid":
            self.rotation_grid()
            return
        P = len(self.devices)
        rounds, bwd_limit = (bidir_rounds(P) if self.cfg.ring_schedule == "bidir"
                             else (P, 0))
        for rnd in range(rounds):
            self.round(merge_bwd=1 <= rnd < bwd_limit,
                       rotate=self.form == "dma" or rnd < rounds - 1)

    def gathered(self, dev, nq: int):
        """The carries of every rank, in rank order, cut to ``nq`` rows."""
        best_d = torch.cat([c[0].to(dev) for c in self.carries])[:nq]
        best_i = torch.cat([c[1].to(dev) for c in self.carries])[:nq]
        return best_d, best_i


def ring_shards(cfg: KNNConfig, corpus, queries, query_ids, devices,
                start_round: int = 0):
    """Pad and place one call's operands: returns (q_tile, c_tile, q_sh,
    qid_sh, travelers), the travelers as they stand after ``start_round``
    rounds (rank i holds block i − r, and under bidir also block i + r: the
    padded corpus rolled r blocks each way)."""
    P = len(devices)
    m, dim = corpus.shape
    nq = queries.shape[0]
    q_tile, c_tile, q_pad, c_pad = ring_tiles(cfg, m, nq, 1, P)
    dtype = torch_dtype(cfg.dtype)
    b, ql = c_pad // P, q_pad // P
    shift = start_round * b

    corpus_p = pad_rows_any(corpus, c_pad, dtype=dtype)
    ids = torch.from_numpy(make_global_ids(m, c_pad))

    def traveler_blocks(s):
        rows = torch.roll(corpus_p, s, 0) if s else corpus_p
        rid = torch.roll(ids, s, 0) if s else ids
        scale = None
        if cfg.ring_transfer_dtype == "int8":
            rows, scale = quantize_ring_block(rows)
        elif cfg.ring_transfer_dtype is not None:
            rows = rows.to(torch_dtype(cfg.ring_transfer_dtype))
        return [(rows[r * b:(r + 1) * b].to(d), rid[r * b:(r + 1) * b].to(d),
                 None if scale is None else scale[r * b:(r + 1) * b].to(d))
                for r, d in enumerate(devices)]

    travelers = [traveler_blocks(shift)]
    if cfg.ring_schedule == "bidir":
        travelers.append(traveler_blocks(-shift) if shift else travelers[0])
    queries_p = pad_rows_any(queries, q_pad, dtype=dtype)
    qids_p = pad_rows_any(np.asarray(query_ids, dtype=np.int32), q_pad,
                          fill=-1)
    q_sh = [queries_p[r * ql:(r + 1) * ql].to(d) for r, d in enumerate(devices)]
    qid_sh = [qids_p[r * ql:(r + 1) * ql].to(d) for r, d in enumerate(devices)]
    return q_tile, c_tile, q_sh, qid_sh, travelers


def ring_devices(cfg: KNNConfig, mesh, dev) -> list:
    if mesh is None:
        mesh = make_ring_mesh(cfg.num_devices, axis_name=cfg.mesh_axis,
                              device=dev)
    return _mesh_devices(mesh)


def all_knn_ring(corpus, queries, query_ids, cfg: KNNConfig, mesh=None,
                 overlap: bool = True, device=DEFAULT_DEVICE, form=None):
    """Pad and shard corpus and queries over the ring, rotate, gather the
    carries. ``form`` overrides ``ring_form`` (the CPU tests run the dma
    and grid forms over logical ranks on the kernels' plain versions).
    Returns ((q, k) dists, (q, k) ids) on ``device``."""
    if cfg.ring_fusion == "fused" and not overlap:
        raise fused_blocking_undefined_error()
    dev = torch.device(device)
    devices = ring_devices(cfg, mesh, dev)
    form = form or ring_form(cfg, devices)
    q_tile, c_tile, q_sh, qid_sh, travelers = ring_shards(
        cfg, corpus, queries, query_ids, devices)
    acc = torch.float64 if torch_dtype(cfg.dtype) == torch.float64 else torch.float32
    carries = [init_topk(q.shape[0], cfg.k, dtype=acc, device=d)
               for q, d in zip(q_sh, devices)]
    run = RingRun(cfg, devices, overlap, form, q_sh, qid_sh, travelers,
                  carries, q_tile, c_tile)
    run.rotate()
    return run.gathered(dev, queries.shape[0])


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
