"""The ring backends (``backend="ring"`` and ``"ring-overlap"``): the JAX
package's ``backends/ring.py``, run by one controlling process.

The corpus is padded and cut into one block per ring rank, the queries
into one shard per rank. Rank r keeps its query shard, its carry and its
current block on ``mesh[r]``. Every round each rank merges its resident
block into its carry, then the blocks move one rank on with
``Tensor.to(mesh[r + 1])``: P rounds for the ``"uni"`` schedule, so every
rank merges every block once. The ``"bidir"`` schedule sends every block
both ways at once and takes ⌊P/2⌋+1 rounds; its degenerate rounds (round 0,
and for even P the antipodal block arriving from both sides) merge once.

- ``ring-overlap``: a round's copies are started on side streams before its
  compute, so the transfer runs under the merge.
- ``ring``: the copies are started after the compute, with a sync between
  (the reference's compute-then-send schedule).

When two ranks share a device (the CPU ranks, or a mesh naming one card
several times) the block is handed on and no bytes move.

The per-round merge is the serial backend's tile loop (``ring_fusion=
"xla"``, through ``knn_chunk_update``) or the fused block merge of
``ops/fused_ring.py`` (``"fused"``), on an f32, bf16 or int8 wire.
Padding and tiling come from ``ring_tiles``, so the layouts are the JAX
package's. A dp×ring mesh, a resumable ring and a multi-process
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
from mpi_knn_tpu_torch.ops.fused_ring import fused_block_merge
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


def _merge(queries, qids, traveler, carry, cfg: KNNConfig, q_tile, c_tile):
    """One rank's merge of one resident block into its carry."""
    blk, blk_ids, scl = traveler
    if cfg.ring_fusion == "fused":
        return fused_block_merge(queries, qids, blk, blk_ids, scl, *carry,
                                 cfg=cfg, q_tile=q_tile, c_tile=c_tile)
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


def all_knn_ring(corpus, queries, query_ids, cfg: KNNConfig, mesh=None,
                 overlap: bool = True, device=DEFAULT_DEVICE):
    """Pad and shard corpus and queries over the ring, rotate, gather the
    carries. Returns ((q, k) dists, (q, k) ids) on ``device``."""
    if cfg.ring_fusion == "fused" and not overlap:
        raise fused_blocking_undefined_error()
    dev = torch.device(device)
    if mesh is None:
        mesh = make_ring_mesh(cfg.num_devices, axis_name=cfg.mesh_axis,
                              device=dev)
    devices = _mesh_devices(mesh)
    P = len(devices)
    m, dim = corpus.shape
    nq = queries.shape[0]
    q_tile, c_tile, q_pad, c_pad = ring_tiles(cfg, m, nq, 1, P)
    dtype = torch_dtype(cfg.dtype)

    corpus_p = pad_rows_any(corpus, c_pad, dtype=dtype)
    scale = None
    if cfg.ring_transfer_dtype == "int8":
        corpus_p, scale = quantize_ring_block(corpus_p)
    elif cfg.ring_transfer_dtype is not None:
        corpus_p = corpus_p.to(torch_dtype(cfg.ring_transfer_dtype))
    ids = torch.from_numpy(make_global_ids(m, c_pad))
    queries_p = pad_rows_any(queries, q_pad, dtype=dtype)
    qids_p = pad_rows_any(np.asarray(query_ids, dtype=np.int32), q_pad,
                          fill=-1)

    b, ql = c_pad // P, q_pad // P
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    q_sh, qid_sh, blocks, carries = [], [], [], []
    for r, d in enumerate(devices):
        rows = slice(r * ql, (r + 1) * ql)
        cols = slice(r * b, (r + 1) * b)
        q_sh.append(queries_p[rows].to(d))
        qid_sh.append(qids_p[rows].to(d))
        blocks.append((corpus_p[cols].to(d), ids[cols].to(d),
                       None if scale is None else scale[cols].to(d)))
        carries.append(init_topk(ql, cfg.k, dtype=acc, device=d))

    ring = _Transport(devices, overlap)

    def merge_all(held):
        for r in range(P):
            carries[r] = _merge(q_sh[r], qid_sh[r], held[r], carries[r], cfg,
                                q_tile, c_tile)

    # uni: one traveler, P rounds; bidir: a second one moving the other
    # way, merged only on the rounds that are not degenerate
    if cfg.ring_schedule == "bidir":
        (rounds, bwd_limit), shifts = bidir_rounds(P), (1, -1)
    else:
        (rounds, bwd_limit), shifts = (P, 0), (1,)
    travelers = [blocks] * len(shifts)

    def rotate_all():
        return [ring.rotate(t, s) for t, s in zip(travelers, shifts)]

    for rnd in range(rounds):
        last = rnd == rounds - 1
        if overlap and not last:
            nxt = rotate_all()  # started before the compute
        merge_all(travelers[0])
        if 1 <= rnd < bwd_limit:
            merge_all(travelers[1])
        if not last:
            travelers = nxt if overlap else rotate_all()
            ring.land()

    best_d = torch.cat([c[0].to(dev) for c in carries])[:nq]
    best_i = torch.cat([c[1].to(dev) for c in carries])[:nq]
    return best_d, best_i
