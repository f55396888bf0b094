"""Live mutation of the resident stores: the freelist's slot math on the
host, in-place upsert and delete scatters on the resident tensors, and the
re-cluster compaction (the JAX package's ``ivf/mutate.py``).

Headroom keeps a store's shapes fixed while its corpus changes: each
bucket is built with spare slots (``KNNConfig.bucket_headroom``:
``bucket_cap = pad(max_cluster · (1 + headroom))``), and mutation happens
inside those shapes:

- **upsert**: the new row's partition comes from the same full-f32
  centroid score the build assignment and the probe routing use (TF32 off,
  ``torch.argmin``'s first minimum as ``jnp.argmin``'s); a free slot comes
  from the host freelist; the rows, ids, norms (and scales) of the chunk
  are written into the resident tensors in place, the port's counterpart
  of the JAX package's donated scatter. Every store tensor keeps its
  storage (``data_ptr``), and the only new device memory is the chunk's;
- **delete**: a tombstone, the slot's id set to −1, which ``mask_tile``
  already treats as never an answer (the stale row stays, masked). The
  freelist takes the slot back for a later upsert;
- **compact**: when headroom runs low or tombstones accumulate
  (``compact_fill_threshold`` / ``compact_tombstone_fraction``), k-means is
  retrained on a deterministic sample of the live rows, every slot is
  assigned again on the device (``ivf_compact_assign``) and the live rows
  move by one scatter from the old store into a fresh one
  (``make_dst_store``, ``ivf_compact_scatter``); the row payload never
  visits the host. ``bucket_cap`` is kept whenever the live set still fits.

PyTorch has no ``mode="drop"`` scatter, and on a card an out-of-range
index is a device-side assert that poisons the process. The host plans
keep the reference's sentinel (one past the store's bucket count) for the
slots a chunk does not write, and :func:`_kept` drops those entries with a
host mask before any tensor reaches a scatter. Within one upsert the old
slots of ids that move are cleared first, then the new slots are set, as
the reference's sequence does; ids are unique within a chunk
(``serve.mutate._dedupe_last``), because repeated indices in an
``index_put_`` have no defined winner.

The freelist is host state (a mirror of the id plane), deterministic
(lowest free slot first) and derived from any saved index: "free slot"
and "id −1 slot" are the same thing.

A sharded store in slices (``ShardedIVFIndex.shard_store``: one slice a
card, or each process's own slices) keeps one freelist over the whole
padded store, derived from every slice's id plane in shard order, so its
plans are the one-store index's. The ``sliced_*`` functions apply them:
a chunk's rows, norms and scales are computed once where the chunk is,
and each entry goes to the slice of its partition, on that slice's card;
only the chunk moves, never a slice. A compaction assigns each slice on
its card, scatters each live row into a fresh slice of its new partition
(``Tensor.to`` to another card; one all-to-all of packed rows to another
process), and every process ends with the same freelist, built from the
plan. The result is the one-store index's, bit for bit.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from mpi_knn_tpu_torch.backends.serial import torch_dtype
from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.ops.distance import pairwise_sq_l2, sq_norms
from mpi_knn_tpu_torch.ops.quant import QUANT_DTYPES, dequantize_rows, quantize_rows
from mpi_knn_tpu_torch.parallel.partition import pad_to_multiple
from mpi_knn_tpu_torch.shapes import padded_bucket_cap


class BucketOverflowError(RuntimeError):
    """An upsert chunk needs more slots than some bucket has free: the
    headroom is exhausted for those partitions. Carries the partitions so
    the caller (``ServeSession.upsert`` / the compactor) can compact and
    retry."""

    def __init__(self, msg: str, partitions=()):
        super().__init__(msg)
        self.partitions = tuple(partitions)


# ---------------------------------------------------------------------------
# Freelist: the host mirror of slot occupancy


class Freelist:
    """Per-bucket free-slot stacks and the id → (partition, slot) map.

    Derived from the id plane (id −1 = free), never stored: any saved
    index reconstructs it exactly. Allocation is deterministic (lowest free
    slot first), so a mutation replayed against a reloaded index lands
    every row in the same slot.

    ``tombstones`` counts deleted slots not yet reused (an upsert that
    takes a tombstoned slot back decrements it); the compaction triggers
    read ``max_fill`` and ``tombstone_fraction``.
    """

    def __init__(self, bucket_ids: np.ndarray, partitions: int):
        ids = np.asarray(bucket_ids)
        self.partitions = int(partitions)
        # the sentinel of the slots a plan does not write: one past the
        # store's bucket count
        self.total = int(ids.shape[0])
        self.cap = int(ids.shape[1])
        # free stacks in reverse slot order, so .pop() yields the lowest
        self.free: list[list[int]] = [
            sorted(np.flatnonzero(ids[p] < 0).tolist(), reverse=True)
            for p in range(self.partitions)
        ]
        p_idx, s_idx = np.nonzero(ids[:self.partitions] >= 0)
        self.pos: dict[int, tuple[int, int]] = dict(zip(
            ids[p_idx, s_idx].tolist(), zip(p_idx.tolist(), s_idx.tolist())))
        self.tombstones = 0
        self._tomb_free = [0] * self.partitions

    @property
    def live(self) -> int:
        return len(self.pos)

    @property
    def max_fill(self) -> float:
        """Largest bucket fill fraction (used slots / cap)."""
        if not self.partitions:
            return 0.0
        return max((self.cap - len(f)) / self.cap for f in self.free)

    @property
    def tombstone_fraction(self) -> float:
        return self.tombstones / max(1, self.live)

    def id_plane(self) -> np.ndarray:
        """The ``(total, cap)`` id plane this freelist mirrors (−1 free)."""
        ids = np.full((self.total, self.cap), -1, np.int32)
        if self.pos:
            where = np.array(list(self.pos.values()), np.int64)
            ids[where[:, 0], where[:, 1]] = np.fromiter(self.pos, np.int64,
                                                        len(self.pos))
        return ids

    def stats(self) -> dict:
        used = [self.cap - len(f) for f in self.free]
        return {
            "live": self.live,
            "tombstones": self.tombstones,
            "cap": self.cap,
            "partitions": self.partitions,
            "max_fill": round(self.max_fill, 6),
            "tombstone_fraction": round(self.tombstone_fraction, 6),
            "free_slots": int(sum(len(f) for f in self.free)),
            "max_used": max(used) if used else 0,
        }


def freelist_of(index) -> Freelist:
    """The index's cached freelist, derived on first use from the resident
    id plane (one small copy to the host, ordered after every batch and
    mutation enqueued before it). Both mutable layouts: the clustered
    bucket store and the serial tile stack (every tile a "bucket" of
    c_tile slots). Mutation plans commit into it. It is derived under the
    index's mutation lock: a derivation racing a compaction's swap would
    otherwise map ids to the old store's slots."""
    fl = index.__dict__.get("_freelist")
    if fl is None:
        from mpi_knn_tpu_torch.serve.engine import mutation_lock, order_stream

        with mutation_lock(index):
            fl = index.__dict__.get("_freelist")
            if fl is None:
                order_stream(index)
                if getattr(index, "tiles", None) is not None:
                    ids = index.tile_ids.cpu().numpy()
                    fl = Freelist(ids, ids.shape[0])
                elif getattr(index, "shard_store", None) is not None:
                    from mpi_knn_tpu_torch.ivf.sharded import store_id_plane

                    fl = Freelist(store_id_plane(index), index.partitions)
                else:
                    fl = Freelist(index.bucket_ids.cpu().numpy(), index.partitions)
                index.__dict__["_freelist"] = fl
    return fl


def _desc(v: int) -> int:
    return -v


def _free_slot(stack: list, s: int) -> None:
    """Put slot ``s`` back on a free stack (kept in descending order)."""
    bisect.insort(stack, s, key=_desc)


def _take_slot(stack: list, s: int) -> None:
    """Take slot ``s`` off a free stack (kept in descending order)."""
    del stack[bisect.bisect_left(stack, -s, key=_desc)]


def plan_upsert(fl: Freelist, ids: np.ndarray, parts: np.ndarray):
    """Allocate slots for one upsert chunk without committing: returns
    ``(part, slot, clear_part, clear_slot, commit)``, the scatter index
    vectors (``clear_part`` is ``fl.total`` where no old slot is cleared)
    and ``commit()``, which applies the allocation to the freelist once the
    scatter is enqueued. An id already live is an update: in its own
    partition its slot is overwritten in place; in another, its old slot
    is cleared and a fresh one taken. ``ids`` must be unique. Raises
    :class:`BucketOverflowError` (freelist untouched) when a target bucket
    is out of free slots."""
    n = len(ids)
    part = np.empty(n, np.int32)
    slot = np.empty(n, np.int32)
    clear_part = np.full(n, fl.total, np.int32)
    clear_slot = np.zeros(n, np.int32)
    taken: dict[int, int] = {}  # partition -> slots consumed by this plan
    moves: list[tuple] = []  # (rid, old_pos or None, new_p, new_s)
    overflow = set()
    for i, (rid, p) in enumerate(zip(ids, parts)):
        rid, p = int(rid), int(p)
        old = fl.pos.get(rid)
        if old is not None and old[0] == p:
            part[i], slot[i] = p, old[1]
            continue
        if old is not None:
            clear_part[i], clear_slot[i] = old
        depth = taken.get(p, 0)
        stack = fl.free[p]
        if depth >= len(stack):
            overflow.add(p)
            continue
        s = int(stack[-1 - depth])
        taken[p] = depth + 1
        part[i], slot[i] = p, s
        moves.append((rid, old, p, s))
    if overflow:
        raise BucketOverflowError(
            f"bucket headroom exhausted for partition(s) "
            f"{sorted(overflow)} (cap={fl.cap}); compact the index "
            "(re-cluster rebalances and re-derives headroom) and retry",
            partitions=sorted(overflow),
        )

    def commit():
        for rid, old, p, s in moves:
            if old is not None:
                op, os_ = old
                _free_slot(fl.free[op], int(os_))
                fl._tomb_free[op] += 1
                fl.tombstones += 1
            _take_slot(fl.free[p], s)
            if fl._tomb_free[p] > 0:
                fl._tomb_free[p] -= 1
                fl.tombstones -= 1
            fl.pos[rid] = (p, s)

    return part, slot, clear_part, clear_slot, commit


def plan_delete(fl: Freelist, ids: np.ndarray):
    """(part, slot, commit, missing): the slots of every live id in
    ``ids`` (``part`` is ``fl.total`` for the rest; unknown ids are counted
    in ``missing``: deleting an absent id is not an error)."""
    n = len(ids)
    part = np.full(n, fl.total, np.int32)
    slot = np.zeros(n, np.int32)
    found = []
    missing = 0
    for i, rid in enumerate(ids):
        old = fl.pos.get(int(rid))
        if old is None:
            missing += 1
            continue
        part[i], slot[i] = old
        found.append(int(rid))

    def commit():
        for rid in found:
            p, s = fl.pos.pop(rid)
            _free_slot(fl.free[p], s)
            fl._tomb_free[p] += 1
            fl.tombstones += 1

    return part, slot, commit, missing


def _kept(part: np.ndarray, slot: np.ndarray, total: int):
    """The (part, slot) entries below the sentinel ``total`` as int64 host
    arrays, or None when there is none: the host mask that stands in for
    ``mode="drop"``, so no scatter ever sees an index out of range."""
    keep = np.flatnonzero(np.asarray(part) < total)
    if keep.size == 0:
        return None
    return np.asarray(part, np.int64)[keep], np.asarray(slot, np.int64)[keep]


# ---------------------------------------------------------------------------
# Device functions: each writes into the resident tensors in place


def store_rows_and_sqs(rows: torch.Tensor, cfg: KNNConfig, dim: int):
    """(at-rest rows, scales or None, norms) of a chunk of centered f32
    rows, by the build's own per-row math (the cast for float stores, the
    block-scaled quantizer and the norms of the dequantized rows for int8 /
    int4), so a mutated slot equals a built one."""
    if cfg.dtype in QUANT_DTYPES:
        codes, scales = quantize_rows(rows, dtype=cfg.dtype)
        sqs = sq_norms(dequantize_rows(codes, scales, cfg.dtype, dim))
        return codes, scales, sqs
    at_rest = rows.to(torch_dtype(cfg.dtype))
    if cfg.metric != "l2":
        # cosine tile stacks carry zero norms (the metric normalizes
        # inside), as the build's
        acc = torch.float64 if cfg.dtype == "float64" else torch.float32
        return at_rest, None, torch.zeros(rows.shape[:1], dtype=acc,
                                          device=rows.device)
    return at_rest, None, sq_norms(at_rest)


def ivf_assign_chunk(rows, centroids, centroid_sqs) -> torch.Tensor:
    """Nearest partition of each centered f32 row: the full-f32 centroid
    score of the build's assignment (TF32 off), the first minimum winning.
    (B, d) → (B,) int64."""
    cd = pairwise_sq_l2(rows, centroids, x_sq=sq_norms(rows), y_sq=centroid_sqs)
    return torch.argmin(cd, dim=1)


def ivf_upsert_chunk(rows, new_ids, part, slot, clear_part, clear_slot,
                     buckets, bucket_ids, bucket_sqs, bucket_scales,
                     cfg: KNNConfig):
    """One upsert chunk into the resident store, in place: clear the old
    slots of ids that move (``clear_part`` None when none does), then write
    the chunk's at-rest rows, ids, norms (and scales) into their slots.
    ``rows`` may carry padding rows past ``len(part)``; the first
    ``len(part)`` rows are the chunk's, in the order of ``part``."""
    at_rest, scales, sqs = store_rows_and_sqs(rows, cfg, rows.shape[-1])
    n = part.shape[0]
    if clear_part is not None:
        bucket_ids[clear_part, clear_slot] = -1
    bucket_ids[part, slot] = new_ids
    buckets[part, slot] = at_rest[:n]
    bucket_sqs[part, slot] = sqs[:n].to(bucket_sqs.dtype)
    if bucket_scales is not None:
        bucket_scales[part, slot] = scales[:n]


def ivf_delete_chunk(part, slot, bucket_ids):
    """One tombstone chunk, in place: the ids at the given slots go to −1
    (``mask_tile`` makes them +inf candidates). The rows stay resident and
    masked; the freelist takes the slots back."""
    bucket_ids[part, slot] = -1


def upload_ints(device, *arrays) -> list:
    """Host int arrays (None stays None) to ``device`` as int64 in one copy,
    so the host waits on the copy once, not once a vector."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.int64) for a in arrays if a is not None])).to(device)
    out, at = [], 0
    for a in arrays:
        out.append(None if a is None else flat[at:at + len(a)])
        at += 0 if a is None else len(a)
    return out


def _shard_entries(index, part, slot):
    """Per shard this process holds, in shard order: (shard, positions in
    the plan, local partition, slot) of the plan's entries whose partition
    lies in that shard (sentinel entries dropped)."""
    part = np.asarray(part, np.int64)
    slot = np.asarray(slot, np.int64)
    shard = np.where(part < index.shards * index.per_shard,
                     part // index.per_shard, -1)
    for s in index.local_shards:
        sel = np.flatnonzero(shard == s)
        if sel.size:
            yield s, sel, part[sel] - s * index.per_shard, slot[sel]


def sliced_upsert_chunk(index, rows, ids: np.ndarray, part, slot, clear_part,
                        clear_slot, cfg: KNNConfig):
    """:func:`ivf_upsert_chunk` on a store in slices: the chunk's at-rest
    rows, norms (and scales) computed once on ``rows``' device by the
    build's math; then the old slots of moving ids are cleared and each
    entry is written into the slice of its partition, on that slice's
    card. Across processes each process writes only the shards it holds.
    ``ids`` and the plan are host arrays."""
    at_rest, scales, sqs = store_rows_and_sqs(rows, cfg, rows.shape[-1])
    slices = index.slices
    for s, _, lp, ls in _shard_entries(index, clear_part, clear_slot):
        plane = slices[s][1]
        lp, ls = upload_ints(plane.device, lp, ls)
        plane[lp, ls] = -1
    for s, sel, lp, ls in _shard_entries(index, part, slot):
        buckets, bids, bsqs, bscl = slices[s]
        dev = buckets.device
        take = torch.from_numpy(sel).to(rows.device)
        lp, ls, new_ids = upload_ints(dev, lp, ls, np.asarray(ids)[sel])
        bids[lp, ls] = new_ids.to(torch.int32)
        buckets[lp, ls] = at_rest[take].to(dev)
        bsqs[lp, ls] = sqs[take].to(dev, bsqs.dtype)
        if bscl is not None:
            bscl[lp, ls] = scales[take].to(dev)


def sliced_delete_chunk(index, part, slot):
    """:func:`ivf_delete_chunk` on a store in slices: each tombstone on
    the card of its partition's slice (the shards this process holds)."""
    slices = index.slices
    for s, _, lp, ls in _shard_entries(index, part, slot):
        plane = slices[s][1]
        lp, ls = upload_ints(plane.device, lp, ls)
        plane[lp, ls] = -1


def ivf_compact_assign(buckets, bucket_scales, centroids, centroid_sqs,
                       cfg: KNNConfig) -> torch.Tensor:
    """Partition of every slot of the resident store against (possibly
    retrained) centroids, bucket by bucket so the distance block stays
    (cap, P). Returns (P_total · cap,) int64; the host plan masks free
    slots by the id plane."""
    dim = centroids.shape[1]
    parts = []
    for p in range(buckets.shape[0]):
        rows = buckets[p]
        if bucket_scales is not None:
            rows = dequantize_rows(rows, bucket_scales[p], cfg.dtype, dim)
        parts.append(ivf_assign_chunk(rows.to(torch.float32), centroids,
                                      centroid_sqs))
    return torch.cat(parts)


def ivf_compact_scatter(dst_part, dst_slot, src_buckets, src_ids, src_sqs,
                        src_scales, dst_buckets, dst_ids, dst_sqs, dst_scales):
    """The compaction's move as one scatter per tensor: every live row goes
    from its old flat slot into its re-clustered (part, slot) of the fresh
    store, on the device. ``dst_part`` / ``dst_slot`` are host arrays over
    the old flat slots, ``dst_part`` the sentinel (the store's bucket
    count) for free slots; only the live entries reach the scatter."""
    total = src_buckets.shape[0]
    src = np.flatnonzero(np.asarray(dst_part) < total)
    if src.size == 0:
        return
    dev = src_buckets.device
    src_t = torch.from_numpy(src).to(dev)
    part = torch.from_numpy(np.asarray(dst_part, np.int64)[src]).to(dev)
    slot = torch.from_numpy(np.asarray(dst_slot, np.int64)[src]).to(dev)
    dst_buckets[part, slot] = src_buckets.reshape(-1, src_buckets.shape[-1])[src_t]
    dst_ids[part, slot] = src_ids.reshape(-1)[src_t]
    dst_sqs[part, slot] = src_sqs.reshape(-1)[src_t]
    if dst_scales is not None:
        dst_scales[part, slot] = src_scales.reshape(-1)[src_t]


# ---------------------------------------------------------------------------
# Compaction planning (host): a sample-retrained k-means and one device
# scatter; bucket_cap kept whenever the live set still fits


COMPACT_SAMPLE = 16384  # deterministic live-row sample of the retrain


def gather_live_sample(index, limit: int = COMPACT_SAMPLE) -> np.ndarray | None:
    """Up to ``limit`` live rows (dequantized, in the centered frame),
    evenly spaced in id order, by one small device gather: the retrain
    never copies the whole store to the host. A store in slices gathers
    each slice's share on its card; across processes the shares go to
    process 0, which retrains (the others get None)."""
    fl = freelist_of(index)
    ids = sorted(fl.pos)
    if not ids:
        raise ValueError("cannot compact an empty index (no live rows)")
    take = np.linspace(0, len(ids) - 1, num=min(limit, len(ids)),
                       dtype=np.int64)
    flat = np.array(
        [fl.pos[ids[i]][0] * fl.cap + fl.pos[ids[i]][1] for i in take],
        dtype=np.int64,
    )
    if getattr(index, "shard_store", None) is None:
        flat_t = torch.from_numpy(flat).to(index.device)
        sel = index.buckets.reshape(-1, index.buckets.shape[-1])[flat_t]
        scl = (None if index.bucket_scales is None
               else index.bucket_scales.reshape(-1)[flat_t])
    else:
        sel, scl = _sliced_sample(index, flat, fl.cap)
        if sel is None:
            return None
    if scl is not None:
        sel = dequantize_rows(sel, scl, index.store_dtype, index.dim)
    return sel.to(torch.float32).cpu().numpy()


def _sliced_sample(index, flat: np.ndarray, cap: int):
    """The at-rest rows and scales at the store's flat slots ``flat``,
    from the slices that hold them, in ``flat``'s order on the index's
    device. Across processes every process sends its share to process 0
    (one all-to-all of packed rows) and only process 0 gets (rows,
    scales); the others get (None, None)."""
    from mpi_knn_tpu_torch.ivf.sharded import move_rows, pack_rows, unpack_rows
    from mpi_knn_tpu_torch.parallel import distributed

    span = index.per_shard * cap
    shard = flat // span
    like = index.held_slice
    likes = (like[0][0, 0][None], None if like[3] is None else like[3][0, :1])
    rows = torch.empty((flat.size,) + tuple(like[0].shape[2:]), dtype=like[0].dtype,
                       device=index.device)
    scales = (None if like[3] is None
              else torch.empty(flat.size, dtype=like[3].dtype, device=index.device))

    def place(pos, got_rows, got_scales):
        at = torch.from_numpy(pos).to(index.device)
        rows[at] = got_rows.to(index.device)
        if scales is not None:
            scales[at] = got_scales.to(index.device)

    mine = []
    for s, sl in index.held():
        pos = np.flatnonzero(shard == s)
        if not pos.size:
            continue
        at = torch.from_numpy(flat[pos] - s * span).to(sl[0].device)
        got = (sl[0].reshape((-1,) + tuple(sl[0].shape[2:]))[at],
               None if sl[3] is None else sl[3].reshape(-1)[at])
        mine.append((pos, got))
    if not index.spans_processes:
        for pos, got in mine:
            place(pos, *got)
        return rows, scales
    owners = index.shard_owners()[shard]
    procs, me = distributed.process_count(), distributed.process_index()
    counts = np.zeros((procs, procs), np.int64)
    counts[:, 0] = np.bincount(owners, minlength=procs)
    counts[0, 0] = 0
    width = pack_rows([likes[0], likes[1]]).shape[1]
    sends = {}
    if me != 0 and mine:
        sends[0] = torch.cat([pack_rows([g[0].to(index.device),
                                         None if g[1] is None else g[1].to(index.device)])
                              for _, g in mine])
    got = move_rows(index, sends, counts, width)
    if me != 0:
        return None, None
    for pos, g in mine:
        place(pos, *g)
    owner = index.shard_owners()
    for q, buf in got.items():
        # process q packed its shards' shares in shard order
        pos = np.concatenate([np.flatnonzero(shard == s)
                              for s in range(index.shards) if owner[s] == q])
        place(pos, *unpack_rows(buf, likes))
    return rows, scales


def retrain_centroids(index, cfg: KNNConfig, sample: np.ndarray | None):
    """K-means (the port's ``ivf/kmeans.py``) over a live-row sample,
    seeded with ``ivf_seed``, on the index's device → (centroids,
    centroid_sqs). It touches no resident tensor, so callers run it off
    the mutation lock. Across processes process 0 trains on the sample it
    gathered and broadcasts the centroids: every process ends with the
    same table, bit for bit."""
    from mpi_knn_tpu_torch.ivf.kmeans import kmeans

    spans = getattr(index, "spans_processes", False)
    if spans:
        from mpi_knn_tpu_torch.parallel import distributed

        if distributed.process_index() != 0:
            sample = None
    centroids = None
    if sample is not None:
        res = kmeans(sample, index.partitions, iters=cfg.kmeans_iters,
                     seed=cfg.ivf_seed, init=cfg.kmeans_init, device=index.device)
        centroids = res.centroids
    if spans:
        host = (centroids.cpu().numpy() if centroids is not None
                else np.zeros(tuple(index.centroids.shape), np.float32))
        with distributed.collective("compaction retrain"):
            host = distributed.broadcast_host(host)
        centroids = torch.from_numpy(host).to(index.device)
    return centroids, sq_norms(centroids)


def plan_compact(index, cfg: KNNConfig, centroids, centroid_sqs,
                 min_cap: int | None = None):
    """The lock-held half of a compaction: every slot assigned on the
    device against the (possibly retrained) centroids, and the new store's
    layout. Returns ``(dst_part, dst_slot, new_cap, stats)``; the scatter
    is the caller's. ``new_cap`` is the current cap whenever the
    re-clustered live set fits; ``min_cap`` forces growth (the backstop for
    a burst that must fit after this pass). A store in slices is assigned
    slice by slice on each slice's card (gathered across processes)."""
    fl = freelist_of(index)
    if getattr(index, "shard_store", None) is None:
        parts = ivf_compact_assign(index.buckets, index.bucket_scales, centroids,
                                   centroid_sqs, index.cfg).cpu().numpy()
    else:
        parts = _sliced_assign(index, centroids, centroid_sqs)
    ids_flat = fl.id_plane().reshape(-1)
    live = ids_flat >= 0
    counts = np.bincount(parts[live], minlength=index.partitions)
    need = int(counts.max()) if counts.size else 1
    headroom_cap = padded_bucket_cap(need, cfg.bucket_headroom)
    new_cap = index.bucket_cap if need <= index.bucket_cap else headroom_cap
    if min_cap is not None:
        new_cap = max(new_cap, pad_to_multiple(int(min_cap), 8))
    # destination layout: the live rows, in flat-slot order, take
    # consecutive slots of their new partition (deterministic)
    n = ids_flat.shape[0]
    dst_part = np.full(n, fl.total, np.int32)
    dst_slot = np.zeros(n, np.int32)
    src = np.flatnonzero(live)
    lp = parts[src]
    order = np.argsort(lp, kind="stable")
    sp = lp[order]
    dst_part[src] = lp
    dst_slot[src[order]] = np.arange(sp.size) - np.searchsorted(sp, sp)
    stats = {
        "live": int(live.sum()),
        "tombstones_reclaimed": fl.tombstones,
        "cap_before": index.bucket_cap,
        "cap_after": int(new_cap),
        "max_bucket": need,
    }
    return dst_part, dst_slot, int(new_cap), stats


def _sliced_assign(index, centroids, centroid_sqs) -> np.ndarray:
    """:func:`ivf_compact_assign` over every slice, each on its card
    against the centroids there, as one host array in shard order
    (gathered from every process across processes)."""
    parts = []
    for _, sl in index.held():
        dev = sl[0].device
        parts.append(ivf_compact_assign(sl[0], sl[3], centroids.to(dev),
                                        centroid_sqs.to(dev), index.cfg).cpu())
    mine = torch.cat(parts)
    if index.spans_processes:
        from mpi_knn_tpu_torch.parallel import distributed

        with distributed.collective("compaction assignment"):
            mine = distributed.all_gather_rows(mine)
    return mine.numpy()


def freelist_after_compact(fl: Freelist, dst_part, dst_slot, new_cap: int,
                           partitions: int) -> Freelist:
    """The freelist of the compacted store, from the plan alone (no read
    of the store, no collective): each live id at its new slot."""
    ids = fl.id_plane().reshape(-1)
    src = np.flatnonzero(np.asarray(dst_part) < fl.total)
    plane = np.full((fl.total, new_cap), -1, np.int32)
    plane[np.asarray(dst_part)[src], np.asarray(dst_slot)[src]] = ids[src]
    return Freelist(plane, partitions)


def should_compact(index, cfg: KNNConfig) -> str | None:
    """The trigger: "fill" or "tombstones" when a compaction threshold is
    crossed, else None. With no ``bucket_headroom`` there is no fill
    trigger: a pass re-packs the fullest bucket as full as it found it
    (:func:`plan_compact`), so it would fire again on every check."""
    fl = freelist_of(index)
    if cfg.bucket_headroom > 0 and fl.max_fill >= cfg.compact_fill_threshold:
        return "fill"
    if fl.tombstones > 0 and fl.tombstone_fraction >= cfg.compact_tombstone_fraction:
        return "tombstones"
    return None


def make_dst_store(index, new_cap: int):
    """A fresh destination store for a compaction, on the index's device:
    ids −1 (every slot free), rows, norms and scales zero. A store in
    slices gets one slice a held shard, on that shard's card (None for
    the shards of other processes)."""
    if getattr(index, "shard_store", None) is not None:
        held = set(index.local_shards)
        return [_empty_store(sl, sl[0].shape[0], new_cap) if s in held else None
                for s, sl in enumerate(index.slices)]
    return _empty_store((index.buckets, index.bucket_ids, index.bucket_sqs,
                         index.bucket_scales), index.buckets.shape[0], new_cap)


def _empty_store(like, buckets: int, cap: int):
    rows, _, sqs, scales = like
    dev = rows.device
    return (torch.zeros((buckets, cap) + tuple(rows.shape[2:]), dtype=rows.dtype,
                        device=dev),
            torch.full((buckets, cap), -1, dtype=torch.int32, device=dev),
            torch.zeros((buckets, cap), dtype=sqs.dtype, device=dev),
            None if scales is None else torch.zeros((buckets, cap),
                                                    dtype=torch.float32, device=dev))


def sliced_compact_scatter(index, dst_part, dst_slot, dst) -> None:
    """:func:`ivf_compact_scatter` on a store in slices: every live row
    from its old slice into the fresh slice ``dst[s]`` of its new
    partition. The rows of each held source slice are gathered on its
    card; those whose new shard this process holds move by ``Tensor.to``,
    the rest by one all-to-all of packed rows to the process that holds
    it. Every process iterates the moves in one order, (source shard,
    destination shard, old slot), so the receiver knows each row's slot
    without being told."""
    from mpi_knn_tpu_torch.ivf.sharded import move_rows, pack_rows, unpack_rows
    from mpi_knn_tpu_torch.parallel import distributed

    slices = index.slices
    like = index.held_slice
    cap = like[0].shape[1]
    per = index.per_shard
    dst_part = np.asarray(dst_part, np.int64)
    dst_slot = np.asarray(dst_slot, np.int64)
    src = np.flatnonzero(dst_part < index.shards * per)
    src_shard = src // (per * cap)
    dst_shard = dst_part[src] // per
    order = np.lexsort((src, dst_shard, src_shard))
    src, src_shard, dst_shard = src[order], src_shard[order], dst_shard[order]
    owner = index.shard_owners()
    me = distributed.process_index()

    def write(sel, parts):
        for d in np.unique(dst_shard[sel]):
            m = dst_shard[sel] == d
            drows, dids, dsqs, dscl = dst[d]
            dev = drows.device
            at = torch.from_numpy(np.flatnonzero(m)).to(parts[0].device)
            lp, ls = upload_ints(dev, dst_part[src[sel][m]] - d * per,
                                dst_slot[src[sel][m]])
            drows[lp, ls] = parts[0][at].to(dev)
            dids[lp, ls] = parts[1][at].to(dev)
            dsqs[lp, ls] = parts[2][at].to(dev)
            if dscl is not None:
                dscl[lp, ls] = parts[3][at].to(dev)

    procs = distributed.process_count() if index.spans_processes else 1
    sends = {q: [] for q in range(procs)}
    for s, sl in index.held():
        sel = np.flatnonzero(src_shard == s)
        if not sel.size:
            continue
        at = torch.from_numpy(src[sel] - s * per * cap).to(sl[0].device)
        parts = [None if t is None else t.reshape((-1,) + tuple(t.shape[2:]))[at]
                 for t in sl]
        stay = owner[dst_shard[sel]] == me
        write(sel[stay], [None if t is None
                          else t[torch.from_numpy(np.flatnonzero(stay)).to(t.device)]
                          for t in parts])
        for q in range(procs):
            go = np.flatnonzero(owner[dst_shard[sel]] == q)
            if q != me and go.size:
                g = torch.from_numpy(go).to(parts[0].device)
                sends[q].append(pack_rows([None if t is None else t[g].to(index.device)
                                           for t in parts]))
    if not index.spans_processes:
        return
    pairs = owner[src_shard] * procs + owner[dst_shard]
    counts = np.bincount(pairs, minlength=procs * procs).reshape(procs, procs)
    np.fill_diagonal(counts, 0)
    likes = [like[0][0, 0][None], like[1][0, :1], like[2][0, :1],
             None if like[3] is None else like[3][0, :1]]
    width = pack_rows(likes).shape[1]
    got = move_rows(index, {q: torch.cat(v) for q, v in sends.items() if v},
                    counts, width)
    for q, buf in got.items():
        sel = np.flatnonzero((owner[src_shard] == q) & (owner[dst_shard] == me))
        write(sel, unpack_rows(buf, likes))
