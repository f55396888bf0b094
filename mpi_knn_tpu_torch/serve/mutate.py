"""Live index mutation through the serving stack: host orchestration
(freelist plan → in-place scatter → commit) and the background
re-cluster/compact worker (the JAX package's ``serve/mutate.py``).

- **In place.** Every upsert and delete writes into the resident tensors
  themselves (``ivf/mutate.py``), the port's counterpart of the reference's
  donated scatters: each store tensor keeps its storage, and the only new
  device memory is the chunk's. A compaction is the one step that
  allocates a store: it scatters into a fresh one and swaps it in.
- **One writer at a time, serialized with dispatch.** The per-index lock
  ``engine.mutation_lock`` serializes every mutation (and the compaction's
  swap) with the engine's batch dispatch, so a batch runs against a
  consistent store. On a card, ``engine.order_stream`` chains the streams
  that take the lock, so a batch dispatched before a mutation reads the
  store before the mutation writes it, whichever threads and streams
  they run on; a compaction marks the old store's tensors as used by the
  chain's stream (``record_stream``), so their memory is not reused before
  the batches that read them are done. A chunk is prepared on a side
  stream of the index's (its copy to the card, the centroid score the
  host reads back, the index vectors), so the mutating thread never waits
  for the batches queued on the serving stream; the scatter itself is
  enqueued on the mutating thread's stream, after them.
- **Compaction in the background.** ``Compactor`` is a daemon thread that
  watches the freelist's triggers (``compact_fill_threshold`` /
  ``compact_tombstone_fraction``) and runs the re-cluster: k-means
  retrained on a live-row sample off the lock, then, under it, one
  assignment pass, one scatter into a fresh store and the swap, between
  batches.

Chunks pad to ``mutation_bucket · 2^j`` rows (the serve buckets applied to
writes; ``bucket`` in every stats dict); the padding rows are computed
with the chunk and never written.

Layouts: the serial ``CorpusIndex`` tile stack (headroom rows, a flat
freelist), the clustered ``IVFIndex`` (per-bucket freelists,
centroid-scored placement) and the sharded ``ShardedIVFIndex`` whose
shards share one device (the same scatters into the whole padded store,
the freelist's sentinel one past its total bucket count, so S = 1 mutates
bit for bit as the unsharded store). The ring and pallas layouts refuse,
and so does a sharded store spread over distinct cards.

The reference's XLA half has no counterpart in eager PyTorch and is left
out: ``lower_mutation``, ``get_mutation_executable``,
``expected_mutation_args``, ``_mutation_chunk_specs``, ``_store_sds``,
``_chunk_sds``, ``_replicated``, ``_put_chunk``, ``_bucket_sharding``,
``_compact_dst_shapes``, ``_normalize_store_out`` and the module-level
jits. ``warm_mutation`` keeps the reference's contract (the first live
upsert pays nothing lazy) with what is lazy here: the freelist's
derivation, the card's preparation stream, and each operation's first
launch (a scratch pass through the same functions, on copies).

Observability and load shedding stand where the reference has them: each
upsert, delete and compaction is a ``mutate`` span of the flight record;
the ``mutation_*``, ``compact*`` and ``index_*`` metrics feed the
registry; the compactor beats the heartbeat at each phase and defers
(``compact_deferred_total``, a ``compact-deferred`` event) while its
session is off the full ladder rung.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.obs import metrics as obs_metrics
from mpi_knn_tpu_torch.obs import spans as obs_spans
from mpi_knn_tpu_torch.ivf.mutate import (
    BucketOverflowError,
    _kept,
    freelist_of,
    gather_live_sample,
    ivf_assign_chunk,
    ivf_compact_scatter,
    ivf_delete_chunk,
    ivf_upsert_chunk,
    make_dst_store,
    plan_compact,
    plan_delete,
    plan_upsert,
    retrain_centroids,
    should_compact,
    store_rows_and_sqs,
)
from mpi_knn_tpu_torch.ops.distance import center_rows
from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat

__all__ = [
    "BucketOverflowError",
    "Compactor",
    "compact_index",
    "delete_rows",
    "mutation_stats",
    "supports_mutation",
    "upsert_rows",
    "warm_mutation",
]

MUTABLE_BACKENDS = ("serial", "ivf", "ivf-sharded")

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Heartbeats, spans, metrics and load shedding (resilience/, obs/)

CHUNK_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
                     4096)

# the reference's mutation metrics: name -> (kind, help, histogram buckets)
_METRICS = {
    "mutation_upserts_total": ("counter", "rows upserted into live indices", None),
    "mutation_deletes_total": ("counter", "rows tombstoned in live indices", None),
    "mutation_chunk_rows": ("histogram", "rows per mutation chunk (upsert+delete)",
                            CHUNK_ROW_BUCKETS),
    "mutation_latency_seconds": (
        "histogram", "wall time of one mutation call (plan + in-place "
        "scatter + commit)", obs_metrics.DEFAULT_LATENCY_BUCKETS_S),
    "compactions_total": ("counter", "background/manual compaction passes run",
                          None),
    "compact_wall_seconds": ("histogram", "wall time of one compaction pass",
                             obs_metrics.DEFAULT_LATENCY_BUCKETS_S),
    "compact_deferred_total": (
        "counter", "compaction ticks deferred because the session was "
        "shedding load (compaction is shed first)", None),
    "compact_errors_total": (
        "counter", "compaction passes that raised (the compactor keeps "
        "running; the store is untouched on failure)", None),
}


def _span(name: str, **attrs):
    """The ``upsert`` / ``delete`` / ``compact`` span of the flight
    record."""
    return obs_spans.span(name, cat="mutate", **attrs)


def _observe(metric: str, value: float = 1.0) -> None:
    """Count (a counter) or observe (a histogram) one of the reference's
    mutation metrics in the registry."""
    kind, help_, buckets = _METRICS[metric]
    reg = obs_metrics.get_registry()
    if kind == "counter":
        reg.counter(metric, help=help_).inc(value)
    else:
        reg.histogram(metric, help=help_, buckets=buckets).observe(value)


def _shedding(session) -> bool:
    """Whether the session is off its full ladder rung, where compaction
    is deferred first: a degraded session is already fighting for the
    device, and deferring costs headroom, not correctness."""
    from mpi_knn_tpu_torch.resilience.ladder import FULL_RUNG

    return session.rung != FULL_RUNG


def _stamp_gauges(index) -> None:
    """The freelist's ``index_live_rows``, ``index_tombstone_fraction`` and
    ``index_max_bucket_fill`` gauges."""
    fl = freelist_of(index)
    reg = obs_metrics.get_registry()
    reg.gauge("index_live_rows",
              help="live (non-tombstoned) rows in the index").set(fl.live)
    reg.gauge("index_tombstone_fraction",
              help="tombstoned slots as a fraction of live rows (a "
              "compaction trigger)").set(fl.tombstone_fraction)
    reg.gauge("index_max_bucket_fill",
              help="largest bucket fill fraction (headroom exhaustion: a "
              "compaction trigger)").set(fl.max_fill)


# ---------------------------------------------------------------------------


def supports_mutation(index) -> bool:
    return getattr(index, "backend", None) in MUTABLE_BACKENDS


def _require_mutable(index) -> None:
    if not supports_mutation(index):
        raise ValueError(
            f"the {getattr(index, 'backend', None)!r} layout cannot honor "
            "live mutation: the ring backends hold wire-representation "
            "corpus shards (a scatter would corrupt quantized blocks) and "
            "the pallas kernel masks by row count, not ids — serve "
            "mutable corpora from the serial, ivf, or ivf-sharded layouts"
        )
    if getattr(index, "shard_store", None) is not None:
        raise ValueError(
            "a sharded clustered store spread over distinct cards cannot "
            "honor live mutation in this port (one controlling process "
            "mutates a store that lies on one device); serve it from a "
            "mesh that names one card, or unsharded")


def serial_upsert_chunk(rows, new_ids, tpos, spos, clear_t, clear_s,
                        tiles, tile_ids, tile_sqs, cfg: KNNConfig):
    """One upsert chunk into the serial tile stack, in place: headroom rows
    (id −1) take new rows at the (tile, slot) the flat freelist gave;
    updated ids clear their old slot first (``clear_t`` None when none
    moves). The cast and the norms are the build's
    (``ivf.mutate.store_rows_and_sqs``); the first ``len(tpos)`` rows are
    the chunk's, the rest padding."""
    at_rest, _, sqs = store_rows_and_sqs(rows, cfg, rows.shape[-1])
    n = tpos.shape[0]
    if clear_t is not None:
        tile_ids[clear_t, clear_s] = -1
    tile_ids[tpos, spos] = new_ids
    tiles[tpos, spos] = at_rest[:n]
    tile_sqs[tpos, spos] = sqs[:n].to(tile_sqs.dtype)



# ---------------------------------------------------------------------------
# Orchestration: plan → in-place scatter → commit


def _store(index) -> tuple:
    """The resident store tensors a mutation writes, in call order."""
    if index.backend == "serial":
        return (index.tiles, index.tile_ids, index.tile_sqs)
    return (index.buckets, index.bucket_ids, index.bucket_sqs,
            index.bucket_scales)


def _check_rows(index, rows) -> None:
    if rows.ndim != 2 or rows.shape[1] != index.dim:
        raise ValueError(
            f"upsert rows must be (n, dim={index.dim}), got {tuple(rows.shape)}"
        )


def _center_rows(index, rows) -> torch.Tensor:
    """The build's centering of an upsert chunk: rows enter the store in
    the index's centered frame (the frozen build-time mean; L2 does not
    move with a translation, so a drifting mean costs conditioning, not
    correctness). A host mean is subtracted in f64, then the rows are cast
    to f32, as the build does; a tensor mean (an index built from a
    tensor) where it lies. Returns (n, dim) f32 on the index's device."""
    mu = index.mu
    if isinstance(rows, torch.Tensor) or isinstance(mu, torch.Tensor):
        rows = torch.as_tensor(rows, device=index.device)
        if mu is not None:
            rows = center_rows(rows, mu)
        return rows.to(torch.float32)
    if mu is not None:
        rows = rows - np.asarray(mu)
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    return torch.from_numpy(rows).to(index.device)


def _dedupe_last(ids: np.ndarray, rows):
    """The last occurrence of an id wins within one chunk (repeated
    scatter indices apply in no defined order). ``rows``: an array, a
    tensor or None."""
    _, last = np.unique(ids[::-1], return_index=True)
    keep = np.sort(len(ids) - 1 - last)
    if len(keep) == len(ids):
        return ids, rows
    if isinstance(rows, torch.Tensor):
        return ids[keep], rows[torch.from_numpy(keep).to(rows.device)]
    return ids[keep], (None if rows is None else rows[keep])


def _prep_stream(index):
    """The side stream a card prepares mutation chunks on (the rows' copy,
    the centroid score and its read back, the index vectors), at high
    priority: reads that make the host wait then wait for the chunk's own
    work only, never for the batches queued on the serving stream. It is
    made after one synchronization of the card, so every write before the
    first mutation (the build, a load) is done before it reads the
    centroids; later centroids come from a compaction, which reads them
    back before its swap. None off the card."""
    if index.device.type != "cuda":
        return None
    from mpi_knn_tpu_torch.serve.engine import mutation_lock

    stream = index.__dict__.get("_prep_stream")
    if stream is None:
        with mutation_lock(index):
            stream = index.__dict__.get("_prep_stream")
            if stream is None:
                torch.cuda.synchronize(index.device)
                stream = torch.cuda.Stream(index.device, priority=-1)
                index.__dict__["_prep_stream"] = stream
    return stream


def _upload(device, *arrays) -> list:
    """Host int arrays (None stays None) to ``device`` as int64 in one copy,
    so the host waits on the copy once, not once a vector."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(a, np.int64) for a in arrays if a is not None])).to(device)
    out, at = [], 0
    for a in arrays:
        out.append(None if a is None else flat[at:at + len(a)])
        at += 0 if a is None else len(a)
    return out


def _on(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _join(index, prep, tensors) -> None:
    """Under the mutation lock, before a scatter: order this thread's
    stream after the index's last one (``engine.order_stream``) and after
    the chunk's preparation, and mark the chunk's tensors as used there,
    so their memory is not reused before the scatter has read them."""
    from mpi_knn_tpu_torch.serve.engine import order_stream

    stream = order_stream(index)
    if stream is not None:
        stream.wait_stream(prep)
        for t in tensors:
            if t is not None:
                t.record_stream(stream)


def _pad_rows(rows: torch.Tensor, bucket: int) -> torch.Tensor:
    n = rows.shape[0]
    if n == bucket:
        return rows
    return torch.cat([rows, rows.new_zeros((bucket - n, rows.shape[1]))])


def _swap_store(index, buckets, bucket_ids, bucket_sqs, bucket_scales):
    index.buckets = buckets
    index.bucket_ids = bucket_ids
    index.bucket_sqs = bucket_sqs
    if bucket_scales is not None:
        index.bucket_scales = bucket_scales


def mutation_stats(index) -> dict:
    """The freelist's occupancy (live, tombstones, fill)."""
    _require_mutable(index)
    return freelist_of(index).stats()


def upsert_rows(index, ids, rows, config: KNNConfig | None = None) -> dict:
    """Upsert ``rows`` under global ``ids`` into a resident index, in place:
    the chunk centered and padded to the mutation bucket, its partitions
    scored on the device (clustered layout), its slots from the freelist,
    one scatter into the resident tensors. Ids already live are updated
    (the old slot cleared when the row moves partition). Returns a stats
    dict; raises :class:`BucketOverflowError` when headroom is exhausted
    (freelist and store untouched: compact and retry)."""
    from mpi_knn_tpu_torch.serve.engine import bucket_rows, mutation_lock

    _require_mutable(index)
    ids = np.asarray(ids, dtype=np.int32).reshape(-1)
    if (ids < 0).any():
        raise ValueError("upsert ids must be >= 0 (id -1 is the padding/"
                         "tombstone sentinel)")
    if not isinstance(rows, torch.Tensor):
        rows = np.asarray(rows)
    _check_rows(index, rows)
    if rows.shape[0] != ids.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids but {rows.shape[0]} rows")
    ids, rows = _dedupe_last(ids, rows)
    n = int(ids.shape[0])
    cfg = config or index.cfg
    bucket = bucket_rows(n, cfg.mutation_bucket)
    t0 = time.perf_counter()
    dev = index.device
    prep = _prep_stream(index)
    if prep is not None and isinstance(rows, torch.Tensor) and rows.is_cuda:
        # rows on the card: read them after this thread's stream wrote them
        prep.wait_stream(torch.cuda.current_stream(index.device))
    clustered = index.backend != "serial"
    with _span("upsert", rows=n, bucket=bucket, backend=index.backend):
        with _on(prep):
            rows_p = _pad_rows(_center_rows(index, rows), bucket)
        with mutation_lock(index):
            fl = freelist_of(index)
            with _on(prep):
                if clustered:
                    parts = ivf_assign_chunk(rows_p, index.centroids,
                                             index.centroid_sqs)[:n].cpu().numpy()
                else:
                    # no clustering: ids already live keep their own tile
                    # (updated in place, no slot consumed), new ids fill
                    # the lowest tile with headroom first
                    parts = _serial_pick_tiles(fl, ids)
                part, slot, clear_p, clear_s, commit = plan_upsert(fl, ids, parts)
                new_ids, *idx = _upload(dev, ids, *_kept(part, slot, fl.total),
                                        *(_kept(clear_p, clear_s, fl.total)
                                          or (None, None)))
                chunk = (rows_p, new_ids.to(torch.int32), *idx)
            _join(index, prep, chunk)
            if clustered:
                ivf_upsert_chunk(*chunk, *_store(index), index.cfg)
            else:
                serial_upsert_chunk(*chunk, *_store(index), index.cfg)
            commit()
            stats = fl.stats()
        _stamp_gauges(index)
    _observe("mutation_upserts_total", n)
    _observe("mutation_chunk_rows", n)
    _observe("mutation_latency_seconds", time.perf_counter() - t0)
    return {"upserted": n, "bucket": bucket, **stats}


def _serial_pick_tiles(fl, ids: np.ndarray) -> np.ndarray:
    """Tile choice of dense upserts: an id already live keeps its own tile
    (``plan_upsert`` then updates the slot in place, consuming nothing:
    a zero-headroom index absorbs pure updates); new ids fill the lowest
    tile with headroom first. Raises the shared overflow error when the
    new rows outnumber the free slots: the serial layout has no compactor,
    so rebuild with more ``bucket_headroom``."""
    parts = np.empty(len(ids), np.int32)
    new_rows = []
    for i, rid in enumerate(ids):
        old = fl.pos.get(int(rid))
        if old is not None:
            parts[i] = old[0]
        else:
            new_rows.append(i)
    j = 0
    for p, f in enumerate(fl.free):
        take = min(len(f), len(new_rows) - j)
        for i in new_rows[j:j + take]:
            parts[i] = p
        j += take
        if j == len(new_rows):
            break
    if j < len(new_rows):
        raise BucketOverflowError(
            f"serial tile stack is full ({fl.live} live rows, "
            f"{len(new_rows) - j} new rows do not fit): rebuild the "
            "index with a larger bucket_headroom (the dense layout has "
            "no re-cluster pass)",
        )
    return parts


def delete_rows(index, ids, config: KNNConfig | None = None) -> dict:
    """Tombstone ``ids``: one in-place scatter sets their slots' ids to −1
    (``mask_tile`` never returns them again) and the freelist takes the
    slots back. Unknown ids are counted and skipped. Returns a stats
    dict."""
    from mpi_knn_tpu_torch.serve.engine import bucket_rows, mutation_lock

    _require_mutable(index)
    ids = np.asarray(ids, dtype=np.int32).reshape(-1)
    ids, _ = _dedupe_last(ids, None)
    n = int(ids.shape[0])
    cfg = config or index.cfg
    bucket = bucket_rows(max(1, n), cfg.mutation_bucket)
    t0 = time.perf_counter()
    prep = _prep_stream(index)
    with _span("delete", rows=n, bucket=bucket, backend=index.backend):
        with mutation_lock(index):
            fl = freelist_of(index)
            part, slot, commit, missing = plan_delete(fl, ids)
            target = _kept(part, slot, fl.total)
            if target is not None:
                with _on(prep):
                    target = _upload(index.device, *target)
                # the id plane: bucket_ids, or the serial layout's tile_ids
                # at (tile, slot)
                _join(index, prep, target)
                ivf_delete_chunk(*target, _store(index)[1])
            commit()
            stats = fl.stats()
        _stamp_gauges(index)
    deleted = n - missing
    _observe("mutation_deletes_total", deleted)
    _observe("mutation_chunk_rows", n)
    _observe("mutation_latency_seconds", time.perf_counter() - t0)
    return {"deleted": deleted, "missing": missing, "bucket": bucket, **stats}


def warm_mutation(index, cfg: KNNConfig | None = None, sizes=(None,)) -> dict:
    """Do, before traffic, what the first live upsert, delete, assignment
    and compaction would otherwise do lazily (the reference pre-builds its
    mutation cells here), so none of it lands on a request holding the
    mutation lock: derive the freelist, make the card's preparation
    stream, and run each operation once at each chunk size (None = one
    ``mutation_bucket``) on scratch copies of one tile or bucket, so the
    store is never written. Returns ``{"cells": n, "built": b}``:
    ``cells`` counts the (size, operation) passes as the reference counts
    its cells; ``built`` the lazy state this call created (0 on a second
    call)."""
    from mpi_knn_tpu_torch.serve.engine import bucket_rows, mutation_lock, order_stream

    _require_mutable(index)
    cfg = cfg or index.cfg
    clustered = index.backend != "serial"
    built = int(index.__dict__.get("_freelist") is None)
    built += int(index.device.type == "cuda"
                 and index.__dict__.get("_prep_stream") is None)
    freelist_of(index)
    _prep_stream(index)
    cells = 0
    dev = index.device
    with mutation_lock(index):
        order_stream(index)
        scratch = [None if t is None else t[:1].clone() for t in _store(index)]
        for n in sizes:
            bucket = bucket_rows(n if n is not None else cfg.mutation_bucket,
                                 cfg.mutation_bucket)
            rows_p = _pad_rows(_center_rows(
                index, np.zeros((1, index.dim), np.float32)), bucket)
            zero, one = _upload(dev, [0], [-1])
            new_id = one.to(torch.int32)
            if clustered:
                ivf_assign_chunk(rows_p, index.centroids, index.centroid_sqs)
                ivf_upsert_chunk(rows_p, new_id, zero, zero, zero, zero,
                                 *scratch, index.cfg)
                cells += 3
            else:
                serial_upsert_chunk(rows_p, new_id, zero, zero, zero, zero,
                                    *scratch, index.cfg)
                cells += 2
            ivf_delete_chunk(zero, zero, scratch[1])
        if clustered:
            # the compaction's assignment pass and its scatter, one bucket
            from mpi_knn_tpu_torch.ivf.mutate import ivf_compact_assign

            ivf_compact_assign(scratch[0], scratch[3], index.centroids,
                               index.centroid_sqs, index.cfg)
            keep = np.zeros(1, np.int64)
            ivf_compact_scatter(keep, keep, *scratch,
                                *[None if t is None else t.clone() for t in scratch])
            cells += 2
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"cells": cells, "built": built}


# ---------------------------------------------------------------------------
# Compaction


def compact_index(index, config: KNNConfig | None = None, retrain: bool = True,
                  reason: str = "manual", min_cap: int | None = None) -> dict:
    """Re-cluster and compact a clustered index: k-means retrained on a
    deterministic live-row sample (off the mutation lock: training blocks
    no batch), every slot assigned again on the device, the live rows moved
    by one scatter into a fresh store, swapped in under the lock between
    batches. ``bucket_cap`` is kept whenever the live set fits; a cap that
    changes clears the index's engine entries (their query tiles depend on
    the cap). Returns the compaction stats."""
    from mpi_knn_tpu_torch.serve.engine import mutation_lock, order_stream

    _require_mutable(index)
    if index.backend == "serial":
        raise ValueError(
            "the serial tile stack has no re-cluster pass (tombstoned "
            "slots are reclaimed in place by upserts); rebuild the index "
            "to re-derive headroom"
        )
    cfg = config or index.cfg
    t0 = time.perf_counter()
    with _span("compact", backend=index.backend, reason=reason, retrain=retrain):
        maybe_beat("compact-plan")
        # the sample gather holds the lock (one small device gather); the
        # retrain runs on its host copy with batches flowing. Mutations
        # between sample and scatter are fine: the assignment below reads
        # the store again under the lock
        if retrain:
            with mutation_lock(index):
                order_stream(index)
                sample = gather_live_sample(index)
            centroids, centroid_sqs = retrain_centroids(index, cfg, sample)
        else:
            centroids, centroid_sqs = index.centroids, index.centroid_sqs
        with mutation_lock(index):
            stream = order_stream(index)
            dst_part, dst_slot, new_cap, stats = plan_compact(
                index, cfg, centroids, centroid_sqs, min_cap=min_cap)
            stats["retrained"] = bool(retrain)
            maybe_beat("compact-scatter")
            dst = make_dst_store(index, new_cap)
            old = _store(index)
            ivf_compact_scatter(dst_part, dst_slot, *old, *dst)
            if stream is not None:
                # batches enqueued before this point read the old store:
                # its memory waits for the chain's stream before reuse
                for t in old:
                    if t is not None:
                        t.record_stream(stream)
            _swap_store(index, *dst)
            index.centroids = centroids
            index.centroid_sqs = centroid_sqs
            cap_changed = new_cap != index.bucket_cap
            index.bucket_cap = new_cap
            if cap_changed:
                index._cache.clear()
                index.__dict__.pop("_cache_key_locks", None)
            index.__dict__.pop("_freelist", None)  # derived again from the store
            maybe_beat("compact-swap")
        _stamp_gauges(index)
    wall = time.perf_counter() - t0
    _observe("compactions_total")
    _observe("compact_wall_seconds", wall)
    return {**stats, "reason": reason, "wall_s": round(wall, 4)}


class Compactor:
    """The background re-cluster/compact worker: a daemon thread polling
    the freelist's triggers every ``interval_s`` and compacting the
    session's index when one fires, heartbeat- and flight-recorded, and
    shed first under overload (a session off its full rung defers it).
    ``stop()`` joins the thread."""

    def __init__(self, session, interval_s: float = 0.25, retrain: bool = True):
        _require_mutable(session.index)
        if session.index.backend == "serial":
            raise ValueError(
                "the serial layout has no compaction pass — the "
                "compactor supervises clustered indices only"
            )
        self.session = session
        self.interval_s = interval_s
        self.retrain = retrain
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._history: list[dict] = []  # compaction stats, in order
        self._deferred = 0
        self._thread = threading.Thread(target=self._run, name="tknn-compact",
                                        daemon=True)

    def start(self) -> "Compactor":
        self._thread.start()
        return self

    def stop(self, timeout: float = 60.0) -> None:
        self._stop_evt.set()
        self._thread.join(timeout)

    def snapshot(self) -> dict:
        """{compactions, deferred, last}: a consistent copy for other
        threads."""
        with self._lock:
            return {
                "compactions": len(self._history),
                "deferred": self._deferred,
                "last": self._history[-1] if self._history else None,
            }

    def tick(self, force_reason: str | None = None) -> dict | None:
        """One trigger check and at most one compaction: the loop body,
        exposed so tests drive it deterministically. Returns the
        compaction's stats when one ran, else None."""
        ses = self.session
        reason = force_reason or should_compact(ses.index, ses.cfg)
        if reason is None:
            return None
        if _shedding(ses):
            with self._lock:
                self._deferred += 1
            _observe("compact_deferred_total")
            obs_spans.event("compact-deferred", cat="mutate", reason=reason,
                            rung=ses.rung)
            return None
        stats = compact_index(ses.index, ses.cfg, retrain=self.retrain,
                              reason=reason)
        with self._lock:
            self._history.append(stats)
        return stats

    def _run(self) -> None:
        maybe_beat("compactor-start")
        while not self._stop_evt.wait(self.interval_s):
            maybe_beat("compactor-tick")
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — log, keep supervising
                # a failed pass leaves the store untouched
                log.exception("compaction failed")
                obs_spans.event("compact-error", cat="mutate",
                                error=f"{type(e).__name__}: {e}")
                _observe("compact_errors_total")
