"""Streamed query serving over a :class:`~mpi_knn_tpu_torch.serve.index.
CorpusIndex`: row buckets, per-(bucket, config) state built once, and
bounded dispatch-ahead (the JAX package's ``serve/engine.py``; over a
sharded store that spans processes, one session a process, see
:class:`ServeSession`).

Buckets: every batch is padded up to the smallest ``query_bucket · 2^j``
rows. PyTorch compiles nothing, so where the JAX engine compiles each
(bucket, config) once, this one builds each entry's state once: the padded
row count and query tile, the query ids and the pool of host staging
slots. ``MISSES`` counts the entries built; a warm stream adds none for any batch size. Padded rows are
zero with query id −1, and each row's result is independent of the others,
so a ragged batch equals its unpadded self bit for bit.

Dispatch, on a card, enqueues one batch on the current stream: center (f64
on the host, as ``all_knn``) → pad into the slot's pinned buffer →
non-blocking host→device copy → the query prologue → the kernel → the
merge → non-blocking device→host copy into the slot's pinned outputs → a
CUDA event. Retire waits on that event; latency is dispatch → retire. A
batch's ``device_ms`` is the span between an event recorded after the host
work, just before the host→device copy, and that end event: the card's
time for the batch when the card is the bottleneck, plus launch gaps when
the host is. At
``dispatch_depth`` ≥ 2 the host work of batch t+1 runs while the card
works on batch t. A slot, inputs and outputs, is reused only after its
batch retires.

Over a ring index a batch is padded to the bucket's ``ring_query_shapes``
and cut into one query shard per rank; ``backends/ring.ring_serve`` runs
its full rotation against the index's resident shards. Each real row is
placed on the rank ``all_knn`` gives it for a batch of that many rows
(``ring_layout``): a rank merges the blocks in its own order, which breaks
exact distance ties, so a row's result then does not depend on its
bucket. The entry holds,
built once, each rank's query ids and initial carry (read, never written)
and, for the dma and grid forms, the landing slots the rounds after the
first write into: the index's shards are only ever read. The dma and grid
forms read the card's error word after each launch, which waits for the
launch: their batches do not overlap the next one's host work.

Over a clustered index (``ivf.IVFIndex``, route ``"ivf"``) a batch is
padded to the bucket's ``ivf_query_shapes`` and run by
``ivf.search.ivf_serve_chunk``, the one-shot ``search_ivf``'s own tile
loop; queries stay f32 whatever the store's dtype. Over a sharded one
(``ivf.ShardedIVFIndex``, route ``"ivf-sharded"``) a batch is padded to
``ivf.sharded.sharded_query_shapes`` and run by ``run_sharded_tiles``; the
entry holds the resolved static route cap and the exchange's bytes, the
slot a host copy of the batch's per-shard [routed, dropped, served], and
the session counts them into the registry (``serve_exchange_*``), its
``exchange`` totals and an ``exchange`` event per batch.

``ServeSession.profile`` serves batches under ``torch.profiler`` and
attributes the window's device time (``obs/attribution.py``).

The serial and clustered layouts take live mutation between batches
(``ServeSession.upsert`` / ``delete`` / ``compact`` / ``start_compactor``,
``serve/mutate.py``). A batch reads the resident tensors and is enqueued
under the index's ``mutation_lock``, as every mutation is, and
``order_stream`` chains the streams that take the lock, so a batch in
flight reads the store it was dispatched on.

Operations (the JAX package's ``serve/engine.py:1050-1855``): a session
under a ``resilience.ResiliencePolicy`` walks the degradation ladder, retries
transient faults and trips the NaN sentinel (``ServeSession``); every entry
build is a ``compile`` span and an "entry" compile in the metrics registry
(``obs/metrics.record_compile``), every batch a ``batch`` span; ``warm``
builds every rung's entries, on a thread pool, each entry once under a lock
of its own, and a card entry records an event every dispatch's stream
waits for.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import threading
import time

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.obs import metrics as obs_metrics
from mpi_knn_tpu_torch.obs import spans as obs_spans
from mpi_knn_tpu_torch.ops import launch_counts
from mpi_knn_tpu_torch.ops.distance import center_rows
from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple
from mpi_knn_tpu_torch.resilience.faults import fault_point, poison_topk
from mpi_knn_tpu_torch.resilience.heartbeat import maybe_beat
from mpi_knn_tpu_torch.resilience.ladder import (
    FULL_RUNG,
    PoisonedResultError,
    ResiliencePolicy,
    build_ladder,
)
from mpi_knn_tpu_torch.resilience.retry import retry_with_backoff
from mpi_knn_tpu_torch.serve.index import CorpusIndex, canonical_device
from mpi_knn_tpu_torch.types import KNNResult

# (bucket, config) entries built, across indices (reset_misses sets it to 0)
MISSES = 0


def reset_misses():
    global MISSES
    MISSES = 0


def bucket_rows(n: int, base: int) -> int:
    """Smallest ``base · 2^j`` (j ≥ 0) that holds ``n`` rows."""
    if n < 1:
        raise ValueError(f"batch must have >= 1 row, got {n}")
    b = base
    while b < n:
        b *= 2
    return b


def _acc_dtype(cfg: KNNConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _query_dtype(cfg: KNNConfig, backend: str) -> torch.dtype:
    from mpi_knn_tpu_torch.backends.serial import torch_dtype

    return (torch.float32 if backend in ("ivf", "ivf-sharded")
            else torch_dtype(cfg.dtype))


@dataclasses.dataclass
class _Slot:
    """One batch's host staging: the padded queries and the padded
    results (pinned on a card), and the batch's start and end events."""

    host_in: torch.Tensor
    out_d: torch.Tensor
    out_i: torch.Tensor
    start: torch.cuda.Event | None
    done: torch.cuda.Event | None
    out_s: torch.Tensor | None = None  # ivf-sharded: (S, N_STATS) stats


@dataclasses.dataclass
class _BucketExec:
    """The state of one (bucket, config) entry, built once."""

    bucket: int
    q_pad: int
    q_tile: int
    cfg: KNNConfig
    backend: str
    device: torch.device
    dim: int
    qids: torch.Tensor | None  # serial, ivf: (q_pad,) all −1 on the device
    free: list = dataclasses.field(default_factory=list)  # idle slots
    slots: int = 0  # slots made
    # ring: per rank its query ids (all −1) and initial carry, and the
    # transport's landing slots (dma and grid forms), built once; the row
    # layout of each batch size met
    ring_qids: list | None = None
    ring_carries: list | None = None
    ring_slots: list | None = None
    ring_perms: dict = dataclasses.field(default_factory=dict)  # rows -> layout
    # on a card: recorded on the building thread's stream after the entry's
    # device tensors are written; a dispatch's stream waits for it (an
    # entry warmed on a pool thread is read from the dispatching one)
    ready: torch.cuda.Event | None = None
    device_bytes: int = 0  # its tensors and in-flight batches (peak figure)
    # ivf-sharded: the shard count, the resolved static route cap and the
    # exchange's bytes a batch (shape arithmetic, no device read)
    shards: int = 0
    route_cap: int | None = None
    exchange_bytes: int | None = None

    def _new_slot(self) -> _Slot:
        card = self.device.type == "cuda"
        shape = (self.q_pad, self.cfg.k)
        events = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if card
                  else (None, None))
        self.slots += 1
        stats = (torch.empty((self.shards, 3), dtype=torch.int64,
                             pin_memory=card) if self.shards else None)
        return _Slot(
            torch.empty((self.q_pad, self.dim),
                        dtype=_query_dtype(self.cfg, self.backend),
                        pin_memory=card),
            torch.empty(shape, dtype=_acc_dtype(self.cfg), pin_memory=card),
            torch.empty(shape, dtype=torch.int32, pin_memory=card),
            *events, stats)

    def reserve(self, n: int):
        """Make slots until ``n`` exist, so n batches of this entry can be
        in flight without a new pinned allocation."""
        while self.slots < n:
            self.free.append(self._new_slot())

    def acquire(self) -> _Slot:
        return self.free.pop() if self.free else self._new_slot()

    def release(self, slot: _Slot):
        self.free.append(slot)


def ring_query_shapes(index: CorpusIndex, cfg: KNNConfig, bucket: int):
    """Per-bucket query tiling against the index's fixed corpus layout (the
    JAX package's): ``ring_tiles`` would derive c_tile again from the
    bucket's q_tile, but the resident corpus was padded once at build, so
    only the query side moves, and the tile cap is kept by halving q_tile
    against the frozen c_tile. Returns (q_tile, q_pad)."""
    _, _, dp, ring_n = index.ring_meta
    num_dev = dp * ring_n
    q_tile = min(cfg.query_tile, -(-bucket // num_dev))
    while q_tile > 1 and q_tile * index.c_tile > cfg.max_tile_elems:
        q_tile = max(1, q_tile // 2)
    return q_tile, pad_to_multiple(bucket, num_dev * q_tile)


def ring_layout(index: CorpusIndex, cfg: KNNConfig, rows: int, q_pad: int,
                device) -> torch.Tensor:
    """Where each of a batch's ``rows`` real rows lies in the bucket's
    (q_pad,) ring layout, then the free places: the permutation ``perm`` with
    layout[perm[i]] = batch row i. Row i sits on the rank ``all_knn`` gives
    it for ``rows`` queries (``backends/ring.ring_tiles``' query shards),
    at the same offset in the rank's shard."""
    from mpi_knn_tpu_torch.backends.ring import ring_tiles

    P = index.ring_meta[3]
    _, _, q_pad_rows, _ = ring_tiles(cfg, index.m, rows, 1, P)
    per_batch, per_bucket = q_pad_rows // P, q_pad // P
    if per_batch > per_bucket:  # a bucket's tile cap cut its shards finer
        perm = np.arange(q_pad)
    else:  # on the host: a device-side nonzero would wait for the card
        i = np.arange(rows)
        pos = (i // per_batch) * per_bucket + i % per_batch
        free = np.ones(q_pad, dtype=bool)
        free[pos] = False
        perm = np.concatenate([pos, np.flatnonzero(free)])
    return torch.from_numpy(perm).to(device, non_blocking=True)


def bucket_shapes(index: CorpusIndex, cfg: KNNConfig, bucket: int):
    """``(q_pad, q_tile)`` of one (bucket, config) entry."""
    if index.backend == "ivf-sharded":
        from mpi_knn_tpu_torch.ivf.sharded import sharded_query_shapes

        q_tile, q_pad, _ = sharded_query_shapes(
            cfg, cfg.nprobe, index.bucket_cap, index.dim, bucket, index.shards)
        return q_pad, q_tile
    if index.backend == "ivf":
        from mpi_knn_tpu_torch.ivf.search import ivf_query_shapes

        q_tile, q_pad = ivf_query_shapes(cfg, cfg.nprobe, index.bucket_cap,
                                         index.dim, bucket)
        return q_pad, q_tile
    if index.shards is not None:
        q_tile, q_pad = ring_query_shapes(index, cfg, bucket)
        return q_pad, q_tile
    if index.backend == "serial":
        q_tile = min(cfg.query_tile, pad_to_multiple(bucket, 8))
    else:
        from mpi_knn_tpu_torch.backends.fused_backend import fused_query_tile

        q_tile = fused_query_tile(cfg, bucket)
    return pad_to_multiple(bucket, q_tile), q_tile


def _fingerprint_cfg(cfg: KNNConfig) -> KNNConfig:
    """The entry key's config: the full config minus the host-only knobs
    that never reach a batch's computation (dispatch_depth paces the
    session; query_bucket only picks the bucket, a key of its own; the
    mutation and compaction knobs pace the write path)."""
    return cfg.replace(
        dispatch_depth=1, query_bucket=1, mutation_bucket=1,
        bucket_headroom=0.0, compact_fill_threshold=1.0,
        compact_tombstone_fraction=1.0,
    )


_LOCK_MUTEX = threading.Lock()


def mutation_lock(index) -> threading.RLock:
    """The per-index mutation lock: every live mutation (the upsert and
    delete scatters, the compaction's swap, ``serve/mutate.py``), every
    derivation of the freelist and every batch dispatch (``_run``)
    serialize on it, so a batch runs against a consistent store, wholly
    before or wholly after a mutation. Held while the work is enqueued, not
    while the card runs it; re-entrant, so a mutation may derive the
    freelist under it. The lookup takes no lock once the lock exists; the
    mutex only guards its creation."""
    lk = index.__dict__.get("_mutation_lock")
    if lk is None:
        with _LOCK_MUTEX:
            lk = index.__dict__.setdefault("_mutation_lock", threading.RLock())
    return lk


def order_stream(index):
    """Under the mutation lock: make this thread's current stream wait for
    the last stream that enqueued work on the index's resident tensors,
    and record it as that stream. A card keeps a current stream per
    thread; with this, a batch dispatched on one stream and a mutation (or
    a ``Compactor`` thread) on another still run in the order they took
    the lock. Returns the stream (None off the card)."""
    if index.device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(index.device)
    last = index.__dict__.get("_stream")
    if last is not None and last != stream:
        stream.wait_stream(last)
    index.__dict__["_stream"] = stream
    return stream


def _key_lock(index, key) -> threading.Lock:
    """The lock of one (bucket, config) entry of ``index``: a parallel warm
    and a dispatch racing it build each entry once."""
    with _LOCK_MUTEX:
        locks = index.__dict__.setdefault("_cache_key_locks", {})
        return locks.setdefault(key, threading.Lock())


def get_executable(index: CorpusIndex, cfg: KNNConfig,
                   bucket: int) -> _BucketExec:
    """The (bucket, config) entry, built at most once per index. Configs
    that differ in any field that reaches the computation occupy distinct
    entries. Thread-safe per entry: callers of one entry wait for one
    build, distinct entries build in parallel."""
    key = (bucket, _fingerprint_cfg(cfg))
    exec_ = index._cache.get(key)
    if exec_ is not None:
        return exec_
    with _key_lock(index, key):
        exec_ = index._cache.get(key)
        if exec_ is None:
            exec_ = index._cache[key] = _build_entry(index, cfg, bucket)
    return exec_


def _build_entry(index: CorpusIndex, cfg: KNNConfig,
                 bucket: int) -> _BucketExec:
    """Build one entry inside a ``compile`` span (closed with the error if
    the build raises), and count it as the port's "entry" compile."""
    global MISSES
    t0 = time.perf_counter()
    sid = obs_spans.begin_span("compile", cat="compile", bucket=bucket,
                               backend=index.backend,
                               policy=cfg.precision_policy)
    try:
        exec_ = _new_entry(index, cfg, bucket)
    except Exception as e:
        obs_spans.end_span(sid, error=type(e).__name__)
        raise
    obs_spans.end_span(sid)
    with _LOCK_MUTEX:
        MISSES += 1
    obs_metrics.record_compile("entry", time.perf_counter() - t0)
    reg = obs_metrics.get_registry()
    reg.counter("serve_executables_compiled_total",
                help="(bucket, config) entries built by the serving engine").inc()
    if index.backend in ("ivf", "ivf-sharded"):
        reg.gauge("ivf_at_rest_bytes",
                  help="resident bytes of the clustered bucket store "
                  "(codes + scales for quantized stores)").set(index.nbytes_resident)
    elif index.shards is not None:
        from mpi_knn_tpu_torch.backends.ring import ring_wire_bytes_per_batch

        reg.gauge("ring_transfer_wire_bytes",
                  help="bytes one batch's full corpus rotation moves, at the "
                  "wire dtype").set(ring_wire_bytes_per_batch(
                      cfg, sum(t[0].shape[0] for t in index.shards), index.dim,
                      index.ring_meta[3]))
    # the entry joins the index's cache after this returns: count it here
    reg.gauge("serve_peak_hbm_bytes",
              help="device bytes of the index and its largest built entry "
              "(resident tensors, entry buffers, in-flight batches)",
              ).set(max(index_peak_hbm_bytes(index),
                        _resident_bytes(index) + exec_.device_bytes))
    return exec_


def _new_entry(index: CorpusIndex, cfg: KNNConfig,
               bucket: int) -> _BucketExec:
    q_pad, q_tile = bucket_shapes(index, cfg, bucket)
    qids = None
    if index.backend in ("serial", "ivf", "ivf-sharded"):
        qids = torch.full((q_pad,), -1, dtype=torch.int32, device=index.device)
    exec_ = _BucketExec(bucket, q_pad, q_tile, cfg, index.backend,
                        index.device, index.dim, qids)
    exchange = 0
    if index.backend == "ivf-sharded":
        from mpi_knn_tpu_torch.ivf.sharded import (
            exchange_bytes_per_tile,
            exchange_wire_args,
            resolve_route_cap,
        )

        exec_.shards = index.shards
        exec_.route_cap = resolve_route_cap(cfg, q_tile, cfg.nprobe)
        per_tile = exchange_bytes_per_tile(
            index.shards, exec_.route_cap, index.bucket_cap,
            *exchange_wire_args(index))
        exec_.exchange_bytes = (q_pad // q_tile) * per_tile
        # one tile step's exchange buffers: every owner's gathered
        # candidates and every home's received tile
        exchange = 2 * index.shards * per_tile
    elif index.backend != "ivf" and index.shards is not None:
        from mpi_knn_tpu_torch.backends.ring import ring_form
        from mpi_knn_tpu_torch.ops.fused_rotation import landing_slots
        from mpi_knn_tpu_torch.ops.topk import init_topk

        ql = q_pad // len(index.mesh)
        exec_.ring_qids = [torch.full((ql,), -1, dtype=torch.int32, device=d)
                           for d in index.mesh]
        exec_.ring_carries = [init_topk(ql, cfg.k, dtype=_acc_dtype(cfg), device=d)
                              for d in index.mesh]
        if ring_form(cfg, index.mesh) != "driver":
            exec_.ring_slots = [landing_slots(*t) for t in index.shards]
    # the entry's device bytes: its own tensors, and the padded queries and
    # results of the batches it may have in flight (summed once, here)
    row_bytes = (index.dim * _query_dtype(cfg, index.backend).itemsize
                 + cfg.k * (_acc_dtype(cfg).itemsize + 4))
    exec_.device_bytes = _tensor_bytes(
        qids, exec_.ring_qids, exec_.ring_carries, exec_.ring_slots,
    ) + max(1, cfg.dispatch_depth) * q_pad * row_bytes + exchange
    if index.device.type == "cuda":
        exec_.ready = torch.cuda.Event()
        exec_.ready.record(torch.cuda.current_stream(index.device))
    return exec_


def _tensor_bytes(*parts) -> int:
    """Bytes of the tensors in ``parts`` (lists, tuples and dicts' values
    are walked)."""
    total = 0
    for p in parts:
        if isinstance(p, torch.Tensor):
            total += p.numel() * p.element_size()
        elif isinstance(p, (list, tuple)):
            total += _tensor_bytes(*p)
        elif isinstance(p, dict):
            total += _tensor_bytes(*p.values())
    return total


def index_peak_hbm_bytes(index) -> int:
    """The serving peak-memory figure of one index (the JAX package's
    static peak over its executables): the bytes the index holds on its
    device (the resident store, norms, staged prologue outputs and rung
    copies) plus those of its largest built entry (the entry's tensors and
    its in-flight batches' padded queries and results; a kernel's
    transient workspace is not counted). 0 before the first entry. Sums
    ``nbytes`` only: no allocator state is read."""
    entries = list(index._cache.values())
    if not entries:
        return 0
    return _resident_bytes(index) + max(e.device_bytes for e in entries)


def _resident_bytes(index) -> int:
    """Bytes of the index's own tensors and staged prologue outputs."""
    staged = getattr(index, "staged", None)
    return _tensor_bytes(*vars(index).values()) + (
        staged.nbytes if staged is not None else 0)


def _prep_queries(index: CorpusIndex, cfg: KNNConfig, exec_: _BucketExec,
                  slot: _Slot, q) -> torch.Tensor:
    """Center and pad one batch to the entry's padded rows, by the
    arithmetic ``all_knn`` uses on the same residencies: a tensor on the
    index's device, or, for a host batch over a host-built index, the
    slot's (pinned) buffer, for the caller to copy over."""
    rows = q.shape[0]
    if rows > exec_.q_pad:
        raise ValueError(
            f"batch of {rows} rows exceeds the entry's bucket "
            f"({exec_.q_pad} padded rows)"
        )
    if q.ndim != 2 or q.shape[1] != index.dim:
        raise ValueError(
            f"queries of shape {tuple(q.shape)} do not match the index's "
            f"dimension {index.dim}"
        )
    mu = index.mu if cfg.center and cfg.metric == "l2" else None
    dev = index.device
    if isinstance(q, torch.Tensor) or isinstance(mu, torch.Tensor):
        # tensor arithmetic where the index lies: host queries over a
        # tensor-built index move first, as all_knn moves them
        q = (q.to(dev) if isinstance(q, torch.Tensor)
             else torch.as_tensor(np.asarray(q), device=dev))
        if mu is not None:
            q = center_rows(q, mu)
        return pad_rows_any(q, exec_.q_pad,
                            dtype=_query_dtype(cfg, index.backend),
                            device=dev)
    # a host batch over a host-built index: f64 centering on the host, then
    # the cast and padding in the slot's (pinned) buffer, one copy over
    q = np.asarray(q)
    if mu is not None:
        q = center_rows(q, mu)
    slot.host_in[:rows].copy_(torch.from_numpy(np.ascontiguousarray(q)))
    slot.host_in[rows:].zero_()
    return slot.host_in


def _run(index: CorpusIndex, cfg: KNNConfig, exec_: _BucketExec, q2d,
         rows: int | None = None):
    """One padded batch (``rows`` real rows first; default all) through the
    backend: padded (q_pad, k) results on the index's device, the real
    rows' first. Reading the resident tensors and enqueuing the batch is
    one step under the index's mutation lock. Returns (d, i, the
    (S, N_STATS) exchange stats of a sharded clustered batch, else
    None)."""
    with mutation_lock(index):
        order_stream(index)
        if index.backend == "ivf-sharded":
            from mpi_knn_tpu_torch.ivf.sharded import run_sharded_tiles

            qt = exec_.q_pad // exec_.q_tile
            d, i, stats = run_sharded_tiles(
                index, q2d.reshape(qt, exec_.q_tile, index.dim),
                exec_.qids.reshape(qt, exec_.q_tile), cfg, exec_.route_cap)
            return (d.reshape(exec_.q_pad, cfg.k),
                    i.reshape(exec_.q_pad, cfg.k), stats)
        return (*_run_locked(index, cfg, exec_, q2d, rows), None)


def _run_locked(index, cfg: KNNConfig, exec_: _BucketExec, q2d, rows):
    if index.backend == "serial":
        from mpi_knn_tpu_torch.backends.serial import serve_chunk
        from mpi_knn_tpu_torch.ops.topk import init_topk_tiles

        qt = exec_.q_pad // exec_.q_tile
        carry_d, carry_i = init_topk_tiles(qt, exec_.q_tile, cfg.k,
                                           dtype=_acc_dtype(cfg),
                                           device=index.device)
        d, i = serve_chunk(q2d.reshape(qt, exec_.q_tile, index.dim),
                           exec_.qids.reshape(qt, exec_.q_tile), carry_d,
                           carry_i, index.tiles, index.tile_ids,
                           index.tile_sqs, cfg)
        return d.reshape(exec_.q_pad, cfg.k), i.reshape(exec_.q_pad, cfg.k)
    if index.backend == "ivf":
        from mpi_knn_tpu_torch.ivf.search import ivf_serve_chunk, resident

        qt = exec_.q_pad // exec_.q_tile
        d, i = ivf_serve_chunk(q2d.reshape(qt, exec_.q_tile, index.dim),
                               exec_.qids.reshape(qt, exec_.q_tile),
                               *resident(index), cfg, cfg.nprobe)
        return d.reshape(exec_.q_pad, cfg.k), i.reshape(exec_.q_pad, cfg.k)
    if index.shards is not None:
        from mpi_knn_tpu_torch.backends.ring import ring_serve

        rows = exec_.q_pad if rows is None else rows
        perm = exec_.ring_perms.get(rows)
        if perm is None:
            perm = exec_.ring_perms[rows] = ring_layout(index, cfg, rows, exec_.q_pad,
                                                        q2d.device)
        layout = torch.empty_like(q2d)
        layout[perm] = q2d
        ql = exec_.q_pad // len(index.mesh)
        q_sh = [layout[r * ql:(r + 1) * ql] for r in range(len(index.mesh))]
        carries = ring_serve(q_sh, exec_.ring_qids, exec_.ring_carries,
                             index.shards, cfg, index.mesh,
                             index.backend == "ring-overlap", exec_.q_tile,
                             index.c_tile, slots=exec_.ring_slots)
        return (torch.cat([c[0] for c in carries])[perm],
                torch.cat([c[1] for c in carries])[perm])
    from mpi_knn_tpu_torch.backends.fused_backend import serve_batch_pallas

    return serve_batch_pallas(q2d, index.corpus_padded, index.staged, cfg,
                              exec_.q_tile, index.c_tile, index.m)


def _dispatch(index: CorpusIndex, cfg: KNNConfig, exec_: _BucketExec,
              slot: _Slot, q, poison: bool = False):
    """Enqueue one batch, its results copied into the slot's outputs and
    its end event recorded. With ``poison``, an armed ``serve-nan`` fault
    writes NaN into the device result before its copy to the host
    (``resilience/faults.poison_topk``). Returns the padded device results
    and the host's milliseconds centering and padding it."""
    t0 = time.perf_counter()
    q2d = _prep_queries(index, cfg, exec_, slot, q)
    prep_ms = 1e3 * (time.perf_counter() - t0)
    if exec_.ready is not None:
        torch.cuda.current_stream(index.device).wait_event(exec_.ready)
    if slot.start is not None:
        slot.start.record()
    d, i, stats = _run(index, cfg, exec_,
                       q2d.to(index.device, non_blocking=True), q.shape[0])
    if poison:
        d = poison_topk(d)
    slot.out_d.copy_(d, non_blocking=True)
    slot.out_i.copy_(i, non_blocking=True)
    if stats is not None:
        slot.out_s.copy_(stats, non_blocking=True)
    if slot.done is not None:
        slot.done.record()
    return d, i, prep_ms


def _fetch(slot: _Slot, rows: int):
    """Wait for a slot's batch; its real rows' results, copied out."""
    if slot.done is not None:
        slot.done.synchronize()
    return slot.out_d[:rows].numpy().copy(), slot.out_i[:rows].numpy().copy()


@dataclasses.dataclass
class BatchResult:
    """One served batch: the padded device results, and at retire the real
    rows' results on the host with the batch's timings."""

    dists_padded: torch.Tensor
    ids_padded: torch.Tensor
    rows: int
    bucket: int
    seq: int = 0  # 0-indexed session-order batch number
    # ((tenant, rows), ...) in row order: a coalesced multi-tenant batch
    tenants: tuple | None = None
    host_ms: float | None = None  # the host's time in submit's dispatch
    prep_ms: float | None = None  # of which centering and padding
    latency_s: float | None = None  # dispatch -> retire
    # events: from after the host work (before the host->device copy) to
    # the end of the device->host copy
    device_ms: float | None = None
    dists: np.ndarray | None = None  # (rows, k), set at retire
    ids: np.ndarray | None = None
    # the resilience record (a session without a policy leaves the
    # defaults): the ladder rung the batch was dispatched under (None: the
    # full rung), the dispatch attempts and the backoffs slept between
    # them, and whether its latency, backoffs excluded, broke the deadline
    degraded: str | None = None
    attempts: int = 1
    backoffs: tuple = ()
    deadline_breached: bool = False

    @property
    def retries(self) -> int:
        return self.attempts - 1

    # a sharded clustered batch: its (S, N_STATS) [routed, dropped, served]
    # per shard over the padded batch (padding rows route as real ones),
    # and the entry's static exchange bytes
    exchange: np.ndarray | None = None
    exchange_bytes: int | None = None


def _check_device(index: CorpusIndex, device):
    if canonical_device(device) != index.device:
        raise ValueError(
            f"device={str(device)!r} but the index lives on {index.device}"
        )


def query_knn(queries, index: CorpusIndex, config: KNNConfig | None = None,
              device=DEFAULT_DEVICE, **overrides) -> KNNResult:
    """One batch against a resident index (the serving counterpart of
    ``all_knn(corpus, queries=...)``): bucket, fetch or build the entry,
    dispatch, wait, and return (q, k) results on the host with the padding
    stripped. ``device`` must be the index's."""
    _check_device(index, device)
    cfg = index.compatible_cfg((config or index.cfg).replace(**overrides))
    exec_ = get_executable(index, cfg, bucket_rows(queries.shape[0],
                                                   cfg.query_bucket))
    slot = exec_.acquire()
    try:
        _dispatch(index, cfg, exec_, slot, queries)
        d, i = _fetch(slot, queries.shape[0])
        if slot.out_s is not None:
            count_exchange(slot.out_s.numpy(), exec_.exchange_bytes)
    finally:
        exec_.release(slot)
    return KNNResult(dists=torch.from_numpy(d), ids=torch.from_numpy(i))


def count_exchange(per_shard: np.ndarray, exchange_bytes: int | None,
                   registry=None) -> tuple[int, int]:
    """Stamp one sharded batch's candidate exchange into the metrics
    registry: routed probes (counter and histogram), the overflow drops of
    the route cap (a nonzero count is recall spent on routing skew) and
    the entry's static exchange bytes. Returns (routed, dropped)."""
    reg = registry or obs_metrics.get_registry()
    routed = int(per_shard[:, 0].sum())
    dropped = int(per_shard[:, 1].sum())
    reg.counter("serve_exchange_routed_total",
                help="probe routes exchanged between shards (padded batches)",
                ).inc(routed)
    reg.histogram("serve_exchange_routed_per_batch",
                  help="probe routes exchanged per sharded batch",
                  ).observe(routed)
    reg.counter("serve_exchange_overflow_dropped_total",
                help="probes dropped at the static per-shard route cap "
                "(counted recall loss, never wrong answers)").inc(dropped)
    if exchange_bytes:
        reg.counter("serve_exchange_bytes_total",
                    help="bytes moved by the candidate exchange (static per "
                    "entry)").inc(exchange_bytes)
    return routed, dropped


def _check_tenant(tenant):
    if tenant is not None and (
            not isinstance(tenant, str) or not tenant
            or any(c in tenant for c in ('"', "\\", "\n", "\r"))):
        raise ValueError(
            f"tenant id {tenant!r} must be a non-empty string with no "
            "quotes, backslashes, or newlines (it becomes a metrics label)"
        )


def _check_tenants(tenants, rows: int) -> tuple:
    """A batch's ``((tenant, rows), ...)`` composition, normalized; its ids
    must be usable as metrics labels and its rows must sum to the batch's,
    or the per-tenant accounting would mis-attribute."""
    tenants = tuple((str(t), int(n)) for t, n in tenants)
    for t, _ in tenants:
        _check_tenant(t)
    total = sum(n for _, n in tenants)
    if total != rows:
        raise ValueError(
            f"tenant composition sums to {total} rows but the batch has "
            f"{rows}: refusing to mis-attribute per-tenant stats"
        )
    return tenants


class ServeSession:
    """Bounded dispatch-ahead serving over one index.

    ``submit`` dispatches a batch and returns the batches it had to retire
    to keep at most ``dispatch_depth`` in flight; ``drain`` retires the
    rest; ``stream`` does both over an iterable, yielding in order. Depth
    1 retires every batch before ``submit`` returns.

    Sessions are reusable across streams: the index's entries stay built,
    and ``seq`` keeps counting. The window accumulators (``latencies``,
    ``queries_served``, ``retries_total``, ``deadline_breaches``,
    ``tenant_stats``, ``mutation_stats``) grow until ``reset_stats``; a
    batch in flight across a reset lands in the new window. One caller
    dispatches; ``stats_snapshot``, ``rung``, ``shed_rung`` /
    ``restore_rung``, ``bucket_ready`` and ``warm_snapshot`` may be read
    or called, and ``upsert`` / ``delete`` / ``compact`` called, from
    other threads.

    Every batch is a ``batch`` span in the flight record (``obs/spans.py``,
    with its ``seq`` and ``rung``), opened at dispatch and closed at retire
    with its latency, or with the error where it raised (a poisoned or
    exhausted batch included): only a killed process leaves it open. Every
    retire feeds the metrics registry (``serve_batches_total``,
    ``serve_queries_total``, ``serve_batch_latency_seconds``) and beats the
    heartbeat.

    With a :class:`~mpi_knn_tpu_torch.resilience.ladder.ResiliencePolicy`
    the session also enforces a per-batch deadline (measured at retire:
    the dispatch → retire latency, backoffs excluded), retries dispatches
    that fail with a transient fault with a fixed exponential backoff
    (a CUDA error is not retried: it propagates at once), trips a NaN /
    all-inf sentinel on every retired batch's host rows
    (:class:`PoisonedResultError` with the batch's seq, bucket and rung),
    and on ``degrade_after`` consecutive breaches sheds one rung down the
    degradation ladder (smaller ``nprobe`` → ``mixed`` → smaller bucket,
    ``resilience/ladder.py``). A pallas index on a card stages what each
    rung reads at construction (``staged_bytes``: the resident bytes that
    added). ``resilience=None`` (the default) keeps one rung and no
    deadline, retry or sentinel.

    Over a sharded clustered store that spans processes, every process
    constructs a session and calls ``submit`` / ``drain`` / ``upsert`` /
    ``delete`` / ``compact`` in the same order, from one thread, so every
    collective the session issues runs in that order on every process.
    Each batch starts with an agreement on its seq, rows and rung (a
    process at another point raises :class:`~mpi_knn_tpu_torch.parallel.
    distributed.PlanMismatchError` naming both, and never hangs), and what
    one process would decide from its own clock is decided once: a batch
    counts as over the deadline where any process saw it so (one gather
    at retire), so every process sheds at the same seq; an overflow's
    compaction follows the agreed upsert plan. A transient fault's retry
    is taken before the batch's first collective, so it delays the pod and
    reorders nothing. The background ``Compactor`` is refused there.
    """

    def __init__(self, index: CorpusIndex, config: KNNConfig | None = None,
                 resilience: ResiliencePolicy | None = None,
                 device=DEFAULT_DEVICE, **overrides):
        _check_device(index, device)
        self.index = index
        # a store that spans processes: every process's session makes the
        # same calls in the same order, and agrees on each batch; its
        # freelist (a gather of every process's id planes) is derived here,
        # a point every process reaches, so each later call's first
        # collective is an agreement
        self._spans = bool(getattr(index, "spans_processes", False))
        if self._spans:
            from mpi_knn_tpu_torch.ivf.mutate import freelist_of

            freelist_of(index)
        self.cfg = index.compatible_cfg(
            (config or index.cfg).replace(**overrides))
        self._metrics = obs_metrics.get_registry()
        self.policy = resilience
        if resilience is not None:
            self.ladder = build_ladder(index, self.cfg, resilience)
        else:
            self.ladder = [(FULL_RUNG, self.cfg)]
        # what the ladder's rungs read, staged before traffic (never at
        # shed time, which lands at the moment of overload)
        stage = getattr(index, "stage_for", None)
        self.staged_bytes = sum(stage(c) for _, c in self.ladder) if stage else 0
        self._rung = 0
        self._consecutive_breaches = 0
        self._seq = 0
        self._inflight: collections.deque = collections.deque()
        # warm progress, read from other threads
        self._warm_lock = threading.Lock()
        self.warm_state: dict = {"total": 0, "ready": 0, "done": True}
        self.warm_report: dict | None = None
        # the window accumulators and the rung, read from other threads
        self._stats_lock = threading.Lock()
        self.latencies: list[float] = []
        self.queries_served = 0
        self.retries_total = 0
        self.deadline_breaches = 0
        self.degradations: list[dict] = []  # rung-shed events, in order
        self.restorations: list[dict] = []  # rung-restore events, in order
        self.tenant_stats: dict[str, dict] = {}
        # rows upserted / tombstoned through this session and compaction
        # passes; the index's occupancy lives on its freelist
        self.mutation_stats: dict[str, int] = _zero_mutation_stats()
        # a sharded clustered session's candidate exchange (routed and
        # dropped probes, static bytes, each shard's load as owner), for
        # the report; None elsewhere
        self.exchange: dict | None = None
        if getattr(index, "backend", None) == "ivf-sharded":
            self.exchange = _zero_exchange(index.shards)

    # -- the ladder --------------------------------------------------------

    @property
    def rung(self) -> str:
        """The ladder rung new submissions dispatch under."""
        return self._current_rung()[0]

    def _current_rung(self) -> tuple:
        with self._stats_lock:
            return self.ladder[self._rung]

    def shed_rung(self, *, reason: str = "deadline-breach",
                  after_batch: int | None = None) -> str | None:
        """Walk one rung down the ladder: recorded in ``degradations``, a
        ``degrade`` flight event, ``serve_degradations_total`` and the
        ``serve_ladder_rung`` gauge. Returns the new rung's label, or None
        at the ladder's floor."""
        with self._stats_lock:
            if self._rung >= len(self.ladder) - 1:
                return None
            self._rung += 1
            self._consecutive_breaches = 0
            label = self.ladder[self._rung][0]
            rung_idx = self._rung
            ev = {
                "after_batch": (after_batch if after_batch is not None
                                else max(0, self._seq - 1)),
                "rung": label,
                "breaches": self.deadline_breaches,
                "reason": reason,
            }
            self.degradations.append(ev)
        obs_spans.event("degrade", cat="serve", **ev)
        self._metrics.counter(
            "serve_degradations_total",
            help="ladder rungs shed (deadline breach or queue overload)",
        ).inc()
        self._set_rung_gauge(rung_idx)
        return label

    def restore_rung(self, *, reason: str = "recovered") -> str | None:
        """Walk one rung back up (the deadline machinery never does: a
        breach streak has no symmetric all-clear). Every rung was built by
        ``warm``, so a restore builds nothing. Returns the restored rung's
        label, or None at the full rung."""
        with self._stats_lock:
            if self._rung == 0:
                return None
            self._rung -= 1
            self._consecutive_breaches = 0
            label = self.ladder[self._rung][0]
            rung_idx = self._rung
            self.restorations.append({"rung": label, "reason": reason})
        obs_spans.event("restore", cat="serve", rung=label, reason=reason)
        self._metrics.counter(
            "serve_restorations_total",
            help="ladder rungs restored after overload recovery",
        ).inc()
        self._set_rung_gauge(rung_idx)
        return label

    def _set_rung_gauge(self, rung_idx: int) -> None:
        self._metrics.gauge(
            "serve_ladder_rung",
            help="current degradation-ladder rung index (0 = full)",
        ).set(rung_idx)

    # -- warm ----------------------------------------------------------------

    def warm(self, sizes, parallel: int | None = None, progress=None) -> dict:
        """Build, before traffic, the entries of the given batch sizes'
        buckets at every ladder rung, each with ``dispatch_depth`` slots
        (the first batch after a shed lands at the moment of overload, and
        must build nothing). Cells that resolve to one entry (a
        ``bucket/2`` rung whose size pads to its parent's bucket) are
        built once; distinct cells build on a pool of ``parallel`` threads
        (default min(cells, CPUs); 1 builds in turn). Per-cell progress
        feeds ``warm_state`` and ``progress(ready, total, bucket)``.
        Returns ``{cells, raw_cells, deduped, built, reused, wall_s}``."""
        t0 = time.perf_counter()
        raw = [(bucket_rows(n, cfg.query_bucket), cfg)
               for n in sizes for _, cfg in self.ladder]
        distinct: dict = {}
        for bucket, cfg in raw:
            distinct.setdefault((bucket, _fingerprint_cfg(cfg)), (bucket, cfg))
        cells = list(distinct.values())
        total = len(cells)
        with self._warm_lock:
            self.warm_state = {"total": total, "ready": 0, "done": False}
        workers = (max(1, min(total, os.cpu_count() or 1)) if parallel is None
                   else max(1, parallel))

        def one(cell):
            bucket, cfg = cell
            existed = (bucket, _fingerprint_cfg(cfg)) in self.index._cache
            get_executable(self.index, cfg, bucket).reserve(cfg.dispatch_depth)
            with self._warm_lock:
                self.warm_state["ready"] += 1
                ready = self.warm_state["ready"]
            if progress is not None:
                progress(ready, total, bucket)
            return existed

        with obs_spans.span("warm", cat="serve", sizes=list(sizes),
                            rungs=len(self.ladder), cells=total,
                            deduped=len(raw) - total, workers=workers):
            if workers <= 1 or total <= 1:
                existed = [one(c) for c in cells]
            else:
                with concurrent.futures.ThreadPoolExecutor(
                        max_workers=workers,
                        thread_name_prefix="tknn-warm") as pool:
                    existed = list(pool.map(one, cells))
        with self._warm_lock:
            self.warm_state["done"] = True
        reused = sum(existed)
        report = {
            "cells": total, "raw_cells": len(raw), "deduped": len(raw) - total,
            "built": total - reused, "reused": reused,
            "wall_s": round(time.perf_counter() - t0, 4),
        }
        self.warm_report = report
        return report

    def warm_async(self, sizes, parallel: int | None = None,
                   progress=None) -> threading.Thread:
        """Run :meth:`warm` on a started daemon thread and return it;
        ``warm_snapshot`` and ``bucket_ready`` show its progress."""
        t = threading.Thread(target=self.warm, args=(sizes, parallel, progress),
                             name="tknn-warm-async", daemon=True)
        t.start()
        return t

    def warm_snapshot(self) -> dict:
        """A consistent copy of ``warm_state`` for other threads."""
        with self._warm_lock:
            return dict(self.warm_state)

    def bucket_ready(self, rows: int) -> bool:
        """Whether a batch of ``rows`` rows would dispatch on an entry
        already built, at the current rung."""
        _, cfg = self._current_rung()
        key = (bucket_rows(max(1, rows), cfg.query_bucket), _fingerprint_cfg(cfg))
        return key in self.index._cache

    def coalesced_ready(self, rows: int, max_rows: int) -> bool:
        """Whether every bucket a request of ``rows`` rows may land in,
        coalesced with others up to ``max_rows``, is built at the current
        rung (a serving front end's admission while warming)."""
        _, cfg = self._current_rung()
        fp = _fingerprint_cfg(cfg)
        b = bucket_rows(max(1, rows), cfg.query_bucket)
        top = bucket_rows(max(1, max(rows, max_rows)), cfg.query_bucket)
        while True:
            if (b, fp) not in self.index._cache:
                return False
            if b >= top:
                return True
            b *= 2

    # -- the window ----------------------------------------------------------

    def stats_snapshot(self) -> dict:
        """The window's counters and the rung, in one critical section."""
        with self._stats_lock:
            return {
                "batches_retired": len(self.latencies),
                "queries_served": self.queries_served,
                "retries_total": self.retries_total,
                "deadline_breaches": self.deadline_breaches,
                "rung": self.ladder[self._rung][0],
                "tenants": sorted(self.tenant_stats),
                "mutation": dict(self.mutation_stats),
                "bucket_entries": len(self.index._cache),
                "peak_hbm_bytes": index_peak_hbm_bytes(self.index),
            }

    def reset_stats(self):
        """Start a fresh window: resets ``latencies``, ``queries_served``,
        ``retries_total``, ``deadline_breaches``, ``tenant_stats`` and
        ``mutation_stats``; ``seq``, the built entries, the rung with its
        ``degradations`` / ``restorations`` and the index's occupancy (its
        freelist) stay."""
        with self._stats_lock:
            self.latencies = []
            self.queries_served = 0
            self.retries_total = 0
            self.deadline_breaches = 0
            self.tenant_stats = {}
            self.mutation_stats = _zero_mutation_stats()
            if self.exchange is not None:
                self.exchange = _zero_exchange(self.exchange["shards"])

    # -- serving -------------------------------------------------------------

    def _attempt(self, queries, cfg: KNNConfig):
        """One dispatch attempt under ``cfg`` (a rung's config); the fault
        site stands for a transient transport failure. A raised attempt
        gives its slot back, so a retry reuses it."""
        fault_point("serve-batch")
        exec_ = get_executable(self.index, cfg,
                               bucket_rows(int(queries.shape[0]), cfg.query_bucket))
        slot = exec_.acquire()
        try:
            d, i, prep_ms = _dispatch(self.index, cfg, exec_, slot, queries,
                                      poison=True)
        except BaseException:
            exec_.release(slot)
            raise
        return exec_, slot, d, i, prep_ms

    def submit(self, queries, tenants=None) -> list[BatchResult]:
        """Dispatch one batch; ``tenants`` is an optional ``((tenant,
        rows), ...)`` composition in row order (a coalesced multi-tenant
        batch from the serving front end). It must sum to the batch's rows
        and its ids must be usable as metrics labels, or it raises
        ``ValueError`` here, before any dispatch."""
        t0 = time.perf_counter()
        rows = int(queries.shape[0])
        comp = {}
        if tenants is not None:
            tenants = _check_tenants(tenants, rows)
            for t, n in tenants:
                comp[t] = comp.get(t, 0) + n
        label, cfg = self._current_rung()
        # the span opens before the attempt: a hang inside it leaves an
        # open batch span in the flight record, the kill's diagnosis; it
        # names whose rows were on board
        # a sharded session stamps the shard count: an open span beside
        # the last retired batch's exchange event names the shards in a hang
        sid = obs_spans.begin_span(
            "batch", cat="serve", seq=self._seq, rows=rows, rung=label,
            **({"shards": self.index.shards}
               if self.exchange is not None else {}),
            **({"tenants": comp} if tenants is not None else {}))
        pol = self.policy
        try:
            if self._spans:
                from mpi_knn_tpu_torch.parallel import distributed

                distributed.agree("serving batch",
                                  f"seq={self._seq} rows={rows} rung={label}")
            if pol is not None and pol.max_retries > 0:
                out = retry_with_backoff(
                    lambda: self._attempt(queries, cfg),
                    retries=pol.max_retries, base_s=pol.backoff_base_s,
                    max_s=pol.backoff_max_s, retryable=pol.retryable)
                (exec_, slot, d, i, prep_ms), attempts, backoffs = (
                    out.value, out.attempts, out.backoffs)
                if attempts > 1:
                    with self._stats_lock:
                        self.retries_total += attempts - 1
                    obs_spans.event("retry", cat="retry", seq=self._seq,
                                    retries=attempts - 1, backoffs=list(backoffs))
                    self._metrics.counter(
                        "serve_retries_total",
                        help="transient dispatch failures retried",
                    ).inc(attempts - 1)
            else:
                exec_, slot, d, i, prep_ms = self._attempt(queries, cfg)
                attempts, backoffs = 1, ()
        except Exception as e:
            # retries exhausted, a CUDA error, a refusal: the caller survives
            # it, so the span closes with the error
            obs_spans.end_span(sid, error=type(e).__name__)
            raise
        res = BatchResult(d, i, rows, exec_.bucket, seq=self._seq, tenants=tenants,
                          host_ms=1e3 * (time.perf_counter() - t0),
                          prep_ms=prep_ms,
                          degraded=None if label == FULL_RUNG else label,
                          attempts=attempts, backoffs=backoffs,
                          exchange_bytes=exec_.exchange_bytes)
        self._seq += 1
        self._inflight.append((res, t0, exec_, slot, sid))
        done = []
        while len(self._inflight) >= max(1, self.cfg.dispatch_depth):
            done.append(self._retire())
        return done

    def drain(self) -> list[BatchResult]:
        out = []
        while self._inflight:
            out.append(self._retire())
        return out

    def stream(self, batches, tenant: str | None = None):
        """Serve an iterable of batches (all of one ``tenant``, if given),
        yielding results in order; coalesced multi-tenant batches use
        ``submit(..., tenants=...)``."""
        for q in batches:
            yield from self.submit(
                q, tenants=None if tenant is None else ((tenant, int(q.shape[0])),))
        yield from self.drain()

    def profile(self, batches, trace_dir: str | None = None) -> dict:
        """Serve ``batches`` under ``torch.profiler`` and return the
        per-category device busy split of the window
        (``obs.attribution.attribute_trace``) with ``batches_profiled`` and
        ``trace_dir``.

        Steady state is made here, before the profiler opens: every entry
        the batches' buckets need is built and one batch of each size runs
        through it (outside the session's stats), so no nvcc build, entry
        build or first launch of a kernel lands in the trace. The window
        then submits the batches, drains them and synchronizes the card.
        The report adds what the window itself did: ``kernel_launches``
        (the port's launch counters' increments), ``compiles_in_window``
        (nvcc builds and entry builds: empty in steady state) and
        ``wall_ms``, the host time from the first submit to the card's
        last result (the profiler's own start and stop left out), against
        which ``busy_total_ms`` gives the device's idle share."""
        import tempfile

        from mpi_knn_tpu_torch.obs.attribution import attribute_trace
        from mpi_knn_tpu_torch.utils.timing import profile_trace

        batches = list(batches)
        _, cfg = self._current_rung()
        firsts = {}
        for q in batches:
            firsts.setdefault(int(q.shape[0]), q)
        for rows, q in sorted(firsts.items()):
            exec_ = get_executable(self.index, cfg,
                                   bucket_rows(rows, cfg.query_bucket))
            exec_.reserve(cfg.dispatch_depth)
            slot = exec_.acquire()
            try:
                _dispatch(self.index, cfg, exec_, slot, q)
                _fetch(slot, rows)
            finally:
                exec_.release(slot)
        tdir = trace_dir or tempfile.mkdtemp(prefix="tknn-profile-")
        dev = self.index.device
        before = launch_counts()
        with obs_spans.span("profile", cat="profile", trace_dir=tdir), \
                obs_metrics.watch_compiles() as built:
            with profile_trace(tdir, dev):
                t0 = time.perf_counter()
                for q in batches:
                    self.submit(q)
                self.drain()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall_ms = 1e3 * (time.perf_counter() - t0)
        after = launch_counts()
        out = attribute_trace(tdir)
        out["batches_profiled"] = len(batches)
        out["trace_dir"] = tdir
        out["kernel_launches"] = {n: after[n] - before.get(n, 0)
                                  for n in after if after[n] != before.get(n, 0)}
        out["compiles_in_window"] = list(built)
        out["wall_ms"] = round(wall_ms, 3)
        return out

    def _retire(self) -> BatchResult:
        res, t0, exec_, slot, sid = self._inflight.popleft()
        try:
            res.dists, res.ids = _fetch(slot, res.rows)
            if slot.out_s is not None:
                res.exchange = slot.out_s.numpy().copy()
            res.latency_s = time.perf_counter() - t0
            if slot.start is not None:
                res.device_ms = slot.start.elapsed_time(slot.done)
        except Exception as e:
            obs_spans.end_span(sid, error=type(e).__name__)
            raise
        finally:
            exec_.release(slot)
        with self._stats_lock:
            self.latencies.append(res.latency_s)
            self.queries_served += res.rows
        self._note_latency(res)
        if self.policy is not None and self.policy.nan_sentinel:
            try:
                self._check_sentinel(res)
            except PoisonedResultError:
                obs_spans.end_span(sid, latency_s=res.latency_s,
                                   retries=res.retries, error="poisoned-result")
                raise
        # the composition per tenant first: one tenant with several
        # coalesced requests in this batch is still one batch (and one
        # latency observation) for that tenant
        tenant_rows: dict[str, int] = {}
        for t, n in res.tenants or ():
            tenant_rows[t] = tenant_rows.get(t, 0) + n
        if tenant_rows:
            with self._stats_lock:
                for t, n in tenant_rows.items():
                    st = self.tenant_stats.setdefault(t, {
                        "queries": 0, "batches": 0,
                        "latency_sum_s": 0.0, "latency_max_s": 0.0,
                    })
                    st["queries"] += n
                    st["batches"] += 1
                    st["latency_sum_s"] += res.latency_s
                    st["latency_max_s"] = max(st["latency_max_s"], res.latency_s)
        for t, n in tenant_rows.items():
            self._metrics.counter(
                "serve_tenant_queries_total",
                help="query rows served per tenant (padding excluded)",
                labels={"tenant": t},
            ).inc(n)
            self._metrics.counter(
                "serve_tenant_batches_total",
                help="batches carrying at least one row of this tenant",
                labels={"tenant": t},
            ).inc()
        extra = {}
        if res.exchange is not None:
            routed, dropped = count_exchange(res.exchange, res.exchange_bytes,
                                             registry=self._metrics)
            with self._stats_lock:
                ex = self.exchange
                ex["routed_total"] += routed
                ex["dropped_total"] += dropped
                ex["exchange_bytes_total"] += res.exchange_bytes or 0
                for s_, n in enumerate(res.exchange[:, 2].tolist()):
                    ex["served_per_shard"][s_] += int(n)
                # routes are per query tile, and tiles mix tenants: a
                # tenant's share of the routed volume is by its rows
                for t, n in tenant_rows.items():
                    self.tenant_stats[t]["routed"] = (
                        self.tenant_stats[t].get("routed", 0.0)
                        + routed * n / res.rows)
            extra = {"routed": routed, "dropped": dropped}
            # the per-shard load: the record a flight reader pairs with an
            # open batch span to see which shard carried the requests
            obs_spans.event("exchange", cat="serve", seq=res.seq,
                            served_per_shard=res.exchange[:, 2].tolist(),
                            routed=routed, dropped=dropped)
        obs_spans.end_span(sid, latency_s=res.latency_s, retries=res.retries,
                           deadline_breached=res.deadline_breached, **extra)
        maybe_beat(f"serve-batch-{res.seq}")
        self._metrics.counter("serve_batches_total", help="batches retired").inc()
        self._metrics.counter(
            "serve_queries_total", help="query rows served (padding excluded)",
        ).inc(res.rows)
        self._metrics.histogram(
            "serve_batch_latency_seconds",
            help="per-batch dispatch -> retire latency",
        ).observe(res.latency_s)
        return res

    def _check_sentinel(self, res: BatchResult) -> None:
        """NaN / all-inf sentinel on a retired batch's real rows, read from
        the host copy ``_fetch`` already made (no extra synchronization).
        A NaN distance has one source, a poisoned tile; an all-inf row
        means every candidate was masked away. Neither is returned as an
        answer: the trip is loud, with the batch's provenance."""
        d = res.dists
        bad_nan = bool(np.isnan(d).any())
        bad_inf = bool(d.size) and bool(np.isinf(d).all(axis=1).any())
        if bad_inf and not bad_nan and res.exchange is not None \
                and res.exchange[:, 1].sum() > 0:
            # a sharded batch under route-cap overflow: a query whose every
            # probe was dropped retires all-inf, the counted loss the cap
            # documents, not a poisoned tile; NaN still trips
            bad_inf = False
        if not (bad_nan or bad_inf):
            return
        kind = "NaN" if bad_nan else "all-inf row"
        rung = res.degraded or FULL_RUNG
        obs_spans.event("poisoned-result", cat="serve", seq=res.seq,
                        kind=kind, bucket=res.bucket)
        self._metrics.counter(
            "serve_poisoned_results_total",
            help="batches whose top-k tripped the NaN/all-inf sentinel",
        ).inc()
        raise PoisonedResultError(
            f"poisoned top-k ({kind}) in served batch seq={res.seq} "
            f"bucket={res.bucket} rows={res.rows} rung={rung}",
            batch_seq=res.seq, bucket=res.bucket, rung=rung, rows=res.rows)

    def _note_latency(self, res: BatchResult) -> None:
        """Deadline accounting at retire: count consecutive breaches and
        shed one rung when the policy's patience runs out. Backoff sleeps
        are excluded from the comparison (``latency_s`` stays the whole
        dispatch → retire time): waiting on a transient fault is not load,
        and the ladder's smaller programs cannot fix it."""
        pol = self.policy
        if pol is None or pol.batch_deadline_s is None:
            return
        breached = res.latency_s - sum(res.backoffs) > pol.batch_deadline_s
        if self._spans:
            # decided once for the pod: a breach any process saw
            from mpi_knn_tpu_torch.parallel import distributed

            breached = any(distributed.all_gather_object(
                breached, f"deadline of serving batch seq={res.seq}"))
        if not breached:
            self._consecutive_breaches = 0
            return
        res.deadline_breached = True
        with self._stats_lock:
            self.deadline_breaches += 1
        self._consecutive_breaches += 1
        self._metrics.counter(
            "serve_deadline_breaches_total",
            help="batches whose dispatch -> retire latency overran the deadline",
        ).inc()
        if self._consecutive_breaches >= pol.degrade_after:
            self.shed_rung(reason="deadline-breach", after_batch=res.seq)

    # -- live mutation: thin wrappers over serve/mutate.py. The index
    # mutates under its mutation lock (serialized with dispatch); the
    # session's window takes the counts under _stats_lock.

    def upsert(self, ids, rows, tenant: str | None = None) -> dict:
        """Upsert rows into the live index, in place. Returns the mutation
        stats. A clustered index whose headroom overflows compacts once and
        retries, then grows its cap by the chunk (the background compactor
        normally fires on the fill threshold first); the serial layout has
        no re-cluster pass, so its overflow propagates."""
        from mpi_knn_tpu_torch.ivf.mutate import BucketOverflowError
        from mpi_knn_tpu_torch.serve import mutate as serve_mutate

        try:
            stats = serve_mutate.upsert_rows(self.index, ids, rows, self.cfg)
        except BucketOverflowError:
            if self.index.backend == "serial":
                raise
            self.compact(reason="overflow")
            try:
                stats = serve_mutate.upsert_rows(self.index, ids, rows, self.cfg)
            except BucketOverflowError:
                # a burst aimed at one cluster can outsize any balanced
                # cap: grow it so the chunk fits
                serve_mutate.compact_index(
                    self.index, self.cfg, reason="overflow-grow",
                    min_cap=self.index.bucket_cap + int(np.shape(rows)[0]))
                stats = serve_mutate.upsert_rows(self.index, ids, rows, self.cfg)
        self._note_mutation("upserts", stats.get("upserted", 0), tenant)
        return stats

    def delete(self, ids, tenant: str | None = None) -> dict:
        """Tombstone ids in the live index (never returned again; their
        slots go back to the freelist). Unknown ids are counted, not an
        error. Returns the mutation stats."""
        from mpi_knn_tpu_torch.serve import mutate as serve_mutate

        stats = serve_mutate.delete_rows(self.index, ids, self.cfg)
        self._note_mutation("deletes", stats.get("deleted", 0), tenant)
        return stats

    def compact(self, reason: str = "manual", retrain: bool = True) -> dict:
        """Re-cluster and compact the live index now (the ``Compactor``
        calls this on a trigger): the store rebuilt by one scatter into a
        fresh one and swapped between batches under the mutation lock."""
        from mpi_knn_tpu_torch.serve import mutate as serve_mutate

        stats = serve_mutate.compact_index(self.index, self.cfg,
                                           retrain=retrain, reason=reason)
        with self._stats_lock:
            self.mutation_stats["compactions"] += 1
        return stats

    def start_compactor(self, interval_s: float = 0.25, retrain: bool = True):
        """Start (and return) the background compaction worker of this
        session, driven by the freelist's triggers and deferred while the
        session is off its full rung."""
        from mpi_knn_tpu_torch.serve.mutate import Compactor

        return Compactor(self, interval_s=interval_s, retrain=retrain).start()

    def _note_mutation(self, kind: str, n: int, tenant: str | None) -> None:
        """Count a mutation in the window, and per ``tenant`` in the
        registry (``serve_tenant_upserts_total`` /
        ``serve_tenant_deletes_total``)."""
        with self._stats_lock:
            self.mutation_stats[kind] += n
            self.mutation_stats["calls"] += 1
        if tenant is not None:
            self._metrics.counter(
                f"serve_tenant_{kind}_total",
                help=f"rows {kind[:-1]}ed per tenant",
                labels={"tenant": str(tenant)},
            ).inc(n)


def _zero_mutation_stats() -> dict:
    return {"upserts": 0, "deletes": 0, "calls": 0, "compactions": 0}


def _zero_exchange(shards: int) -> dict:
    return {"shards": shards, "routed_total": 0, "dropped_total": 0,
            "exchange_bytes_total": 0, "served_per_shard": [0] * shards}
