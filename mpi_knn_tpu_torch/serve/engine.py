"""Streamed query serving over a :class:`~mpi_knn_tpu_torch.serve.index.
CorpusIndex`: row buckets, per-(bucket, config) state built once, and
bounded dispatch-ahead (the JAX package's ``serve/engine.py``, single
device).

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
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.ops.distance import center_rows
from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple
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


def _query_dtype(cfg: KNNConfig) -> torch.dtype:
    from mpi_knn_tpu_torch.backends.serial import torch_dtype

    return torch_dtype(cfg.dtype)


@dataclasses.dataclass
class _Slot:
    """One batch's host staging: the padded queries and the padded
    results (pinned on a card), and the batch's start and end events."""

    host_in: torch.Tensor
    out_d: torch.Tensor
    out_i: torch.Tensor
    start: torch.cuda.Event | None
    done: torch.cuda.Event | None


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
    qids: torch.Tensor | None  # serial: (q_pad,) all −1 on the device
    free: list = dataclasses.field(default_factory=list)  # idle slots
    slots: int = 0  # slots made

    def _new_slot(self) -> _Slot:
        card = self.device.type == "cuda"
        shape = (self.q_pad, self.cfg.k)
        events = ((torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) if card
                  else (None, None))
        self.slots += 1
        return _Slot(
            torch.empty((self.q_pad, self.dim), dtype=_query_dtype(self.cfg),
                        pin_memory=card),
            torch.empty(shape, dtype=_acc_dtype(self.cfg), pin_memory=card),
            torch.empty(shape, dtype=torch.int32, pin_memory=card),
            *events)

    def reserve(self, n: int):
        """Make slots until ``n`` exist, so n batches of this entry can be
        in flight without a new pinned allocation."""
        while self.slots < n:
            self.free.append(self._new_slot())

    def acquire(self) -> _Slot:
        return self.free.pop() if self.free else self._new_slot()

    def release(self, slot: _Slot):
        self.free.append(slot)


def bucket_shapes(index: CorpusIndex, cfg: KNNConfig, bucket: int):
    """``(q_pad, q_tile)`` of one (bucket, config) entry."""
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
    mutation and compaction knobs pace layers not served here)."""
    return cfg.replace(
        dispatch_depth=1, query_bucket=1, mutation_bucket=1,
        bucket_headroom=0.0, compact_fill_threshold=1.0,
        compact_tombstone_fraction=1.0,
    )


def get_executable(index: CorpusIndex, cfg: KNNConfig,
                   bucket: int) -> _BucketExec:
    """The (bucket, config) entry, built at most once per index. Configs
    that differ in any field that reaches the computation occupy distinct
    entries."""
    key = (bucket, _fingerprint_cfg(cfg))
    exec_ = index._cache.get(key)
    if exec_ is None:
        exec_ = index._cache[key] = _build_entry(index, cfg, bucket)
    return exec_


def _build_entry(index: CorpusIndex, cfg: KNNConfig,
                 bucket: int) -> _BucketExec:
    global MISSES
    MISSES += 1
    q_pad, q_tile = bucket_shapes(index, cfg, bucket)
    qids = None
    if index.backend == "serial":
        qids = torch.full((q_pad,), -1, dtype=torch.int32, device=index.device)
    return _BucketExec(bucket, q_pad, q_tile, cfg, index.backend,
                       index.device, index.dim, qids)


def index_peak_hbm_bytes(index: CorpusIndex) -> int | None:
    """Peak device bytes allocated on the index's card so far
    (``torch.cuda.max_memory_allocated``); None off the card."""
    if index.device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(index.device)


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
        return pad_rows_any(q, exec_.q_pad, dtype=_query_dtype(cfg),
                            device=dev)
    # a host batch over a host-built index: f64 centering on the host, then
    # the cast and padding in the slot's (pinned) buffer, one copy over
    q = np.asarray(q)
    if mu is not None:
        q = center_rows(q, mu)
    slot.host_in[:rows].copy_(torch.from_numpy(np.ascontiguousarray(q)))
    slot.host_in[rows:].zero_()
    return slot.host_in


def _run(index: CorpusIndex, cfg: KNNConfig, exec_: _BucketExec, q2d):
    """One padded batch through the backend: padded (q_pad, k) results on
    the index's device."""
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
    from mpi_knn_tpu_torch.backends.fused_backend import serve_batch_pallas

    return serve_batch_pallas(q2d, index.corpus_padded, index.staged, cfg,
                              exec_.q_tile, index.c_tile, index.m)


def _dispatch(index: CorpusIndex, cfg: KNNConfig, exec_: _BucketExec,
              slot: _Slot, q):
    """Enqueue one batch, its results copied into the slot's outputs and
    its end event recorded. Returns the padded device results and the
    host's milliseconds centering and padding it."""
    t0 = time.perf_counter()
    q2d = _prep_queries(index, cfg, exec_, slot, q)
    prep_ms = 1e3 * (time.perf_counter() - t0)
    if slot.start is not None:
        slot.start.record()
    d, i = _run(index, cfg, exec_, q2d.to(index.device, non_blocking=True))
    slot.out_d.copy_(d, non_blocking=True)
    slot.out_i.copy_(i, non_blocking=True)
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
    tenant: str | None = None
    host_ms: float | None = None  # the host's time in submit's dispatch
    prep_ms: float | None = None  # of which centering and padding
    latency_s: float | None = None  # dispatch -> retire
    # events: from after the host work (before the host->device copy) to
    # the end of the device->host copy
    device_ms: float | None = None
    dists: np.ndarray | None = None  # (rows, k), set at retire
    ids: np.ndarray | None = None


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
    finally:
        exec_.release(slot)
    return KNNResult(dists=torch.from_numpy(d), ids=torch.from_numpy(i))


def _check_tenant(tenant):
    if tenant is not None and (
            not isinstance(tenant, str) or not tenant
            or any(c in tenant for c in ('"', "\\", "\n", "\r"))):
        raise ValueError(
            f"tenant id {tenant!r} must be a non-empty string with no "
            "quotes, backslashes, or newlines"
        )


class ServeSession:
    """Bounded dispatch-ahead serving over one index.

    ``submit`` dispatches a batch and returns the batches it had to retire
    to keep at most ``dispatch_depth`` in flight; ``drain`` retires the
    rest; ``stream`` does both over an iterable, yielding in order. Depth
    1 retires every batch before ``submit`` returns.

    Sessions are reusable across streams: the index's entries stay built,
    and ``seq`` keeps counting. The window accumulators (``latencies``,
    ``queries_served``, ``tenant_stats``) grow until ``reset_stats``; a
    batch in flight across a reset lands in the new window. One caller
    dispatches; ``stats_snapshot`` may be read from other threads.
    """

    def __init__(self, index: CorpusIndex, config: KNNConfig | None = None,
                 device=DEFAULT_DEVICE, **overrides):
        _check_device(index, device)
        self.index = index
        self.cfg = index.compatible_cfg(
            (config or index.cfg).replace(**overrides))
        self._seq = 0
        self._inflight: collections.deque = collections.deque()
        self._stats_lock = threading.Lock()
        self.latencies: list[float] = []
        self.queries_served = 0
        self.tenant_stats: dict[str, dict] = {}

    def warm(self, sizes) -> dict:
        """Build the entries of the given batch sizes' buckets, each with
        ``dispatch_depth`` slots, before traffic. Returns ``{cells,
        raw_cells, deduped, built, reused, wall_s}``."""
        t0 = time.perf_counter()
        cfg = self.cfg
        raw = [bucket_rows(n, cfg.query_bucket) for n in sizes]
        cells = sorted(set(raw))
        fp = _fingerprint_cfg(cfg)
        reused = sum((b, fp) in self.index._cache for b in cells)
        for b in cells:
            get_executable(self.index, cfg, b).reserve(cfg.dispatch_depth)
        return {
            "cells": len(cells), "raw_cells": len(raw),
            "deduped": len(raw) - len(cells), "built": len(cells) - reused,
            "reused": reused, "wall_s": round(time.perf_counter() - t0, 4),
        }

    def stats_snapshot(self) -> dict:
        """The window's counters in one critical section."""
        with self._stats_lock:
            return {
                "batches_retired": len(self.latencies),
                "queries_served": self.queries_served,
                "tenants": sorted(self.tenant_stats),
                "bucket_entries": len(self.index._cache),
                "peak_hbm_bytes": index_peak_hbm_bytes(self.index),
            }

    def reset_stats(self):
        """Start a fresh window: resets ``latencies``, ``queries_served``
        and ``tenant_stats``; ``seq`` and the built entries stay."""
        with self._stats_lock:
            self.latencies = []
            self.queries_served = 0
            self.tenant_stats = {}

    def submit(self, queries, tenant: str | None = None) -> list[BatchResult]:
        """Dispatch one batch (of one ``tenant``, if given)."""
        t0 = time.perf_counter()
        _check_tenant(tenant)
        cfg = self.cfg
        rows = int(queries.shape[0])
        bucket = bucket_rows(rows, cfg.query_bucket)
        exec_ = get_executable(self.index, cfg, bucket)
        slot = exec_.acquire()
        try:
            d, i, prep_ms = _dispatch(self.index, cfg, exec_, slot, queries)
        except Exception:
            exec_.release(slot)
            raise
        res = BatchResult(d, i, rows, bucket, seq=self._seq, tenant=tenant,
                          host_ms=1e3 * (time.perf_counter() - t0),
                          prep_ms=prep_ms)
        self._seq += 1
        self._inflight.append((res, t0, exec_, slot))
        done = []
        while len(self._inflight) >= max(1, cfg.dispatch_depth):
            done.append(self._retire())
        return done

    def drain(self) -> list[BatchResult]:
        out = []
        while self._inflight:
            out.append(self._retire())
        return out

    def stream(self, batches, tenant: str | None = None):
        """Serve an iterable of batches (all of one ``tenant``, if given),
        yielding results in order."""
        for q in batches:
            yield from self.submit(q, tenant=tenant)
        yield from self.drain()

    def _retire(self) -> BatchResult:
        res, t0, exec_, slot = self._inflight.popleft()
        try:
            res.dists, res.ids = _fetch(slot, res.rows)
            res.latency_s = time.perf_counter() - t0
            if slot.start is not None:
                res.device_ms = slot.start.elapsed_time(slot.done)
        finally:
            exec_.release(slot)
        with self._stats_lock:
            self.latencies.append(res.latency_s)
            self.queries_served += res.rows
            if res.tenant is not None:
                st = self.tenant_stats.setdefault(res.tenant, {
                    "queries": 0, "batches": 0,
                    "latency_sum_s": 0.0, "latency_max_s": 0.0,
                })
                st["queries"] += res.rows
                st["batches"] += 1
                st["latency_sum_s"] += res.latency_s
                st["latency_max_s"] = max(st["latency_max_s"], res.latency_s)
        return res

    def upsert(self, ids, rows, tenant: str | None = None):
        raise _mutation_error()

    def delete(self, ids, tenant: str | None = None):
        raise _mutation_error()


def _mutation_error() -> ValueError:
    return ValueError(
        "live mutation (upsert/delete/compact): not yet ported to "
        "mpi_knn_tpu_torch (see ROADMAP.md)"
    )
