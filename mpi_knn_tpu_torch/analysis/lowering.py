"""The lint's cell matrix, run on the port's own entry points and recorded:
the counterpart of the JAX package's ``analysis/lowering.py``.

The JAX package lowers each cell of its backend × metric × dtype ×
policy × schedule × serve × ladder × front end × mutation × quantization
× fusion matrix to HLO. The port has no compiled program, so
:func:`lower_target` builds the cell's inputs or index at the JAX
package's lint sizes, runs the production entry the cell names (the
backends' ``all_knn_*``, ``ivf.search_ivf``, ``ivf.sharded``'s search,
the serving engine's ``query_knn`` after warm-up, the front end's
coalescer, ``serve.mutate``) under :func:`~mpi_knn_tpu_torch.utils.
op_trace.record`, and returns ``(trace, cfg, meta)``. ``meta`` carries
the JAX package's facts (tile sizes, the accumulation width, budgets, the
cost scheme, the ring's expected transfers, the quantized wire budgets)
derived from the shapes the port's code chose.

The data is random, drawn from a fixed seed; the rules check structure,
not values. A cell runs on the CPU (the kernels' plain versions) or on
the card (the hand kernels), as ``device`` says.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from mpi_knn_tpu_torch.config import BACKENDS, METRICS, KNNConfig

LINT_DTYPES = ("float32", "bfloat16", "float64")
LINT_QUANTS = ("xfer-int8", "int8", "int4")
DENSE_LINT_BACKENDS = tuple(b for b in BACKENDS if b != "auto")
LINT_BACKENDS = DENSE_LINT_BACKENDS + ("ivf", "ivf-sharded")
RING_BACKENDS = ("ring", "ring-overlap")

# the JAX package's lint sizes: 8 query tiles, 8 corpus tiles, an 8-way
# ring with one (q_tile × c_tile) tile a rank a round
LINT_M, LINT_NQ, LINT_D, LINT_K = 128, 64, 32, 4
LINT_QUERY_TILE, LINT_CORPUS_TILE = 8, 16
LINT_M_MIXED, LINT_CORPUS_TILE_MIXED = 256, 32
LINT_RING = 8  # ring ranks (logical ranks on one device)
LINT_M_IVF, LINT_PARTITIONS, LINT_NPROBE = 256, 8, 2
LINT_IVF_SHARDS = 4
LINT_MUTATE_CHUNK = 32
LINT_MUTATE_HEADROOM = 0.5  # room in the buckets for the upserted rows


@dataclasses.dataclass(frozen=True)
class LintTarget:
    """One cell of the matrix (the JAX package's fields and label)."""

    backend: str
    metric: str
    dtype: str
    policy: str = "exact"
    schedule: str = "uni"
    serve: bool = False
    ladder: str = ""  # "" | "bucket" | "nprobe" — serve cells only
    quant: str = ""  # "" | "xfer-int8" (ring) | "int8" | "int4" (at rest)
    frontend: bool = False
    mutate: str = ""  # "" | "upsert" | "delete" | "compact"
    fusion: str = "xla"

    @property
    def label(self) -> str:
        base = f"{self.backend}/{self.metric}/{self.dtype}"
        if self.policy != "exact":
            base = f"{base}/{self.policy}"
        if self.schedule != "uni":
            base = f"{base}/{self.schedule}"
        if self.fusion != "xla":
            base = f"{base}/{self.fusion}"
        if self.quant:
            base = f"{base}/{self.quant}"
        if self.serve:
            base = f"{base}/serve"
        if self.ladder:
            base = f"{base}/ladder-{self.ladder}"
        if self.frontend:
            base = f"{base}/frontend"
        if self.mutate:
            base = f"{base}/mutate-{self.mutate}"
        return base


def default_targets() -> list[LintTarget]:
    """The JAX package's 79 cells, in its order."""
    T = LintTarget
    return [
        T(b, m, d) for b in DENSE_LINT_BACKENDS for m in METRICS
        for d in LINT_DTYPES
    ] + [
        T(b, m, "float32", "mixed") for b in DENSE_LINT_BACKENDS
        for m in METRICS
    ] + [
        T(b, m, "float32", p, "bidir") for b in RING_BACKENDS for m in METRICS
        for p in ("exact", "mixed")
    ] + [
        T(b, "l2", "float32", serve=True) for b in DENSE_LINT_BACKENDS
    ] + [
        T("serial", "l2", "float32", "mixed", serve=True),
        T("ivf", "l2", "float32"),
        T("ivf", "l2", "float32", "mixed"),
        T("ivf", "l2", "float32", serve=True),
        T("ivf", "l2", "float32", "mixed", serve=True),
        T("ivf-sharded", "l2", "float32"),
        T("ivf-sharded", "l2", "float32", "mixed"),
        T("ivf-sharded", "l2", "float32", serve=True),
        T("ivf-sharded", "l2", "float32", "mixed", serve=True),
        T("serial", "l2", "float32", serve=True, ladder="bucket"),
        T("ivf", "l2", "float32", serve=True, ladder="bucket"),
        T("ivf", "l2", "float32", serve=True, ladder="nprobe"),
        T("ivf-sharded", "l2", "float32", serve=True, ladder="nprobe"),
        T("serial", "l2", "float32", serve=True, frontend=True),
        T("serial", "l2", "float32", mutate="upsert"),
        T("serial", "l2", "float32", mutate="delete"),
        T("ivf", "l2", "float32", mutate="upsert"),
        T("ivf", "l2", "float32", mutate="delete"),
        T("ivf", "l2", "float32", mutate="compact"),
        T("ivf-sharded", "l2", "float32", mutate="upsert"),
        T("ring", "l2", "float32", "mixed", quant="xfer-int8"),
        T("ring-overlap", "l2", "float32", "mixed", quant="xfer-int8"),
        T("ring-overlap", "l2", "float32", "mixed", "bidir",
          quant="xfer-int8"),
        T("ring-overlap", "l2", "float32", "mixed", serve=True,
          quant="xfer-int8"),
        T("ring-overlap", "l2", "float32", fusion="fused"),
        T("ring-overlap", "l2", "float32", "exact", "bidir", fusion="fused"),
        T("ring-overlap", "l2", "float32", "mixed", fusion="fused"),
        T("ring-overlap", "l2", "float32", "mixed", "bidir", fusion="fused"),
        T("ring-overlap", "l2", "float32", "mixed", quant="xfer-int8",
          fusion="fused"),
        T("ivf", "l2", "float32", quant="int8"),
        T("ivf", "l2", "float32", "mixed", quant="int8"),
        T("ivf", "l2", "float32", quant="int4"),
        T("ivf", "l2", "float32", "mixed", serve=True, quant="int8"),
        T("ivf-sharded", "l2", "float32", "mixed", quant="int8"),
        T("ivf-sharded", "l2", "float32", "mixed", serve=True, quant="int8"),
    ]


class UnsupportedTarget(Exception):
    """The configuration is refused by the port's own entry point (a
    registered restriction, not a lint failure)."""


# ---------------------------------------------------------------------------
# facts


def _base_cfg(target: LintTarget) -> KNNConfig:
    mixed = target.policy == "mixed"
    return KNNConfig(
        k=LINT_K, metric=target.metric, dtype=target.dtype,
        query_tile=LINT_QUERY_TILE,
        corpus_tile=LINT_CORPUS_TILE_MIXED if mixed else LINT_CORPUS_TILE,
        precision_policy=target.policy, ring_schedule=target.schedule,
        ring_transfer_dtype="int8" if target.quant == "xfer-int8" else None,
        ring_fusion=target.fusion, backend=target.backend,
        num_devices=LINT_RING if target.backend in RING_BACKENDS else None,
    )


def _lint_m(target: LintTarget) -> int:
    return LINT_M_MIXED if target.policy == "mixed" else LINT_M


def _acc_bytes(dtype: str) -> int:
    return 8 if dtype == "float64" else 4


def _mixed_meta(target: LintTarget, q_tile: int, c_tile: int) -> dict:
    """R2's registered allowance for the rerank's (q_tile, 4k, d) survivor
    gather (the JAX package's ``_mixed_meta``)."""
    from mpi_knn_tpu_torch.ops.rerank import overfetch_width

    if target.policy != "mixed":
        return {}
    return {"extra_elems": q_tile * overfetch_width(LINT_K, c_tile) * LINT_D}


def dense_cost(target: LintTarget, q: int, c: int, c_tile: int, *,
               queries: int, sites: int = 1, trips: int = 1,
               rblocks: int | None = None) -> dict:
    """R8's FLOP facts of a dense cell (the JAX package's ``_dense_cost``):
    the padded extents of one rank's product, the schedule's sites and
    trips, and on mixed cells the rerank's overfetch width and rerank
    blocks a site-trip."""
    from mpi_knn_tpu_torch.ops.rerank import mixed_applies, overfetch_width

    facts = {"scheme": "dense", "q": int(q), "c": int(c), "d": LINT_D,
             "sites": sites, "trips": trips, "queries": int(queries)}
    if target.policy == "mixed" and mixed_applies(LINT_K, c_tile):
        facts["w"] = overfetch_width(LINT_K, c_tile)
        facts["rblocks"] = (rblocks if rblocks is not None
                            else int(c) // int(c_tile))
    return facts


def ivf_cost(index, cfg: KNNConfig, q: int, *, queries: int) -> dict:
    """R8's FLOP facts of a clustered cell (the JAX package's
    ``_ivf_cost``): centroid scoring plus the probed-width product, ``q``
    the padded query rows of one shard."""
    from mpi_knn_tpu_torch.ops.rerank import mixed_applies, overfetch_width

    v = cfg.nprobe * index.bucket_cap
    facts = {"scheme": "ivf", "q": int(q), "d": index.dim,
             "partitions": index.partitions, "nprobe": cfg.nprobe,
             "bucket_cap": index.bucket_cap, "queries": int(queries)}
    if cfg.precision_policy == "mixed" and mixed_applies(cfg.k, v):
        facts["w"] = overfetch_width(cfg.k, v)
        facts["rblocks"] = 1
    return facts


def _ring_facts(target: LintTarget, cfg: KNNConfig, q_pad: int, c_pad: int,
                c_tile: int, queries: int, devices: list) -> dict:
    """A ring cell's facts: one rank's product over the P blocks it merges
    (bidir merges each block once as well, so its sites·trips is P where
    the JAX package's scan body counts its two sites on every one of its
    ⌊P/2⌋+1 trips), and the transfers a round moves."""
    from mpi_knn_tpu_torch.backends.ring import ring_form
    from mpi_knn_tpu_torch.ops.fused_knn import split_width
    from mpi_knn_tpu_torch.ops.fused_ring import merges_exactly

    P = LINT_RING
    quantized = target.quant == "xfer-int8"
    # what rides a driver copy besides block and ids: the int8 wire's
    # scales, and the exact prologue's norms where the merge is K3a's
    parts = ["block", "ids"]
    if quantized:
        parts.append("scale")
    if cfg.ring_fusion == "fused" and merges_exactly(cfg, c_tile):
        parts.append("norms")
    meta = {
        "ring_n": P,
        "ring_schedule": target.schedule,
        "expected_parts": tuple(parts),
        "cost_copies": P,
        "cost": dense_cost(target, q_pad // P, c_pad // P, c_tile,
                           queries=queries, sites=1, trips=P),
    }
    if quantized:
        meta["quantized"] = True
        meta["permute_bytes_budget"] = (c_pad // P) * LINT_D
        # the wire quantizes the padded corpus once, at shard time, inside
        # the call (the JAX package quantizes outside the program it
        # lints): |x| and x·inv, two f32 corpus-sized temporaries at once
        meta["peak_extra_elems"] = 2 * c_pad * LINT_D
    if target.schedule == "bidir" or target.fusion == "fused":
        meta["extra_elems"] = 2 * (c_pad // P) * LINT_D
    if ring_form(cfg, devices) != "driver":
        # a kernel-moved ring (K4 on cards) keeps every rank's two landing
        # slots resident, each a block with the TF32 planes the wgmma
        # tile reads, and the queries' planes: the ranks all live on the
        # one device the lint runs on
        w = split_width(LINT_D)
        meta["peak_extra_elems"] = meta.get("peak_extra_elems", 0) + P * (
            2 * 3 * (c_pad // P) * w + 2 * (q_pad // P) * w)
    return meta


# ---------------------------------------------------------------------------
# data and indexes


def _rows(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, LINT_D)) * 3).astype(np.float32)


def _tensor(a: np.ndarray, dtype: str, device):
    import torch

    from mpi_knn_tpu_torch.backends.serial import torch_dtype

    return torch.as_tensor(a, device=device).to(torch_dtype(dtype))


def _ivf_cfg(target: LintTarget, headroom: float = 0.0) -> KNNConfig:
    return KNNConfig(
        k=LINT_K, query_tile=LINT_QUERY_TILE, precision_policy=target.policy,
        partitions=LINT_PARTITIONS, nprobe=LINT_NPROBE, kmeans_iters=2,
        dtype=target.quant if target.quant in ("int8", "int4") else "float32",
        bucket_headroom=headroom, query_bucket=LINT_NQ,
    )


@functools.lru_cache(maxsize=None)
def _ivf_index(cfg: KNNConfig, device: str):
    from mpi_knn_tpu_torch.ivf import build_ivf_index

    return build_ivf_index(_rows(LINT_M_IVF, 0), cfg, device=device)


def _sharded(index):
    """The lint index over 4 shards, all on the index's device."""
    from mpi_knn_tpu_torch.ivf.sharded import shard_ivf_index

    return shard_ivf_index(index, shards=LINT_IVF_SHARDS,
                           mesh=[index.device] * LINT_IVF_SHARDS)


def _resident_bytes(index) -> int:
    """R5's copy threshold (the JAX package's ``serve_resident_bytes``): the
    resident payload, a quantized store priced at its f32 equivalent."""
    n = index.nbytes_resident
    if getattr(index, "bucket_scales", None) is not None:
        n = max(n, index.partitions * index.bucket_cap * index.dim * 4)
    return n


def _keys(*ts) -> tuple:
    """(device, storage address) of each tensor: how a rule finds a
    tensor that existed before the call in the trace."""
    return tuple((str(t.device), t.untyped_storage().data_ptr())
                 for t in ts if t is not None)


def _ivf_meta(index, cfg: KNNConfig, q_tile: int, q_pad: int, queries: int,
              shards: int = 1) -> dict:
    v = cfg.nprobe * index.bucket_cap
    meta = {
        # the finish reranks in f64 (ops/rerank.py), where the JAX
        # package's is f32: its accumulation width is 8 bytes
        "q_tile": q_tile, "c_tile": v, "acc_bytes": 8,
        "partitions": index.partitions, "dim": index.dim,
        "cost": ivf_cost(index, cfg, q_pad // shards, queries=queries),
        "cost_copies": shards,
        "budget_elems": q_tile * v * index.dim,
        "store_keys": _keys(index.buckets),
        "args_bytes": q_pad * index.dim * 4,
    }
    if index.bucket_scales is not None:
        meta["quantized"] = True
        meta["quant_gather_bytes"] = 2 * q_tile * v * index.buckets.shape[-1]
    return meta


def _sharded_meta(index, cfg: KNNConfig, q_tile: int, route_cap: int,
                  q_pad: int, queries: int) -> dict:
    from mpi_knn_tpu_torch.ivf.sharded import (
        exchange_bytes_per_tile,
        exchange_elems,
        exchange_wire_args,
    )

    v = cfg.nprobe * index.bucket_cap
    meta = _ivf_meta(index, cfg, q_tile, q_pad, queries, shards=index.shards)
    meta.update(
        shards=index.shards, route_cap=route_cap,
        expected_alltoalls=4 + (index.bucket_scales is not None),
        exchange_bytes_tile=index.shards * exchange_bytes_per_tile(
            index.shards, route_cap, index.bucket_cap,
            *exchange_wire_args(index)),
        budget_elems=max(q_tile * v * index.dim, exchange_elems(
            index.shards, route_cap, index.bucket_cap, index.dim)),
        store_keys=_keys(index.buckets),
    )
    if index.bucket_scales is not None:
        meta["quant_gather_bytes"] = 2 * max(
            q_tile * v, index.shards * route_cap * index.bucket_cap,
        ) * index.buckets.shape[-1]
    return meta


# ---------------------------------------------------------------------------
# the cells


def _record(fn, dev):
    """The trace of ``fn()``; on a card with the caching allocator's peak
    growth over the call (``trace.allocator_growth``, R7's cross-check)."""
    import torch

    from mpi_knn_tpu_torch.utils.op_trace import record

    card = dev.type == "cuda"
    if card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    # the CPU counts the plain versions' products with FlopCounterMode; the
    # card's count is the trace's own beside the kernels' side-band
    trace = record(fn, dev.type, flop_counter=not card)[1]
    if card:
        torch.cuda.synchronize(dev)
        trace.allocator_growth = torch.cuda.max_memory_allocated(dev) - base
    return trace


def _lower_serial(target: LintTarget, dev, overrides: dict):
    from mpi_knn_tpu_torch.backends.serial import all_knn_serial
    from mpi_knn_tpu_torch.parallel.partition import pad_to_multiple
    from mpi_knn_tpu_torch.shapes import effective_tiles

    cfg = _base_cfg(target).replace(**overrides)
    m = _lint_m(target)
    corpus = _tensor(_rows(m, 0), cfg.dtype, dev)
    queries = _tensor(_rows(LINT_NQ, 1), cfg.dtype, dev)
    q_ids = np.full(LINT_NQ, -1, np.int32)
    q_tile, c_tile = effective_tiles(cfg, m, LINT_NQ)
    q_pad, m_pad = pad_to_multiple(LINT_NQ, q_tile), pad_to_multiple(m, c_tile)
    trace = _record(lambda: all_knn_serial(corpus, queries, q_ids, cfg, dev),
                    dev)
    item = corpus.element_size()
    meta = {"q_tile": q_tile, "c_tile": c_tile,
            "acc_bytes": _acc_bytes(target.dtype),
            "input_elems": m_pad * LINT_D,
            "args_bytes": (m_pad + q_pad) * (LINT_D * item + 4),
            "out_bytes": q_pad * LINT_K * (_acc_bytes(target.dtype) + 4),
            "cost": dense_cost(target, q_pad, m_pad, c_tile, queries=LINT_NQ),
            **_mixed_meta(target, q_tile, c_tile)}
    if target.dtype == "bfloat16":
        # the bf16 rows widen to f32 tile by tile for the f32 product
        meta["peak_extra_elems"] = (m + LINT_NQ) * LINT_D
    if cfg.topk_method in ("approx", "approx-rerank"):
        # the bin minimum's plain version pads each tile's rows to the
        # kernel's 128 lanes (values, ids, their bins and positions)
        meta["peak_extra_elems"] = (meta.get("peak_extra_elems", 0)
                                    + 4 * q_tile * 128)
    return trace, cfg, meta


def _ring_mesh(dev):
    return [dev] * LINT_RING


def _lower_ring(target: LintTarget, dev, overrides: dict):
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring
    from mpi_knn_tpu_torch.shapes import ring_tiles

    cfg = _base_cfg(target).replace(**overrides)
    m = _lint_m(target)
    corpus = _tensor(_rows(m, 0), cfg.dtype, dev)
    queries = _tensor(_rows(LINT_NQ, 1), cfg.dtype, dev)
    q_ids = np.full(LINT_NQ, -1, np.int32)
    q_tile, c_tile, q_pad, c_pad = ring_tiles(cfg, m, LINT_NQ, 1, LINT_RING)
    overlap = target.backend == "ring-overlap"
    trace = _record(lambda: all_knn_ring(corpus, queries, q_ids, cfg,
                                         mesh=_ring_mesh(dev), overlap=overlap,
                                         device=dev), dev)
    item = corpus.element_size()
    meta = {"q_tile": q_tile, "c_tile": c_tile,
            "acc_bytes": _acc_bytes(target.dtype),
            "input_elems": c_pad * LINT_D,
            "args_bytes": (c_pad + q_pad) * (LINT_D * item + 4),
            "out_bytes": q_pad * LINT_K * (_acc_bytes(target.dtype) + 4),
            "overlap": overlap,
            **_mixed_meta(target, q_tile, c_tile),
            **_ring_facts(target, cfg, q_pad, c_pad, c_tile, LINT_NQ,
                          _ring_mesh(dev))}
    return trace, cfg, meta


def _lower_pallas(target: LintTarget, dev, overrides: dict):
    from mpi_knn_tpu_torch.backends.fused_backend import (
        all_knn_pallas,
        fused_corpus_tile,
        fused_query_tile,
    )
    from mpi_knn_tpu_torch.parallel.partition import pad_to_multiple

    if target.dtype != "float32":
        raise UnsupportedTarget(
            "pallas backend computes in float32 only (its own wrapper "
            "rejects other dtypes)")
    cfg = _base_cfg(target).replace(**overrides)
    m = _lint_m(target)
    corpus = _tensor(_rows(m, 0), "float32", dev)
    queries = _tensor(_rows(LINT_NQ, 1), "float32", dev)
    q_ids = np.full(LINT_NQ, -1, np.int32)
    q_tile, c_tile = fused_query_tile(cfg, LINT_NQ), fused_corpus_tile(cfg, m)
    q_pad, c_pad = pad_to_multiple(LINT_NQ, q_tile), pad_to_multiple(m, c_tile)
    trace = _record(lambda: all_knn_pallas(corpus, queries, q_ids, cfg, dev),
                    dev)
    # the tile the run materializes: the kernels' plain versions take every
    # padded query row against one corpus tile (the kernels themselves
    # keep their tiles on chip)
    meta = {"q_tile": q_pad, "c_tile": c_tile, "acc_bytes": 4,
            "input_elems": c_pad * LINT_D,
            "args_bytes": (c_pad + q_pad) * LINT_D * 4,
            "out_bytes": q_pad * LINT_K * 8,
            "cost": dense_cost(target, q_pad, c_pad, c_tile, queries=LINT_NQ,
                               rblocks=1),
            **_mixed_meta(target, q_tile, c_tile)}
    if target.metric == "cosine":
        # cosine rides the L2 kernels on unit rows: both row sets are
        # normalized into copies first
        meta["peak_extra_elems"] = (c_pad + q_pad) * LINT_D
    return trace, cfg, meta


def _warm_and_record(index, cfg, queries, dev, bucket):
    """Warm the (bucket, config) entry and its slot with one batch, then
    record one more: the steady state a served batch runs in. Returns
    (trace, the entry, the storages of the slots' results as warm-up left
    them)."""
    from mpi_knn_tpu_torch.serve.engine import bucket_rows, get_executable, query_knn

    query_knn(queries, index, cfg, device=dev)
    exec_ = get_executable(index, cfg, bucket_rows(queries.shape[0],
                                                   cfg.query_bucket))
    slots = tuple(k for s in exec_.free for k in _keys(s.out_d, s.out_i))
    trace = _record(lambda: query_knn(queries, index, cfg, device=dev), dev)
    return trace, exec_, slots


def _lower_serve(target: LintTarget, dev):
    from mpi_knn_tpu_torch.serve import build_index

    bucket = LINT_NQ // 2 if target.ladder == "bucket" else LINT_NQ
    if target.backend in ("ivf", "ivf-sharded"):
        return _lower_serve_ivf(target, dev, bucket)
    if target.backend == "pallas" and target.dtype != "float32":
        raise UnsupportedTarget("pallas backend computes in float32 only")
    cfg = _base_cfg(target).replace(query_bucket=bucket)
    m = _lint_m(target)
    mesh = _ring_mesh(dev) if target.backend in RING_BACKENDS else None
    index = build_index(_rows(m, 0), cfg, device=dev, mesh=mesh)
    cfg = index.cfg
    queries = _rows(bucket, 1)
    meta = {}
    if target.frontend:
        queries, meta = _coalesced(queries, cfg, bucket)
    trace, exec_, slots = _warm_and_record(index, cfg, queries, dev, bucket)
    q_pad, q_tile = exec_.q_pad, exec_.q_tile
    meta.update({
        "q_tile": q_tile, "c_tile": index.c_tile,
        "acc_bytes": _acc_bytes(target.dtype), "serve": True,
        "args_bytes": q_pad * (LINT_D * 4 + 4),
        "out_bytes": q_pad * LINT_K * (_acc_bytes(target.dtype) + 4),
        "slot_keys": slots,
        "resident_bytes": index.nbytes_resident,
        **_mixed_meta(target, q_tile, index.c_tile),
    })
    if target.backend in RING_BACKENDS:
        c_pad = sum(t[0].shape[0] for t in index.shards)
        meta.update(_ring_facts(target, cfg, q_pad, c_pad, index.c_tile,
                                bucket, index.mesh))
        meta["overlap"] = target.backend == "ring-overlap"
        meta["input_elems"] = c_pad * LINT_D
    elif target.backend == "pallas":
        c_pad = index.corpus_padded.shape[0]
        meta["q_tile"] = q_pad  # the plain versions' tile, as one-shot
        meta["cost"] = dense_cost(target, q_pad, c_pad, index.c_tile,
                                  queries=bucket, rblocks=1)
        meta["input_elems"] = c_pad * LINT_D
    else:
        c_pad = int(index.tiles.shape[0]) * index.c_tile
        meta["cost"] = dense_cost(target, q_pad, c_pad, index.c_tile,
                                  queries=bucket)
        meta["input_elems"] = c_pad * LINT_D
    return trace, cfg, meta


def _coalesced(queries, cfg: KNNConfig, bucket: int):
    """The front-end cell's batch: four tenants' requests round-robined by
    the production coalescer into one batch, which must land on the serve
    grid's bucket (no new entry: the front end only fills buckets)."""
    from mpi_knn_tpu_torch.frontend.coalesce import Coalescer
    from mpi_knn_tpu_torch.serve.engine import bucket_rows

    co = Coalescer(max_batch_rows=bucket, max_wait_s=0.001)
    per = bucket // 4
    for i in range(4):
        co.admit(f"tenant-{i}", queries[i * per:(i + 1) * per], per, now=0.0)
    cb = co.pop_ready(now=0.0)
    if cb is None or bucket_rows(cb.rows, cfg.query_bucket) != bucket:
        raise AssertionError(
            "front-end coalescing selected a bucket outside the serve grid: "
            f"coalesced {getattr(cb, 'rows', None)} rows vs expected bucket "
            f"{bucket} — the no-new-entries contract is broken")
    rows = np.concatenate([p.queries for p in cb.parts])
    return rows, {"frontend": True, "coalesced_rows": cb.rows,
                  "coalesced_requests": len(cb.parts),
                  "coalesced_tenants": len(cb.tenants)}


def _lower_serve_ivf(target: LintTarget, dev, bucket: int):
    from mpi_knn_tpu_torch.shapes import resolve_route_cap

    if target.metric != "l2" or target.dtype != "float32":
        raise UnsupportedTarget("the clustered (IVF) path is l2/float32")
    plain = _ivf_index(_ivf_cfg(target), str(dev))
    index = _sharded(plain) if target.backend == "ivf-sharded" else plain
    cfg = _ivf_cfg(target).replace(query_bucket=bucket)
    if target.ladder == "nprobe":
        cfg = cfg.replace(nprobe=1)
    if target.backend == "ivf-sharded":
        cfg = cfg.replace(ivf_shards=LINT_IVF_SHARDS)
    cfg = index.compatible_cfg(cfg)
    trace, exec_, slots = _warm_and_record(index, cfg, _rows(bucket, 1), dev,
                                           bucket)
    q_pad, q_tile = exec_.q_pad, exec_.q_tile
    if target.backend == "ivf-sharded":
        meta = _sharded_meta(index, cfg, q_tile,
                             resolve_route_cap(cfg, q_tile, cfg.nprobe),
                             q_pad, bucket)
    else:
        meta = _ivf_meta(index, cfg, q_tile, q_pad, bucket)
    meta.update(serve=True, slot_keys=slots,
                resident_bytes=_resident_bytes(index))
    return trace, cfg, meta


def _lower_ivf(target: LintTarget, dev):
    from mpi_knn_tpu_torch.ivf.search import ivf_query_shapes, search_ivf

    if target.metric != "l2" or target.dtype != "float32":
        raise UnsupportedTarget(
            "the clustered (IVF) path is l2/float32 by its own contract "
            "(ivf/index.py rejects other combinations)")
    index = _ivf_index(_ivf_cfg(target), str(dev))
    cfg = index.compatible_cfg(_ivf_cfg(target))
    q_tile, q_pad = ivf_query_shapes(cfg, cfg.nprobe, index.bucket_cap,
                                     index.dim, LINT_NQ)
    queries = _rows(LINT_NQ, 1)
    trace = _record(lambda: search_ivf(index, queries, config=cfg, device=dev),
                    dev)
    meta = _ivf_meta(index, cfg, q_tile, q_pad, LINT_NQ)
    meta["out_bytes"] = q_pad * LINT_K * 8
    return trace, cfg, meta


def _lower_ivf_sharded(target: LintTarget, dev):
    from mpi_knn_tpu_torch.ivf.sharded import (
        search_ivf_sharded,
        sharded_query_shapes,
    )

    if target.metric != "l2" or target.dtype != "float32":
        raise UnsupportedTarget(
            "the clustered (IVF) path is l2/float32 by its own contract "
            "(ivf/index.py rejects other combinations)")
    index = _sharded(_ivf_index(_ivf_cfg(target), str(dev)))
    cfg = index.compatible_cfg(_ivf_cfg(target).replace(
        ivf_shards=LINT_IVF_SHARDS))
    q_tile, q_pad, route_cap = sharded_query_shapes(
        cfg, cfg.nprobe, index.bucket_cap, index.dim, LINT_NQ, index.shards)
    queries = _rows(LINT_NQ, 1)
    trace = _record(lambda: search_ivf_sharded(index, queries, config=cfg,
                                               device=dev), dev)
    meta = _sharded_meta(index, cfg, q_tile, route_cap, q_pad, LINT_NQ)
    meta["out_bytes"] = q_pad * LINT_K * 8
    return trace, cfg, meta


def _lower_mutate(target: LintTarget, dev):
    from mpi_knn_tpu_torch.serve import build_index
    from mpi_knn_tpu_torch.serve import mutate as serve_mutate

    kind = target.mutate
    if target.metric != "l2" or target.dtype != "float32":
        raise UnsupportedTarget("the mutation cells lint the l2/float32 layouts")
    if target.backend == "serial":
        if kind == "compact":
            raise UnsupportedTarget(
                "the serial layout has no compact program (tombstones "
                "reclaim in place)")
        cfg = _base_cfg(target).replace(backend="serial",
                                        bucket_headroom=LINT_MUTATE_HEADROOM,
                                        mutation_bucket=LINT_MUTATE_CHUNK)
        index = build_index(_rows(LINT_M, 0), cfg, device=dev)
        store = (index.tiles, index.tile_ids, index.tile_sqs)
    elif target.backend in ("ivf", "ivf-sharded"):
        cfg = _ivf_cfg(target, LINT_MUTATE_HEADROOM).replace(
            mutation_bucket=LINT_MUTATE_CHUNK)
        from mpi_knn_tpu_torch.ivf import build_ivf_index

        index = build_ivf_index(_rows(LINT_M_IVF, 0), cfg, device=dev)
        if target.backend == "ivf-sharded":
            index = _sharded(index)
            cfg = cfg.replace(ivf_shards=LINT_IVF_SHARDS)
        cfg = index.compatible_cfg(cfg)
        store = (index.buckets, index.bucket_ids, index.bucket_sqs)
    else:
        raise UnsupportedTarget(
            f"the {target.backend!r} layout refuses live mutation")
    serve_mutate.warm_mutation(index, cfg)
    chunk = LINT_MUTATE_CHUNK
    ids = np.arange(10_000, 10_000 + chunk, dtype=np.int64)
    rows = _rows(chunk, 2)
    if kind == "delete":
        serve_mutate.upsert_rows(index, ids, rows, cfg)
        call = lambda: serve_mutate.delete_rows(index, ids, cfg)  # noqa: E731
    elif kind == "upsert":
        serve_mutate.upsert_rows(index, ids, rows, cfg)  # the first, warm
        call = lambda: serve_mutate.upsert_rows(  # noqa: E731
            index, ids + chunk, _rows(chunk, 3), cfg)
    else:
        serve_mutate.upsert_rows(index, ids, rows, cfg)
        serve_mutate.delete_rows(index, ids[::2], cfg)
        call = lambda: serve_mutate.compact_index(  # noqa: E731
            index, cfg, retrain=False)
    before = _keys(*store)
    trace = _record(call, dev)
    after = (_keys(index.tiles, index.tile_ids, index.tile_sqs)
             if target.backend == "serial"
             else _keys(index.buckets, index.bucket_ids, index.bucket_sqs))
    if kind == "compact":
        budget = int(index.buckets.shape[0]) * index.bucket_cap * LINT_D
        q_tile, c_tile = index.bucket_cap, LINT_D
    elif kind == "delete":
        budget = chunk
        q_tile, c_tile = chunk, 1
    else:
        budget = chunk * LINT_D
        q_tile, c_tile = chunk, LINT_D
    scored = 0
    if target.backend != "serial" and kind != "delete":
        # the clustered layout scores the rows it places against the
        # centroids: the chunk's on an upsert, every stored slot on a
        # compaction
        scored = (chunk if kind == "upsert"
                  else int(index.buckets.shape[0]) * index.bucket_cap)
    meta = {
        "q_tile": q_tile, "c_tile": c_tile, "acc_bytes": 4, "mutate": kind,
        "cost": ({"scheme": "assign", "rows": scored, "d": LINT_D,
                  "partitions": LINT_PARTITIONS, "queries": chunk}
                 if scored else {"scheme": "zero", "queries": chunk}),
        "store_before": before, "store_after": after,
        "resident_bytes": _resident_bytes(index),
        "budget_elems": budget,
        "args_bytes": chunk * (LINT_D * 4 + 8),
    }
    return trace, cfg, meta


_DENSE = DENSE_LINT_BACKENDS

_LOWERERS = {
    "serial": _lower_serial,
    "ring": _lower_ring,
    "ring-overlap": _lower_ring,
    "pallas": _lower_pallas,
    "ivf": _lower_ivf,
    "ivf-sharded": _lower_ivf_sharded,
}


# the KNNConfig fields a dense one-shot cell may run at beside the
# matrix's own: the main path's settings the JAX package's matrix does not
# vary, whose kernels (K2, K2[c], K5, the bin minimum) no cell reaches
VARIANT_FIELDS = ("pallas_variant", "ring_fused_rotation", "topk_method")


def lower_target(target: LintTarget, device="cuda", overrides=None):
    """``(trace, cfg, meta)`` of one cell run on ``device``; ``overrides``
    (``VARIANT_FIELDS`` only, dense one-shot cells only) set those config
    fields of the cell."""
    import torch

    dev = torch.device(device)
    overrides = dict(overrides or {})
    if set(overrides) - set(VARIANT_FIELDS) or (overrides and (
            target.mutate or target.serve or target.backend not in _DENSE)):
        raise ValueError(f"overrides {overrides} on {target.label}: only "
                         f"{VARIANT_FIELDS} of a dense one-shot cell")
    if target.mutate:
        return _lower_mutate(target, dev)
    if target.serve:
        return _lower_serve(target, dev)
    try:
        lowerer = _LOWERERS[target.backend]
    except KeyError:
        raise UnsupportedTarget(
            f"no entry registered for backend {target.backend!r}") from None
    if target.backend in _DENSE:
        return lowerer(target, dev, overrides)
    return lowerer(target, dev)
