"""Two-stage clustered search: centroid score → probe gather → exact
finish (the JAX package's ``ivf/search.py`` in PyTorch).

Per query tile:

1. **centroid score**: one full-f32 product against the (P, d) centroid
   table (``ops.distance.pairwise_sq_l2``, TF32 off), then the ``nprobe``
   nearest partitions by a stable sort (ties to the lowest partition, as
   ``lax.top_k`` gives them);
2. **probe gather**: whole padded buckets of each probed partition,
   ``(q_tile, nprobe · bucket_cap, ·)`` rows at rest with their ids and
   norms; a quantized store moves its code lanes and scales and is
   dequantized right after the gather;
3. **exact finish**: the shared ``ops.rerank.rerank_exact_topk``. Under
   ``precision_policy="mixed"`` a bf16-rounded product with f32 sums first
   keeps 4k of the gathered candidates (ids masked, the zero rule
   deferred), and only those reach the exact finish.

The finish widens its candidates to f64 (``ops/rerank.py``). At a real
deployment a query row gathers thousands of candidates, so the finish runs
over row chunks whose f64 copy stays under ``shapes.RERANK_CHUNK_BYTES``; a
row's result does not depend on the chunk or the tile it falls in, so a
served batch equals the one-shot search of the same rows bit for bit.

Bucket padding slots carry id −1, which ``mask_tile`` forces to +inf.
Every point lives in exactly one partition, so ``nprobe == partitions`` is
a full exact scan.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE
from mpi_knn_tpu_torch.ops.distance import bf16_round, center_rows, pairwise_sq_l2, sq_norms
from mpi_knn_tpu_torch.ops.quant import dequantize_rows
from mpi_knn_tpu_torch.ops.rerank import (
    mixed_applies,
    overfetch_width,
    rerank_exact_topk,
)
from mpi_knn_tpu_torch.ops.topk import mask_tile, preselect_smallest
from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple
from mpi_knn_tpu_torch.shapes import finish_rows, ivf_q_tile



def resident(index):
    """The arrays a batch reads: (centroids, centroid_sqs, buckets,
    bucket_ids, bucket_sqs, bucket_scales)."""
    return (index.centroids, index.centroid_sqs, index.buckets,
            index.bucket_ids, index.bucket_sqs, index.bucket_scales)


def compress_keys_batched(q_x, q_sq, rows, row_sqs):
    """Per-query compressed keys over gathered candidates: bf16-rounded
    operands, f32 sums (the batched ``ops.rerank.compress_tile``)."""
    xy = torch.einsum("qd,qvd->qv", bf16_round(q_x), bf16_round(rows))
    return q_sq[:, None] - 2.0 * xy + row_sqs


def finish_candidates(q_x, q_ids, q_sq, rows, ids, sqs, cfg: KNNConfig):
    """Stage-3 finish over (q, v, d) gathered candidates: the mixed
    policy's compress pass where it can drop anything, then the shared
    exact rerank top-k over row chunks."""
    v = ids.shape[1]
    if cfg.precision_policy == "mixed" and mixed_applies(cfg.k, v):
        keys = compress_keys_batched(q_x, q_sq, rows, sqs)
        keys = mask_tile(keys, ids,
                         query_ids=q_ids if cfg.exclude_self else None,
                         exclude_self=cfg.exclude_self, exclude_zero=False)
        pos = preselect_smallest(keys, overfetch_width(cfg.k, v))
        rows = torch.gather(rows, 1, pos[:, :, None].expand(-1, -1, rows.shape[2]))
        ids = torch.gather(ids, 1, pos)
    step = finish_rows(rows.shape[1], rows.shape[2])
    parts = [
        rerank_exact_topk(q_x[s:s + step], q_ids[s:s + step],
                          rows[s:s + step], ids[s:s + step], cfg.k,
                          metric="l2", exclude_self=cfg.exclude_self,
                          exclude_zero=cfg.exclude_zero,
                          zero_eps=cfg.zero_eps)
        for s in range(0, q_x.shape[0], step)
    ]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def score_centroids(q_x, centroids, centroid_sqs, nprobe: int):
    """Stage 1: full-f32 centroid score and the top-nprobe partitions.
    Returns (q_sq, (q, nprobe) partition ids)."""
    q_sq = sq_norms(q_x)
    cd = pairwise_sq_l2(q_x, centroids, x_sq=q_sq, y_sq=centroid_sqs)
    return q_sq, preselect_smallest(cd, nprobe)


def gather_probes(probe, buckets, bucket_ids, bucket_sqs, bucket_scales):
    """Stage 2: the probed buckets at rest, flattened to v = nprobe ·
    bucket_cap candidates a row: (rows, ids, sqs, scales or None)."""
    q, v = probe.shape[0], probe.shape[1] * buckets.shape[1]
    rows = buckets[probe].reshape(q, v, buckets.shape[2])
    ids = bucket_ids[probe].reshape(q, v)
    sqs = bucket_sqs[probe].reshape(q, v)
    scl = None if bucket_scales is None else bucket_scales[probe].reshape(q, v)
    return rows, ids, sqs, scl


def ivf_query_tile(q_x, q_ids, centroids, centroid_sqs, buckets, bucket_ids,
                   bucket_sqs, bucket_scales, cfg: KNNConfig, nprobe: int):
    """One query tile through the two-stage search → ((q_tile, k) dists
    ascending, ids). A quantized store (``cfg.dtype`` int8 / int4) gathers
    code lanes and scales and dequantizes them after the gather; the
    asymmetric distance (f32 queries, dequantized candidates) then takes
    the same finish as every other store."""
    q_x = q_x.to(torch.float32)
    q_sq, probe = score_centroids(q_x, centroids, centroid_sqs, nprobe)
    rows, ids, sqs, scl = gather_probes(probe, buckets, bucket_ids,
                                        bucket_sqs, bucket_scales)
    if scl is not None:
        rows = dequantize_rows(rows, scl, cfg.dtype, centroids.shape[1])
    return finish_candidates(q_x, q_ids, q_sq, rows.to(torch.float32), ids,
                             sqs, cfg)


def ivf_serve_chunk(q_tiles, qid_tiles, centroids, centroid_sqs, buckets,
                    bucket_ids, bucket_sqs, bucket_scales, cfg: KNNConfig,
                    nprobe: int):
    """One padded batch ((QT, q_tile, d) tiles) against the resident index:
    (QT, q_tile, k) dists and ids. The one-shot search and the serving
    engine both run it."""
    out = [ivf_query_tile(q_x, q_ids, centroids, centroid_sqs, buckets,
                          bucket_ids, bucket_sqs, bucket_scales, cfg, nprobe)
           for q_x, q_ids in zip(q_tiles, qid_tiles)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def ivf_query_shapes(cfg: KNNConfig, nprobe: int, bucket_cap: int, dim: int,
                     nq: int) -> tuple[int, int]:
    """(q_tile, q_pad) for an IVF batch (the JAX package's rule): the probe
    gather holds q_tile · nprobe · bucket_cap · dim elements, so q_tile
    halves until that fits ``cfg.max_tile_elems``; a single row past it is
    refused."""
    q_tile = ivf_q_tile(cfg, nprobe, bucket_cap, dim, nq)
    per_row = max(1, nprobe * bucket_cap * dim)
    if q_tile * per_row > cfg.max_tile_elems:
        raise ValueError(
            f"one query row's probe gather (nprobe={nprobe} × bucket_cap="
            f"{bucket_cap} × d={dim} = {per_row} elems) exceeds "
            f"max_tile_elems={cfg.max_tile_elems}; lower nprobe/partitions "
            "(bigger partitions mean bigger buckets), raise "
            "max_tile_elems, or use a dense backend for full scans"
        )
    return q_tile, pad_to_multiple(nq, q_tile)


def prepare_query_tiles(index, queries, query_ids, cfg: KNNConfig,
                        assume_centered: bool = False):
    """Center with the index's mean (f64 on the host for numpy queries, as
    the serving engine does), pad and tile one batch on the index's
    device. Returns (q_tiles, qid_tiles, q_pad, q_tile)."""
    nq = queries.shape[0]
    if query_ids is None:
        q_ids = np.full(nq, -1, dtype=np.int32)
    else:
        q_ids = np.asarray(query_ids, dtype=np.int32)
    q = (queries.to(index.device) if isinstance(queries, torch.Tensor)
         else np.asarray(queries))
    if cfg.center and index.mu is not None and not assume_centered:
        q = center_rows(q, index.mu)
    q_tile, q_pad = ivf_query_shapes(cfg, cfg.nprobe, index.bucket_cap,
                                     index.dim, nq)
    qt = q_pad // q_tile
    q_tiles = pad_rows_any(q, q_pad, dtype=torch.float32,
                           device=index.device).reshape(qt, q_tile, index.dim)
    qid_tiles = pad_rows_any(q_ids, q_pad, fill=-1,
                             device=index.device).reshape(qt, q_tile)
    return q_tiles, qid_tiles, q_pad, q_tile


def run_query_tiles(index, q_tiles, qid_tiles, cfg: KNNConfig):
    """The device half of :func:`search_ivf`: padded (QT, q_tile, k)
    results on the index's device (not synchronized)."""
    return ivf_serve_chunk(q_tiles, qid_tiles, *resident(index), cfg,
                           cfg.nprobe)


def search_ivf(index, queries, query_ids=None, config=None,
               assume_centered: bool = False, device=DEFAULT_DEVICE,
               **overrides):
    """One-shot query batch against an :class:`~mpi_knn_tpu_torch.ivf.
    index.IVFIndex`: center with its mean, tile, search, strip padding.
    Returns ((q, k) dists ascending, (q, k) ids) on the index's device,
    which ``device`` must name. ``assume_centered`` skips the centering
    for queries already in the index's centered frame (the nprobe tuner's
    held-out corpus rows)."""
    from mpi_knn_tpu_torch.serve.index import canonical_device

    if canonical_device(device) != index.device:
        raise ValueError(
            f"device={str(device)!r} but the index lives on {index.device}")
    cfg = index.compatible_cfg((config or index.cfg).replace(**overrides))
    nq = queries.shape[0]
    q_tiles, qid_tiles, q_pad, _ = prepare_query_tiles(
        index, queries, query_ids, cfg, assume_centered=assume_centered)
    d, i = run_query_tiles(index, q_tiles, qid_tiles, cfg)
    return d.reshape(q_pad, cfg.k)[:nq], i.reshape(q_pad, cfg.k)[:nq]
