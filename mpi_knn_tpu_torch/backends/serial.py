"""Serial (single-device) backend: the tile policy of the JAX package's
``backends/serial.py`` in plain PyTorch.

Query tiles are walked in a Python loop; inside each, corpus tiles are
either reduced to k survivors each and merged once ("twolevel") or merged
into the carry tile by tile ("stream"). Under the exact policy the product
is ``torch.matmul`` at full precision (ops/distance.py), as the JAX package
leaves it to XLA; under the mixed policy each tile's reduction is the
compress-and-rerank pipeline of ops/rerank.py. The ring backends merge
their blocks through the same functions.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.ops.distance import pairwise_dist, sq_norms
from mpi_knn_tpu_torch.ops.rerank import compress_rerank_tile
from mpi_knn_tpu_torch.ops.topk import (
    cascade_smallest_k,
    init_topk_tiles,
    mask_tile,
    smallest_k,
)
from mpi_knn_tpu_torch.parallel.partition import (
    make_global_ids,
    pad_rows_any,
    pad_to_multiple,
)

TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    if name not in TORCH_DTYPES:
        raise ValueError(f"dtype={name!r}: not supported by the dense backends")
    return TORCH_DTYPES[name]


def masked_dist_tile(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, cfg: KNNConfig):
    """(q_tile × c_tile) masked distances: metric, then padding/self/zero
    exclusion masks."""
    d = pairwise_dist(q_x, blk, metric=cfg.metric, x_sq=q_sq, y_sq=blk_sq)
    if cfg.metric == "l2" and q_sq is not None and blk_sq is not None:
        pair_scale = q_sq[:, None] + blk_sq[None, :]
    else:
        # cosine distances live in [0, 2]; constant scale for the zero test
        pair_scale = torch.tensor(2.0, dtype=d.dtype, device=d.device)
    return mask_tile(
        d,
        blk_ids,
        query_ids=q_ids if cfg.exclude_self else None,
        exclude_self=cfg.exclude_self,
        exclude_zero=cfg.exclude_zero,
        zero_eps=cfg.zero_eps,
        scale=pair_scale,
    )


def local_tile_topk(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, cfg, out_dtype):
    """One corpus tile's (q, k) survivors, per ``cfg.precision_policy``."""
    if cfg.precision_policy == "mixed":
        ld, li = compress_rerank_tile(q_x, q_ids, q_sq, blk, blk_ids, blk_sq,
                                      cfg)
        return ld.to(out_dtype), li
    d = masked_dist_tile(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, cfg)
    return smallest_k(d.to(out_dtype), blk_ids, cfg.k,
                      method=cfg.topk_method,
                      recall_target=cfg.recall_target, block=cfg.topk_block)


def knn_tile_step(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, carry_d, carry_i,
                  cfg: KNNConfig):
    """One (query_tile × corpus_tile) step merged into the carry. Under the
    mixed policy the tile is first reduced to k exact survivors."""
    if cfg.precision_policy == "mixed":
        ld, li = local_tile_topk(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, cfg,
                                 carry_d.dtype)
        all_d = torch.cat([carry_d, ld], dim=-1)
        all_i = torch.cat([carry_i, li], dim=-1)
    else:
        d = masked_dist_tile(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, cfg)
        all_d = torch.cat([carry_d, d.to(carry_d.dtype)], dim=-1)
        all_i = torch.cat([carry_i, blk_ids[None, :].expand(d.shape)], dim=-1)
    return smallest_k(all_d, all_i, cfg.k, method=cfg.topk_method,
                      recall_target=cfg.recall_target, block=cfg.topk_block)


def cascade_method(method: str) -> str:
    """The twolevel cascade's method: survivors of survivors merge exactly
    ("block" is exact) or recall decays multiplicatively, so "approx",
    "approx-rerank" and "bf16" run it as "exact", as the JAX package
    does."""
    return method if method in ("exact", "block") else "exact"


def merge_tiles_into_carry(q_x, q_ids, q_sq, tiles, tile_ids, tile_sqs,
                           carry_d, carry_i, cfg: KNNConfig):
    """Merge a stack of corpus tiles into one query tile's carry, per
    ``cfg.merge_schedule``: "twolevel" (k survivors per tile, one cascade
    merge over carry ‖ survivors) or "stream" (carry threaded through)."""
    if cfg.merge_schedule == "twolevel":
        parts = [
            local_tile_topk(q_x, q_ids, q_sq, blk, ids, sq, cfg, carry_d.dtype)
            for blk, ids, sq in zip(tiles, tile_ids, tile_sqs)
        ]
        return cascade_smallest_k(
            torch.cat([carry_d] + [p[0] for p in parts], dim=-1),
            torch.cat([carry_i] + [p[1] for p in parts], dim=-1),
            cfg.k,
            method=cascade_method(cfg.topk_method),
            block=cfg.topk_block,
        )
    for blk, ids, sq in zip(tiles, tile_ids, tile_sqs):
        carry_d, carry_i = knn_tile_step(
            q_x, q_ids, q_sq, blk, ids, sq, carry_d, carry_i, cfg
        )
    return carry_d, carry_i


def tile_sq_norms(tiles, metric: str):
    """(T, c_tile) squared norms of a tile stack (zeros for cosine, whose
    metric normalizes inside), tile by tile."""
    if metric == "l2":
        return torch.stack([sq_norms(t) for t in tiles])
    acc = torch.float64 if tiles.dtype == torch.float64 else torch.float32
    return torch.zeros(tiles.shape[:2], dtype=acc, device=tiles.device)


def knn_chunk_update(q_tiles, qid_tiles, chunk_tiles, chunk_ids, carry_d,
                     carry_i, cfg: KNNConfig):
    """Merge a chunk of corpus tiles into every query tile's carry."""
    return serve_chunk(q_tiles, qid_tiles, carry_d, carry_i, chunk_tiles,
                       chunk_ids, tile_sq_norms(chunk_tiles, cfg.metric), cfg)


def serve_chunk(q_tiles, qid_tiles, carry_d, carry_i, tiles, tile_ids,
                tile_sqs, cfg: KNNConfig):
    """One query batch ((QT, q_tile, d) tiles) against a resident tile
    stack whose ids and norms were computed once (a serving index):
    ``knn_chunk_update`` with the corpus-side work hoisted out, so the two
    cannot drift."""
    out_d, out_i = [], []
    for q_x, q_ids, cd, ci in zip(q_tiles, qid_tiles, carry_d, carry_i):
        q_sq = sq_norms(q_x) if cfg.metric == "l2" else None
        d, i = merge_tiles_into_carry(q_x, q_ids, q_sq, tiles, tile_ids,
                                      tile_sqs, cd, ci, cfg)
        out_d.append(d)
        out_i.append(i)
    return torch.stack(out_d), torch.stack(out_i)


def cap_corpus_tile(q_tile: int, c_tile: int, max_tile_elems: int) -> int:
    """Shrink c_tile until q_tile × c_tile <= max_tile_elems (rounded down
    to a 128 multiple while that keeps it >= 128)."""
    cap = max(1, max_tile_elems // max(q_tile, 1))
    if cap >= 128:
        cap = cap // 128 * 128
    return min(c_tile, cap)


def effective_tiles(cfg: KNNConfig, m: int, nq: int) -> tuple[int, int]:
    """Clamp configured tiles to the (aligned) problem size and to
    ``cfg.max_tile_elems``."""
    q_tile = min(cfg.query_tile, pad_to_multiple(nq, 8))
    c_tile = min(cfg.corpus_tile, pad_to_multiple(m, 128))
    return q_tile, cap_corpus_tile(q_tile, c_tile, cfg.max_tile_elems)


def prepare_tiles(corpus, queries, query_ids, cfg: KNNConfig, q_tile, c_tile,
                  device):
    """Pad and reshape corpus/query arrays into tile stacks on ``device``."""
    m, dim = corpus.shape
    nq = queries.shape[0]
    dtype = torch_dtype(cfg.dtype)
    c_pad = pad_to_multiple(m, c_tile)
    q_pad = pad_to_multiple(nq, q_tile)
    corpus_tiles = pad_rows_any(corpus, c_pad, dtype=dtype,
                                device=device).reshape(-1, c_tile, dim)
    corpus_tile_ids = torch.from_numpy(
        make_global_ids(m, c_pad).reshape(-1, c_tile)
    ).to(device)
    q_tiles = pad_rows_any(queries, q_pad, dtype=dtype,
                           device=device).reshape(-1, q_tile, dim)
    qid_tiles = pad_rows_any(np.asarray(query_ids, dtype=np.int32), q_pad,
                             fill=-1, device=device).reshape(-1, q_tile)
    return q_tiles, qid_tiles, corpus_tiles, corpus_tile_ids, q_pad


def all_knn_serial(corpus, queries, query_ids, cfg: KNNConfig, device):
    """Pad to tile multiples, run the tile loop, strip padding.
    Returns ((q, k) dists, (q, k) ids) on ``device``."""
    nq = queries.shape[0]
    q_tile, c_tile = effective_tiles(cfg, corpus.shape[0], nq)
    q_tiles, qid_tiles, corpus_tiles, corpus_tile_ids, q_pad = prepare_tiles(
        corpus, queries, query_ids, cfg, q_tile, c_tile, device
    )
    acc = torch.float64 if q_tiles.dtype == torch.float64 else torch.float32
    carry_d, carry_i = init_topk_tiles(q_pad // q_tile, q_tile, cfg.k,
                                       dtype=acc, device=device)
    best_d, best_i = knn_chunk_update(q_tiles, qid_tiles, corpus_tiles,
                                      corpus_tile_ids, carry_d, carry_i, cfg)
    return (best_d.reshape(q_pad, cfg.k)[:nq],
            best_i.reshape(q_pad, cfg.k)[:nq])
