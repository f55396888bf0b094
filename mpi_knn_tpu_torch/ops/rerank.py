"""The mixed precision policy's compress-and-rerank pipeline
(``KNNConfig.precision_policy="mixed"``): the JAX package's
``ops/rerank.py`` in plain PyTorch.

- **compress**: a tile's distances from a product of bf16-rounded operands
  accumulated in f32 (the norms come from the unrounded f32 rows); an
  overfetch of ``4k`` columns per query survives a stable top-4k of these
  keys. Padding and self are masked by id; the zero rule is not applied to
  rounded keys.
- **rerank**: the survivors' rows are gathered and their distances
  recomputed exactly, the full mask semantics applied to the exact values,
  then the exact top-k.

The rerank computes ``q²``, ``c²`` and ``q·c`` in float64 from the f32
rows and rounds the distance to f32 once. Products of f32 values are exact
in f64, so a duplicate row comes out at ~1e-13 of ``q² + c²`` whatever
order the sums run in, far under the 1e-6 zero threshold; an f32 sum in
another order than its dot can miss that threshold at D=784. On data whose
f32 sums are exact (small integers) the result equals the JAX package's
bit for bit.
"""

from __future__ import annotations

import torch

from mpi_knn_tpu_torch.ops.distance import (
    _NORM_EPS,
    _l2_normalize,
    pairwise_dist,
    sq_norms,
)
from mpi_knn_tpu_torch.ops.topk import mask_tile, preselect_smallest, smallest_k

# the compress pass keeps 4k candidates per query (the TPU-KNN operating
# point, as in the JAX package)
OVERFETCH_FACTOR = 4


def overfetch_width(k: int, c: int) -> int:
    """Candidates the compress pass keeps per query from a c-wide tile."""
    return min(OVERFETCH_FACTOR * k, c)


def mixed_applies(k: int, c: int) -> bool:
    """Whether compress can drop anything on a c-wide tile; if not, the
    policy degenerates to one exact pass."""
    return overfetch_width(k, c) < c


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (half to even) and widen back: a bf16 x bf16 product
    is exact in f32, so an f32 product of these is the bf16 dot with f32
    accumulation."""
    return x.to(torch.bfloat16).to(torch.float32)


def compress_tile(q_x, blk, q_sq=None, blk_sq=None, metric: str = "l2"):
    """Pass-1 (q, c) keys, unclamped: bf16-rounded operands, f32 sums."""
    if metric == "l2":
        if q_sq is None:
            q_sq = sq_norms(q_x)
        if blk_sq is None:
            blk_sq = sq_norms(blk)
        xy = torch.matmul(bf16_round(q_x), bf16_round(blk).T)
        return q_sq[:, None] - 2.0 * xy + blk_sq[None, :]
    sim = torch.matmul(bf16_round(_l2_normalize(q_x)),
                       bf16_round(_l2_normalize(blk)).T)
    return 1.0 - sim


def exact_candidate_dists(q_x, q_ids, cand_rows, cand_ids,
                          metric: str = "l2", exclude_self: bool = True,
                          exclude_zero: bool = True, zero_eps: float = 0.0):
    """The rerank's products: (q, v) exact distances of gathered candidates
    with the full mask semantics applied (masked slots +inf).

    q_x (q, d) queries, q_ids (q,) or None, cand_rows (q, v, d) f32,
    cand_ids (q, v) (< 0 = invalid slot)."""
    if metric == "l2":
        q64 = q_x.to(torch.float64)
        c64 = cand_rows.to(torch.float64)
        xy = torch.einsum("qd,qvd->qv", q64, c64)
        q_sq = (q64 * q64).sum(-1)[:, None]
        c_sq = (c64 * c64).sum(-1)
        d = torch.clamp_min(q_sq - 2.0 * xy + c_sq, 0.0).to(torch.float32)
        pair_scale = (q_sq + c_sq).to(torch.float32)
    elif metric == "cosine":
        qn = _l2_normalize(q_x)
        cf = cand_rows.to(torch.float32)
        n = torch.sqrt(torch.clamp_min((cf * cf).sum(-1), _NORM_EPS))
        sim = torch.einsum("qd,qvd->qv", qn, cf / n[..., None])
        d = torch.clamp_min(1.0 - sim, 0.0)
        pair_scale = torch.tensor(2.0, dtype=d.dtype, device=d.device)
    else:
        raise ValueError(f"unknown metric {metric!r}")
    return mask_tile(d, cand_ids, query_ids=q_ids if exclude_self else None,
                     exclude_self=exclude_self, exclude_zero=exclude_zero,
                     zero_eps=zero_eps, scale=pair_scale)


def rerank_exact_topk(q_x, q_ids, cand_rows, cand_ids, k: int,
                      metric: str = "l2", exclude_self: bool = True,
                      exclude_zero: bool = True, zero_eps: float = 0.0):
    """Pass-2 exact finish over gathered survivors: their exact masked
    distances (:func:`exact_candidate_dists`), then the exact top-k.
    Returns ((q, k) dists ascending, (q, k) ids), the contract of
    ``smallest_k`` over an exact masked tile.
    """
    d = exact_candidate_dists(q_x, q_ids, cand_rows, cand_ids, metric=metric,
                              exclude_self=exclude_self,
                              exclude_zero=exclude_zero, zero_eps=zero_eps)
    return smallest_k(d, cand_ids, k, method="exact")


def compress_rerank_tile(q_x, q_ids, q_sq, blk, blk_ids, blk_sq, cfg):
    """The whole two-pass reduction of one (q, c) tile to (q, k); one exact
    pass when the tile is too narrow for the overfetch to drop anything."""
    c = blk.shape[0]
    k = cfg.k
    if not mixed_applies(k, c):
        d = pairwise_dist(q_x, blk, metric=cfg.metric, x_sq=q_sq, y_sq=blk_sq)
        if cfg.metric == "l2" and q_sq is not None and blk_sq is not None:
            pair_scale = q_sq[:, None] + blk_sq[None, :]
        else:
            pair_scale = torch.tensor(2.0, dtype=d.dtype, device=d.device)
        d = mask_tile(d, blk_ids,
                      query_ids=q_ids if cfg.exclude_self else None,
                      exclude_self=cfg.exclude_self,
                      exclude_zero=cfg.exclude_zero, zero_eps=cfg.zero_eps,
                      scale=pair_scale)
        return smallest_k(d, blk_ids, k, method="exact")
    d_lo = compress_tile(q_x, blk, q_sq, blk_sq, metric=cfg.metric)
    d_lo = mask_tile(d_lo, blk_ids,
                     query_ids=q_ids if cfg.exclude_self else None,
                     exclude_self=cfg.exclude_self, exclude_zero=False)
    pos = preselect_smallest(d_lo, overfetch_width(k, c))  # (q, 4k)
    return rerank_exact_topk(q_x, q_ids, blk[pos], blk_ids[pos], k,
                             metric=cfg.metric,
                             exclude_self=cfg.exclude_self,
                             exclude_zero=cfg.exclude_zero,
                             zero_eps=cfg.zero_eps)
