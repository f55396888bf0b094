"""Bounded top-k maintenance on torch tensors.

Selection is a *stable* ascending sort, so equal distances keep column
order: ties go to the leftmost column, exactly as ``lax.top_k`` gives them
in the JAX package (``torch.topk`` makes no promise about ties). Every
result is ordered by (distance, column), and +inf slots carry
``INVALID_ID``.

Methods, as in the JAX package: "exact" (one sort); "block" (exact
two-level reduction through per-block sorts); "bf16" (4k preselected by a
stable sort of bf16-rounded keys, then an exact f32 finish: near-exact,
and equal bit for bit to the JAX package's); "approx" (the TPU's partial
reduction ``lax.approx_min_k`` asked for k directly) and "approx-rerank"
(the same reduction preselecting 4k winners for an exact finish), both
one call of ``ops/approx_topk.approx_smallest_k``, whose Hopper kernel is
the bin minimum with the id gather and mask in its epilogue.
"""

from __future__ import annotations

import torch

from mpi_knn_tpu_torch.config import TOPK_METHODS
from mpi_knn_tpu_torch.ops.approx_topk import approx_smallest_k
from mpi_knn_tpu_torch.types import INVALID_ID

_INF = float("inf")
# relative tolerance for "numerically zero" squared distances (see the JAX
# package's ops/topk.py): ~5x the measured f32 cancellation error of the
# matmul form, far below genuine neighbor distances on centered data
_ZERO_RTOL = {torch.float64: 1e-12}
_ZERO_RTOL_DEFAULT = 1e-6


def init_topk(num_queries: int, k: int, dtype=torch.float32, device=None):
    """Empty carry: all-inf distances, invalid ids."""
    d = torch.full((num_queries, k), _INF, dtype=dtype, device=device)
    i = torch.full((num_queries, k), INVALID_ID, dtype=torch.int32, device=device)
    return d, i


def init_topk_tiles(num_tiles, tile_rows, k, dtype=torch.float32, device=None):
    """``init_topk`` shaped to a (num_tiles, tile_rows, k) query-tile stack."""
    d, i = init_topk(num_tiles * tile_rows, k, dtype=dtype, device=device)
    return d.reshape(num_tiles, tile_rows, k), i.reshape(num_tiles, tile_rows, k)


def _pad_cols(dists, ids, width: int):
    pad = width - dists.shape[-1]
    if pad > 0:
        q = dists.shape[0]
        dists = torch.cat(
            [dists, dists.new_full((q, pad), _INF)], dim=-1
        )
        ids = torch.cat([ids, ids.new_full((q, pad), INVALID_ID)], dim=-1)
    return dists, ids


def _sorted_k(dists, ids, k: int):
    """k smallest along the last axis by a stable ascending sort."""
    vals, pos = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], torch.gather(ids, -1, pos[..., :k])


def _fold_topk(dists, ids, k: int, width: int):
    """Fold (q, c) candidate rows into (q, ceil(c/width)·k) by a per-chunk
    top-k; exact, since every global top-k element survives its chunk."""
    q, c = dists.shape
    nch = -(-c // width)
    dists, ids = _pad_cols(dists, ids, nch * width)
    vals, out_ids = _sorted_k(
        dists.reshape(q, nch, width), ids.reshape(q, nch, width), k
    )
    return vals.reshape(q, nch * k), out_ids.reshape(q, nch * k)


def preselect_smallest(dists, n: int, half_width: bool = False):
    """Column positions of each row's ``n`` smallest entries: the positions
    ``lax.top_k(-dists, n)`` gives in the JAX package — ascending, ties to
    the leftmost column, and once the finite entries run out the +inf
    columns in index order (a stable sort hands them out that way). With
    ``half_width`` the f32 keys are rounded to bf16 first (monotone in the
    values they round from); the positions index the original columns."""
    if half_width and dists.dtype == torch.float32:
        dists = dists.to(torch.bfloat16)
    return torch.sort(dists, dim=-1, stable=True).indices[..., :n]


def smallest_k(dists, ids, k: int, method: str = "exact",
               recall_target: float = 0.95, block: int = 128):
    """Per-row k smallest entries of a (q, c) tile, by ``method`` (see the
    module's docstring; ``recall_target`` sizes the approximate methods'
    reduction).

    ids: (c,) or (q, c) int32 global candidate ids. If k > c the result is
    padded with (+inf, -1). Returns (q, k) dists ascending, (q, k) ids.
    """
    if method not in TOPK_METHODS:
        raise ValueError(f"topk method must be one of {TOPK_METHODS}, got {method!r}")
    q, c = dists.shape
    if (method == "approx" and c > k) or (method == "approx-rerank" and c > 4 * k):
        # the lane padding, the bin minimum (for approx-rerank the L(4k)
        # winners' exact finish), the id gather and the mask: one launch
        return approx_smallest_k(dists, ids, k, method, recall_target)
    if ids.ndim == 1:
        ids = ids[None, :].expand(q, c)
    if k > c:
        dists, ids = _pad_cols(dists, ids, k)
        c = k
    if method == "block" and k <= block and c > block:
        dists, ids = _fold_topk(dists, ids, k, block)
        c = dists.shape[-1]
    if method == "bf16" and c > 4 * k and dists.dtype == torch.float32:
        pos = preselect_smallest(dists, 4 * k, half_width=True)
        dists = torch.gather(dists, -1, pos)
        ids = torch.gather(ids, -1, pos)
        c = 4 * k
    vals, out_ids = _sorted_k(dists, ids, k)
    # slots that hold +inf are by definition invalid
    out_ids = torch.where(torch.isinf(vals), INVALID_ID, out_ids)
    return vals, out_ids


def cascade_smallest_k(dists, ids, k: int, method: str = "exact",
                       recall_target: float = 0.95, block: int = 128,
                       max_width: int = 8192):
    """``smallest_k`` for arbitrarily wide rows: fold by per-chunk top-k
    while wider than ``max_width``, then one narrow ``smallest_k``."""
    q, c = dists.shape
    if ids.ndim == 1:
        ids = ids[None, :].expand(q, c)
    fold_w = max(max_width, 2 * k)
    while dists.shape[-1] > fold_w:
        dists, ids = _fold_topk(dists, ids, k, fold_w)
    return smallest_k(dists, ids, k, method=method,
                      recall_target=recall_target, block=block)


def merge_topk(carry_d, carry_i, new_d, new_i, method: str = "exact",
               recall_target: float = 0.95, block: int = 128):
    """Merge two per-query top-k lists: top-k over the concatenation."""
    k = carry_d.shape[-1]
    d = torch.cat([carry_d, new_d], dim=-1)
    i = torch.cat([carry_i, new_i], dim=-1)
    return smallest_k(d, i, k, method=method, recall_target=recall_target,
                      block=block)


def mask_tile(dists, cand_ids, query_ids=None, exclude_self: bool = True,
              exclude_zero: bool = True, zero_eps: float = 0.0, scale=None):
    """Apply validity/exclusion masks to a (q, c) distance tile: padding
    (id < 0), self by id, and zero distance by value (absolute ``zero_eps``
    if > 0, else ``rtol · scale``, else ``d <= 0``) become +inf."""
    q, c = dists.shape
    if cand_ids.ndim == 1:
        cand_ids = cand_ids[None, :].expand(q, c)
    invalid = cand_ids < 0
    if exclude_zero:
        if zero_eps > 0.0:
            thresh = zero_eps
        elif scale is not None:
            thresh = _ZERO_RTOL.get(dists.dtype, _ZERO_RTOL_DEFAULT) * scale
        else:
            thresh = 0.0
        invalid = invalid | (dists <= thresh)
    if exclude_self and query_ids is not None:
        invalid = invalid | (cand_ids == query_ids[:, None])
    return torch.where(invalid, _INF, dists)
