"""Bounded top-k maintenance on torch tensors.

Selection is a *stable* ascending sort, so equal distances keep column
order: ties go to the leftmost column, exactly as ``lax.top_k`` gives them
in the JAX package (``torch.topk`` makes no promise about ties). Every
result is ordered by (distance, column), and +inf slots carry
``INVALID_ID``.

Methods: "exact" (one sort) and "block" (exact two-level reduction through
per-block sorts). The JAX package's "approx", "approx-rerank" and "bf16"
methods are refused by ``config.KNNConfig`` (not yet ported).
"""

from __future__ import annotations

import torch

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


def preselect_smallest(dists, n: int):
    """Column positions of each row's ``n`` smallest entries: the positions
    ``lax.top_k(-dists, n)`` gives in the JAX package — ascending, ties to
    the leftmost column, and once the finite entries run out the +inf
    columns in index order (a stable sort hands them out that way)."""
    return torch.sort(dists, dim=-1, stable=True).indices[..., :n]


def smallest_k(dists, ids, k: int, method: str = "exact", block: int = 128):
    """Per-row k smallest entries of a (q, c) tile.

    ids: (c,) or (q, c) int32 global candidate ids. If k > c the result is
    padded with (+inf, -1). Returns (q, k) dists ascending, (q, k) ids.
    """
    if method not in ("exact", "block"):
        raise ValueError(f"topk_method={method!r}: not yet ported")
    q, c = dists.shape
    if ids.ndim == 1:
        ids = ids[None, :].expand(q, c)
    if k > c:
        dists, ids = _pad_cols(dists, ids, k)
        c = k
    if method == "block" and k <= block and c > block:
        dists, ids = _fold_topk(dists, ids, k, block)
    vals, out_ids = _sorted_k(dists, ids, k)
    # slots that hold +inf are by definition invalid
    out_ids = torch.where(torch.isinf(vals), INVALID_ID, out_ids)
    return vals, out_ids


def cascade_smallest_k(dists, ids, k: int, method: str = "exact",
                       block: int = 128, max_width: int = 8192):
    """``smallest_k`` for arbitrarily wide rows: fold by per-chunk top-k
    while wider than ``max_width``, then one narrow ``smallest_k``."""
    q, c = dists.shape
    if ids.ndim == 1:
        ids = ids[None, :].expand(q, c)
    fold_w = max(max_width, 2 * k)
    while dists.shape[-1] > fold_w:
        dists, ids = _fold_topk(dists, ids, k, fold_w)
    return smallest_k(dists, ids, k, method=method, block=block)


def merge_topk(carry_d, carry_i, new_d, new_i, method: str = "exact",
               block: int = 128):
    """Merge two per-query top-k lists: top-k over the concatenation."""
    k = carry_d.shape[-1]
    d = torch.cat([carry_d, new_d], dim=-1)
    i = torch.cat([carry_i, new_i], dim=-1)
    return smallest_k(d, i, k, method=method, block=block)


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
