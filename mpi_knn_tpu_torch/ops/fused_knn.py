"""Fused squared-L2 distance + top-k: the wrappers of the two Hopper kernels
in ``csrc/fused_knn.cu`` and their plain PyTorch versions.

- ``fused_knn_tiles`` (replaces ``mpi_knn_tpu/ops/pallas_knn.py::
  fused_knn_tiles``): each (query, corpus-tile) pair's k survivors, returned
  as (Q, n_c·k) candidate lists for one cross-tile merge outside the kernel.
- ``fused_knn_sweep`` (replaces ``...::fused_knn_sweep``): the final (Q, k)
  of the whole corpus sweep, merged inside the kernel.

Both order candidates by (distance, global id) and apply the masks of the
JAX kernels' ``_masked_tile_dists``: padding columns (id >= m_corpus), zero
distance (``d <= zero_eps`` if > 0, else ``d <= 1e-6·(q²+c²)``) and, in
all-pairs mode, self. Non-finite slots carry id −1; a row with a NaN
distance comes out as (NaN, −1) throughout.

``compress=True`` is the mixed policy's pass 1, as in the JAX kernels: the
dot runs on bf16-rounded operands with f32 sums, the norms come from the
unrounded rows, the zero mask is off (padding and self stay), and the
caller asks for the overfetch width as k.

A wrapper takes its plain version only because the tensors it was given lie
on the CPU. For CUDA tensors it launches the kernel or raises. Each launch
adds one to ``LAUNCHES[name]``, the name carrying ``[compress]`` in that
mode.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.ops.distance import _mm_t, sq_norms
from mpi_knn_tpu_torch.ops.rerank import bf16_round
from mpi_knn_tpu_torch.types import INVALID_ID

_ZERO_RTOL = 1e-6  # the f32 zero-exclusion rtol (ops/topk.py)

LAUNCHES = {"fused_knn_tiles": 0, "fused_knn_sweep": 0,
            "fused_knn_tiles[compress]": 0, "fused_knn_sweep[compress]": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, with its C signatures set once at first load."""
    lib = _build.load("fused_knn")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32]
    flags = [i32, i32, i32, i32, ctypes.c_float, ptr]
    lib.fused_knn_tiles_launch.argtypes = common + [i32] + flags
    lib.fused_knn_sweep_launch.argtypes = common + flags
    lib.fused_knn_tiles_launch.restype = i32
    lib.fused_knn_sweep_launch.restype = i32
    return lib


def _check(queries, corpus, k, q_tile, c_tile):
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if queries.device != corpus.device:
        raise ValueError(
            f"queries on {queries.device}, corpus on {corpus.device}"
        )
    if queries.shape[1] != corpus.shape[1]:
        raise ValueError("queries and corpus differ in width")
    Q, C = queries.shape[0], corpus.shape[0]
    if Q % q_tile or C % c_tile:
        raise ValueError("caller must pad to tile multiples")
    if not 1 <= k <= c_tile:
        raise ValueError(f"k={k} must be in [1, corpus_tile={c_tile}]")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")


def _launch(fn, name, queries, corpus, out_shape, *args):
    out_d = torch.empty(out_shape, dtype=torch.float32, device=queries.device)
    out_i = torch.empty(out_shape, dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            queries.data_ptr(), corpus.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), queries.shape[0], corpus.shape[0],
            queries.shape[1], *args, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out_d, out_i


def _name(base: str, compress: bool) -> str:
    return base + "[compress]" if compress else base


def fused_knn_tiles(queries, corpus, m_corpus: int, k: int, q_tile: int,
                    c_tile: int, exclude_self: bool = True,
                    exclude_zero: bool = True, all_pairs: bool = True,
                    zero_eps: float = 0.0, compress: bool = False):
    """Per-(query, corpus-tile) local top-k -> (Q, n_c·k) dists and ids."""
    _check(queries, corpus, k, q_tile, c_tile)
    Q, C = queries.shape[0], corpus.shape[0]
    n_c = C // c_tile
    if queries.device.type == "cpu":
        outd, outi = _tiles_plain(queries, corpus, m_corpus, k, c_tile,
                                  exclude_self, exclude_zero, all_pairs,
                                  zero_eps, compress)
    else:
        outd, outi = _launch(
            _lib().fused_knn_tiles_launch, _name("fused_knn_tiles", compress),
            queries, corpus, (n_c, Q, k), m_corpus, k, c_tile,
            int(exclude_self), int(exclude_zero), int(all_pairs),
            int(compress), float(zero_eps),
        )
    return _candidate_lists(outd, outi)


def fused_knn_sweep(queries, corpus, m_corpus: int, k: int, q_tile: int,
                    c_tile: int, exclude_self: bool = True,
                    exclude_zero: bool = True, all_pairs: bool = True,
                    zero_eps: float = 0.0, compress: bool = False):
    """Full fused all-kNN: the final (Q, k) dists and ids. The kernel
    picks its own query sub-tile; the result does not depend on tiling."""
    _check(queries, corpus, k, q_tile, c_tile)
    if queries.device.type == "cpu":
        return fused_knn_sweep_reference(
            queries, corpus, m_corpus, k, q_tile, c_tile, exclude_self,
            exclude_zero, all_pairs, zero_eps, compress,
        )
    return _launch(
        _lib().fused_knn_sweep_launch, _name("fused_knn_sweep", compress),
        queries, corpus, (queries.shape[0], k), m_corpus, k,
        int(exclude_self), int(exclude_zero), int(all_pairs), int(compress),
        float(zero_eps),
    )


# ---------------------------------------------------------------- plain

def _candidate_lists(outd, outi):
    """(n_c, Q, k) -> (Q, n_c·k), corpus tiles in id order."""
    n_c, Q, k = outd.shape
    return (
        outd.transpose(0, 1).reshape(Q, n_c * k),
        outi.transpose(0, 1).reshape(Q, n_c * k),
    )


def _masked_tile(queries, q_sq, tile, col0, m_corpus, exclude_self,
                 exclude_zero, all_pairs, zero_eps, compress=False):
    """(Q, c) masked squared-L2 distances of one corpus tile + its ids."""
    c_sq = sq_norms(tile)
    xy = (_mm_t(bf16_round(queries), bf16_round(tile)) if compress
          else _mm_t(queries, tile))
    d = torch.clamp_min(q_sq[:, None] - 2.0 * xy + c_sq[None, :], 0.0)
    col = col0 + torch.arange(tile.shape[0], device=tile.device,
                              dtype=torch.int32)
    invalid = (col >= m_corpus)[None, :].expand_as(d)
    if exclude_zero and not compress:
        thresh = (zero_eps if zero_eps > 0.0
                  else _ZERO_RTOL * (q_sq[:, None] + c_sq[None, :]))
        invalid = invalid | (d <= thresh)
    if exclude_self and all_pairs:
        row = torch.arange(queries.shape[0], device=tile.device,
                           dtype=torch.int32)
        invalid = invalid | (col[None, :] == row[:, None])
    return torch.where(invalid, float("inf"), d), col[None, :].expand_as(d)


def _select(d, ids, k):
    """k smallest by (distance, column) through a stable sort; non-finite
    slots get id −1 and rows holding a NaN become (NaN, −1)."""
    vals, pos = torch.sort(d, dim=-1, stable=True)
    vals, out_i = vals[:, :k], torch.gather(ids, 1, pos[:, :k])
    out_i = torch.where(torch.isfinite(vals), out_i, INVALID_ID)
    poisoned = torch.isnan(d).any(dim=1, keepdim=True)
    vals = torch.where(poisoned, float("nan"), vals)
    out_i = torch.where(poisoned, INVALID_ID, out_i)
    return vals, out_i


def _tile_topks(queries, corpus, m_corpus, k, c_tile, exclude_self,
                exclude_zero, all_pairs, zero_eps, compress):
    q_sq = sq_norms(queries)
    for col0 in range(0, corpus.shape[0], c_tile):
        d, ids = _masked_tile(queries, q_sq, corpus[col0:col0 + c_tile],
                              col0, m_corpus, exclude_self, exclude_zero,
                              all_pairs, zero_eps, compress)
        yield _select(d, ids, k)


def _tiles_plain(queries, corpus, m_corpus, k, c_tile, exclude_self,
                 exclude_zero, all_pairs, zero_eps, compress):
    parts = list(_tile_topks(queries, corpus, m_corpus, k, c_tile,
                             exclude_self, exclude_zero, all_pairs, zero_eps,
                             compress))
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def fused_knn_tiles_reference(queries, corpus, m_corpus, k, q_tile, c_tile,
                              exclude_self=True, exclude_zero=True,
                              all_pairs=True, zero_eps=0.0, compress=False):
    """Plain PyTorch version of ``fused_knn_tiles`` (any device)."""
    _check(queries, corpus, k, q_tile, c_tile)
    return _candidate_lists(*_tiles_plain(
        queries, corpus, m_corpus, k, c_tile, exclude_self, exclude_zero,
        all_pairs, zero_eps, compress,
    ))


def fused_knn_sweep_reference(queries, corpus, m_corpus, k, q_tile, c_tile,
                              exclude_self=True, exclude_zero=True,
                              all_pairs=True, zero_eps=0.0, compress=False):
    """Plain PyTorch version of ``fused_knn_sweep`` (any device): the carry
    is merged carry-first with each tile's survivors."""
    _check(queries, corpus, k, q_tile, c_tile)
    carry = None
    for new_d, new_i in _tile_topks(queries, corpus, m_corpus, k, c_tile,
                                    exclude_self, exclude_zero, all_pairs,
                                    zero_eps, compress):
        if carry is None:
            carry = (new_d, new_i)
        else:
            carry = _select(torch.cat([carry[0], new_d], dim=1),
                            torch.cat([carry[1], new_i], dim=1), k)
    return carry
