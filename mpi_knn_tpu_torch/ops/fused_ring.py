"""The ring block merge (``ring_fusion="fused"``): the wrappers of the two
Hopper kernels in ``csrc/fused_ring.cu``, their plain PyTorch versions, and
the mixed policy's finish around the compress kernel.

``fused_block_merge`` replaces ``mpi_knn_tpu/ops/pallas_ring.py::
fused_block_merge``: one resident ring block (at its wire type: f32, bf16,
or int8 codes with per-row scales) merged into the (q_local, k) carry.

- exact policy, or mixed where the overfetch cannot drop anything:
  ``block_merge_exact`` (K3a) returns the merged carry. Candidates rank by
  (distance, arrival): the carry's slots first, then the block's columns
  in order, which is the reference's concat(carry ‖ block tile) with ties
  to the leftmost column. Any NaN among a row's candidates makes the row
  (NaN, −1). On the card the kernel takes the squared norms of the queries
  and of the decoded block from the exact prologue (``stage_wire_norms``:
  once per call for the queries, once per block, which then carries them
  as it travels); the products run as three TF32 passes of split operands
  on the tensor cores.
- mixed policy: ``block_merge_compress`` (K3b) returns each block tile's
  top-ov column positions by unclamped compressed key (untaken columns in
  index order once the finite keys run out; a NaN key counts as +inf).
  On the card it is the staging prologue (``stage_wire_rows``: bf16 copies
  of the queries and of the block decoded from its wire, and their f32
  norms) and then the bf16 tensor-core kernel on the copies
  (``block_merge_compress_staged``).
  The survivors' gather, the exact rerank and the carry merge then run in
  torch, tile after tile, one chunk of query rows at a time, so no
  (q_local, ov, d) gather is ever made whole.

A kernel wrapper takes its plain version only because the tensors it was
given lie on the CPU; for CUDA tensors it launches the kernel or raises.
Each launch adds one to ``LAUNCHES[name]``; the prologues' names are
``stage_tf32[wire]`` and ``stage_bf16[wire]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.ops.distance import _mm_t, sq_norms
from mpi_knn_tpu_torch.ops.fused_knn import (
    _ZERO_RTOL,
    _select,
    stage_bf16_rows_reference,
    staged_width,
)
from mpi_knn_tpu_torch.ops.quant import dequantize_rows
from mpi_knn_tpu_torch.ops.rerank import (
    mixed_applies,
    overfetch_width,
    rerank_exact_topk,
)
from mpi_knn_tpu_torch.ops.topk import preselect_smallest, smallest_k

LAUNCHES = {"fused_block_merge[exact]": 0, "fused_block_merge[compress]": 0,
            "stage_tf32[wire]": 0, "stage_bf16[wire]": 0}

_WIRE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# query rows per step of the plain versions and of the mixed finish, sized
# so a step's temporaries stay near a gigabyte at D=784
_PLAIN_ROWS = 8192
_FINISH_BYTES = 1 << 30


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, with its C signatures set once at first load."""
    lib = _build.load("fused_ring")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    out = ctypes.POINTER(i32)
    lib.block_merge_exact_launch.argtypes = (
        [ptr] * 11 + [i32] * 8 + [ctypes.c_float, ptr])
    lib.block_merge_exact_plan.argtypes = [i32] * 3 + [out] * 5
    lib.block_merge_compress_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
    lib.stage_bf16_wire_launch.argtypes = [ptr, ptr, i32, ptr, ptr] + [i32] * 3 + [ptr]
    lib.stage_tf32_wire_launch.argtypes = [ptr, ptr, i32, ptr, i32, i32, ptr]
    lib.compress_kernel_info.argtypes = [i32] + [out] * 3
    for fn in (lib.block_merge_exact_launch, lib.block_merge_exact_plan,
               lib.block_merge_compress_launch, lib.stage_bf16_wire_launch,
               lib.stage_tf32_wire_launch, lib.compress_kernel_info):
        fn.restype = i32
    return lib


def _check(queries, query_ids, block, block_ids, block_scale):
    dev = queries.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if queries.dtype != torch.float32 or queries.ndim != 2:
        raise TypeError("queries must be a 2-D float32 tensor")
    if block.dtype not in _WIRE or block.ndim != 2:
        raise TypeError(f"block must be 2-D float32/bfloat16/int8, got {block.dtype}")
    if block.shape[1] != queries.shape[1]:
        raise ValueError("queries and block differ in width")
    if (block.dtype == torch.int8) != (block_scale is not None):
        raise ValueError("an int8 block needs its per-row scales, and only it")
    for name, t, n in (("query_ids", query_ids, queries.shape[0]),
                       ("block_ids", block_ids, block.shape[0])):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise TypeError(f"{name} must be int32 of shape ({n},)")
    tensors = [queries, query_ids, block, block_ids]
    if block_scale is not None:
        if block_scale.dtype != torch.float32 or block_scale.shape != (block.shape[0],):
            raise TypeError("block_scale must be float32 of shape (b,)")
        tensors.append(block_scale)
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _wire_rows(block, block_scale):
    """The block as f32 rows: dequantized, widened, or as is."""
    if block.dtype == torch.int8:
        return dequantize_rows(block, block_scale)
    return block.to(torch.float32)


# ---------------------------------------------------------------- K3a

def merges_exactly(cfg, c_tile: int) -> bool:
    """Whether ``fused_block_merge`` runs K3a (the exact policy, or the
    mixed policy's degenerate tile), which takes the exact prologue's
    norms."""
    return not (cfg.precision_policy == "mixed" and mixed_applies(cfg.k, c_tile))


def stage_wire_norms(rows, scale):
    """The exact prologue on a row set at its wire type (f32, bf16, or int8
    codes with their (n,) scales) -> (n,) f32 squared norms of the decoded
    rows, on the card by the exact tile's product sequence."""
    n, d = rows.shape
    if rows.device.type == "cpu":
        return stage_wire_norms_reference(rows, scale)
    norms = torch.empty(n, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().stage_tf32_wire_launch(
            rows.data_ptr(), scale.data_ptr() if scale is not None else None,
            _WIRE[rows.dtype], norms.data_ptr(), n, d, stream)
    _rc(rc, "stage_tf32[wire]")
    return norms


def stage_wire_norms_reference(rows, scale):
    """Plain version of the exact prologue on a wire (any device)."""
    return sq_norms(_wire_rows(rows, scale))


def _norms(t, want):
    if t.dtype != torch.float32 or t.shape != (want.shape[0],) or \
            t.device != want.device or not t.is_contiguous():
        raise TypeError(f"norms must be contiguous float32 ({want.shape[0]},) "
                        f"on {want.device}")
    return t


def block_merge_exact(queries, query_ids, block, block_ids, block_scale,
                      carry_d, carry_i, *, c_tile: int,
                      exclude_self: bool = True, exclude_zero: bool = True,
                      zero_eps: float = 0.0, query_norms=None,
                      block_norms=None):
    """The exact merge of one block into the carry -> (q_local, k). On the
    card ``query_norms`` / ``block_norms`` are the exact prologue's
    (``stage_wire_norms``); each that is None is staged here."""
    _check(queries, query_ids, block, block_ids, block_scale)
    Q, k = carry_d.shape
    if carry_d.dtype != torch.float32 or carry_i.dtype != torch.int32 or \
            carry_i.shape != (Q, k) or Q != queries.shape[0]:
        raise TypeError("carry must be (q_local, k) float32 and int32")
    if carry_d.device != queries.device or carry_i.device != queries.device:
        raise ValueError(f"carry on {carry_d.device}, queries on {queries.device}")
    if block.shape[0] % c_tile:
        raise ValueError("caller must pad the block to a c_tile multiple")
    if queries.device.type == "cpu":
        return block_merge_exact_reference(
            queries, query_ids, block, block_ids, block_scale, carry_d,
            carry_i, c_tile=c_tile, exclude_self=exclude_self,
            exclude_zero=exclude_zero, zero_eps=zero_eps)
    qn = (stage_wire_norms(queries, None) if query_norms is None
          else _norms(query_norms, queries))
    bn = (stage_wire_norms(block, block_scale) if block_norms is None
          else _norms(block_norms, block))
    carry_d, carry_i = carry_d.contiguous(), carry_i.contiguous()
    out_d = torch.empty_like(carry_d)
    out_i = torch.empty_like(carry_i)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().block_merge_exact_launch(
            queries.data_ptr(), qn.data_ptr(), query_ids.data_ptr(),
            block.data_ptr(),
            block_scale.data_ptr() if block_scale is not None else None,
            bn.data_ptr(), block_ids.data_ptr(), carry_d.data_ptr(),
            carry_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), Q,
            block.shape[0], queries.shape[1], k, c_tile, _WIRE[block.dtype],
            int(exclude_self), int(exclude_zero), float(zero_eps), stream)
    _rc(rc, "fused_block_merge[exact]")
    return out_d, out_i


def exact_plan(wire_dtype, q_local: int, k: int) -> dict:
    """K3a's launch plan on the current card: query rows per CTA (128, or
    64 where 128-row groups would not fill the card's resident slots),
    CTAs, and the kernel's registers, spilled bytes and CTAs per SM."""
    vals = [ctypes.c_int() for _ in range(5)]
    rc = _lib().block_merge_exact_plan(_WIRE[wire_dtype], q_local, k,
                                       *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"block_merge_exact_plan failed: cudaError {rc}")
    return dict(zip(("rows_per_cta", "ctas", "registers", "spilled_bytes",
                     "ctas_per_sm"), (v.value for v in vals)))


def block_merge_exact_reference(queries, query_ids, block, block_ids,
                                block_scale, carry_d, carry_i, *, c_tile,
                                exclude_self=True, exclude_zero=True,
                                zero_eps=0.0):
    """Plain PyTorch version of ``block_merge_exact`` (any device): the
    reference's tile-by-tile merge, carry first."""
    blk = _wire_rows(block, block_scale)
    k = carry_d.shape[1]
    out_d, out_i = [], []
    for r0 in range(0, queries.shape[0], _PLAIN_ROWS):
        q = queries[r0:r0 + _PLAIN_ROWS]
        qid = query_ids[r0:r0 + _PLAIN_ROWS]
        q_sq = sq_norms(q)
        cd, ci = carry_d[r0:r0 + _PLAIN_ROWS], carry_i[r0:r0 + _PLAIN_ROWS]
        for t0 in range(0, blk.shape[0], c_tile):
            tile, tid = blk[t0:t0 + c_tile], block_ids[t0:t0 + c_tile]
            c_sq = sq_norms(tile)
            d = torch.clamp_min(
                q_sq[:, None] - 2.0 * _mm_t(q, tile) + c_sq[None, :], 0.0)
            invalid = (tid < 0)[None, :].expand_as(d)
            if exclude_zero:
                thresh = (zero_eps if zero_eps > 0.0
                          else _ZERO_RTOL * (q_sq[:, None] + c_sq[None, :]))
                invalid = invalid | (d <= thresh)
            if exclude_self:
                invalid = invalid | (tid[None, :] == qid[:, None])
            d = torch.where(invalid, float("inf"), d)
            cd, ci = _select(torch.cat([cd, d], 1),
                             torch.cat([ci, tid[None, :].expand_as(d)], 1), k)
        out_d.append(cd)
        out_i.append(ci)
    return torch.cat(out_d), torch.cat(out_i)


# ---------------------------------------------------------------- K3b

def block_merge_compress(queries, query_ids, block, block_ids, block_scale,
                         *, ov: int, c_tile: int, exclude_self: bool = True):
    """Each block tile's top-ov column positions by compressed key ->
    (b // c_tile, q_local, ov) int32, tile-local."""
    _check(queries, query_ids, block, block_ids, block_scale)
    b = block.shape[0]
    if b % c_tile or not 1 <= ov <= c_tile:
        raise ValueError(f"need c_tile | b and 1 <= ov <= c_tile (ov={ov})")
    if queries.device.type == "cpu":
        return block_merge_compress_reference(
            queries, query_ids, block, block_ids, block_scale, ov=ov,
            c_tile=c_tile, exclude_self=exclude_self)
    return block_merge_compress_staged(
        stage_wire_rows(queries, None), query_ids,
        stage_wire_rows(block, block_scale), block_ids, ov=ov, c_tile=c_tile,
        exclude_self=exclude_self)


def stage_wire_rows(rows, scale):
    """K3b's staging prologue on a row set at its wire type (f32, bf16, or
    int8 codes with their (n,) scales) -> ((n, staged_width(d)) bf16 copy
    of the decoded rows, rounded to nearest even and zero-padded; (n,) f32
    squared norms of the decoded rows)."""
    n, d = rows.shape
    width = staged_width(d)
    if rows.device.type == "cpu":
        return stage_bf16_rows_reference(_wire_rows(rows, scale), width)
    out = torch.empty((n, width), dtype=torch.bfloat16, device=rows.device)
    norms = torch.empty(n, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().stage_bf16_wire_launch(
            rows.data_ptr(), scale.data_ptr() if scale is not None else None,
            _WIRE[rows.dtype], out.data_ptr(), norms.data_ptr(), n, d, width,
            stream)
    _rc(rc, "stage_bf16[wire]")
    return out, norms


def block_merge_compress_staged(staged_q, query_ids, staged_b, block_ids, *,
                                ov: int, c_tile: int,
                                exclude_self: bool = True):
    """K3b on the card, on the prologue's ((Q, w) bf16, (Q,)) queries and
    ((b, w) bf16, (b,)) block -> (b // c_tile, Q, ov) int32 positions."""
    (qb, qn), (bb, bn) = staged_q, staged_b
    Q, b = qb.shape[0], bb.shape[0]
    shape = (b // c_tile, Q, ov)
    pos = torch.empty(shape, dtype=torch.int32, device=qb.device)
    # lists longer than the kernel keeps in shared memory need a scratch
    scratch = (torch.empty(shape, dtype=torch.float32, device=qb.device)
               if ov > 128 else None)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().block_merge_compress_launch(
            qb.data_ptr(), qn.data_ptr(), query_ids.data_ptr(), bb.data_ptr(),
            bn.data_ptr(), block_ids.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            pos.data_ptr(), Q, b, qb.shape[1], ov, c_tile, int(exclude_self),
            stream)
    _rc(rc, "fused_block_merge[compress]")
    return pos


def compress_kernel_info(ov: int) -> dict:
    """Registers and spilled (local) bytes a thread, and CTAs per SM, of K3b
    at list width ov (needs the card)."""
    vals = [ctypes.c_int() for _ in range(3)]
    rc = _lib().compress_kernel_info(ov, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"compress_kernel_info failed: cudaError {rc}")
    return dict(zip(("registers", "spilled_bytes", "ctas_per_sm"),
                    (v.value for v in vals)))


def block_merge_compress_reference(queries, query_ids, block, block_ids,
                                   block_scale, *, ov, c_tile,
                                   exclude_self=True):
    """Plain PyTorch version of ``block_merge_compress`` (any device): the
    product of the staged bf16 copies, with their norms."""
    blk, b_sq = stage_bf16_rows_reference(_wire_rows(block, block_scale))
    qb, q_sq = stage_bf16_rows_reference(queries)
    tiles = []
    for t0 in range(0, blk.shape[0], c_tile):
        tile, tid = blk[t0:t0 + c_tile], block_ids[t0:t0 + c_tile]
        c_sq = b_sq[t0:t0 + c_tile]
        parts = []
        for r0 in range(0, queries.shape[0], _PLAIN_ROWS):
            qs = q_sq[r0:r0 + _PLAIN_ROWS]
            keys = (qs[:, None] - 2.0 * _mm_t(qb[r0:r0 + _PLAIN_ROWS], tile)
                    + c_sq[None, :])
            invalid = (tid < 0)[None, :] | torch.isnan(keys)
            if exclude_self:
                invalid = invalid | (
                    tid[None, :] == query_ids[r0:r0 + _PLAIN_ROWS, None])
            keys = torch.where(invalid, float("inf"), keys)
            parts.append(preselect_smallest(keys, ov))
        tiles.append(torch.cat(parts))
    return torch.stack(tiles).to(torch.int32)


def _mixed_finish(queries, query_ids, block, block_ids, block_scale, pos,
                  carry_d, carry_i, cfg, c_tile):
    """Around K3b: per chunk of query rows, tile after tile, gather the
    survivors at the wire level (dequantizing only them), rerank exactly
    and merge into the carry."""
    n_c, Q, ov = pos.shape
    rows = max(1, _FINISH_BYTES // (ov * queries.shape[1] * 8))
    out_d, out_i = [], []
    for r0 in range(0, Q, rows):
        q, qid = queries[r0:r0 + rows], query_ids[r0:r0 + rows]
        cd, ci = carry_d[r0:r0 + rows], carry_i[r0:r0 + rows]
        for t in range(n_c):
            pos_g = (t * c_tile + pos[t, r0:r0 + rows]).long()
            cand = block[pos_g]
            cand = (dequantize_rows(cand, block_scale[pos_g])
                    if block_scale is not None else cand.to(torch.float32))
            ld, li = rerank_exact_topk(
                q, qid, cand, block_ids[pos_g], cfg.k, metric=cfg.metric,
                exclude_self=cfg.exclude_self, exclude_zero=cfg.exclude_zero,
                zero_eps=cfg.zero_eps)
            cd, ci = smallest_k(torch.cat([cd, ld], 1), torch.cat([ci, li], 1),
                                cfg.k, method="exact")
        out_d.append(cd)
        out_i.append(ci)
    return torch.cat(out_d), torch.cat(out_i)


def fused_block_merge(queries, query_ids, block, block_ids, block_scale,
                      carry_d, carry_i, *, cfg, q_tile: int, c_tile: int,
                      query_norms=None, block_norms=None):
    """Merge one resident ring block into the carry: the per-round compute
    of ``ring_fusion="fused"``. Returns the merged ((q_local, k) dists,
    ids). The norms are K3a's (``block_merge_exact``), where it runs."""
    q_local, b = queries.shape[0], block.shape[0]
    if q_local % q_tile or b % c_tile:
        raise ValueError("caller must pad to tile multiples")
    if (cfg.ring_transfer_dtype == "int8") != (block.dtype == torch.int8):
        raise ValueError(
            "ring_transfer_dtype='int8' circulates int8 codes with their "
            f"scales; got a {block.dtype} block")
    carry_d = carry_d.to(torch.float32)
    if merges_exactly(cfg, c_tile):
        # the exact policy, and the mixed policy's degenerate tile
        return block_merge_exact(
            queries, query_ids, block, block_ids, block_scale, carry_d,
            carry_i, c_tile=c_tile, exclude_self=cfg.exclude_self,
            exclude_zero=cfg.exclude_zero, zero_eps=cfg.zero_eps,
            query_norms=query_norms, block_norms=block_norms)
    pos = block_merge_compress(
        queries, query_ids, block, block_ids, block_scale,
        ov=overfetch_width(cfg.k, c_tile), c_tile=c_tile,
        exclude_self=cfg.exclude_self)
    return _mixed_finish(queries, query_ids, block, block_ids, block_scale,
                         pos, carry_d, carry_i, cfg, c_tile)
