"""``lax.approx_min_k`` for the port: the TPU's partial top-k reduction as
a bin minimum, the wrapper of its Hopper kernel (``csrc/approx_topk.cu``)
and the kernel's plain PyTorch version; and ``approx_smallest_k``, the
approximate branches of ``ops/topk.smallest_k`` fused into one launch.

The JAX package reaches the op from ``mpi_knn_tpu/ops/topk.py`` (the
"approx" and "approx-rerank" methods, after ``_pad_lanes``). XLA gives
its output width by a reduction-size rule (``reduction_width``); a row of
n columns falls into L bins, bin b holding columns b, b + L, b + 2L, …
below n, and each bin keeps its minimum with that minimum's column. With
``aggregate_to_topk`` the k smallest winners come back, else all L. Both
are sorted by (value, column), so ties go to the leftmost column as in
``lax.top_k``. -0.0 ranks with +0.0 and a NaN above +inf.

The bin assignment is the port's own: the TPU does not document the order
of its bins. Where no reduction happens (L = n), or for k = 1 (a bin
minimum is exact), the result is the exact top-k; elsewhere it is the
approximation the method asks for. JAX's CPU op returns the exact top-L
instead, so on the CPU the two packages agree only where the reduction is
exact (and, on ties, only in values: its CPU order of tied columns is its
own).

float64 rows (the f64 debugging mode) take the same plans: each key is
the value's 64 bits in the same signed order with the column beside it
(16 bytes of shared memory or scratch a key: ``launch_plan``'s
``key_bytes``); the plain version compares (value key, column) pairs.

The kernel takes any L up to n, by the plan ``launch_plan`` picks: a warp
a row (L <= 1024), a CTA a row (L <= 8192), or two passes over a global
scratch (wider). The wrappers take their plain versions only because the
tensor they were given lies on the CPU; on a CUDA tensor they launch the
kernel or raise. Each call that launches adds one to
``LAUNCHES["approx_min_k"]`` (on f64 rows ``"approx_min_k[f64]"``),
whatever its passes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.types import INVALID_ID
from mpi_knn_tpu_torch.utils.op_trace import note_launch, tensor_bytes

LAUNCHES = {"approx_min_k": 0, "approx_min_k[f64]": 0}

_NAN_ORDER = (1 << 31) - 1
_NAN_ORDER64 = (1 << 63) - 1
_INF = float("inf")
LANES = 128  # the lane multiple the approximate methods pad their rows to
# the plans of csrc/approx_topk.cu (their constants are the kernel's)
REGIMES = ("warp", "cta", "two_pass")
_WARP_MAX_BINS = 1024    # a warp a row up to 8 groups of 128 bins
_CTA_BINS = 512          # bins a warp in the cta plan (G = 4)
_CTA_MAX_WARPS = 16      # so a CTA a row up to 8192 bins
_TWO_PASS_BINS = 1024    # bins a warp in the two-pass plan (G = 8)
_WARP_ROWS = 4           # warps (rows) a CTA in the warp plan and pass 1
_ROUNDS_MAX = 32         # up to 32 keys by warp-minimum rounds, else a sort
_KEY_BYTES = {torch.float32: 8, torch.float64: 16}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=4096)
def reduction_width(n: int, k: int, recall_target: float = 0.95) -> int:
    """L, the output width of ``lax.approx_min_k(…, aggregate_to_topk=
    False)`` over n columns: XLA's reduction-size rule."""
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    if n <= 128:
        return n
    if k == 1:
        return 128
    m = n if recall_target >= 1.0 else int((1 - k) / math.log(recall_target))
    m = min(max(m, 128), n)
    r = int(math.floor(math.log2(n // m)))
    if r == 0:
        return n
    r = min(r, math.ceil(math.log2(n / 128)))
    return math.ceil(math.ceil(n / 128) / 2 ** r) * 128


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@functools.lru_cache(maxsize=4096)
def launch_plan(rows: int, n: int, L: int, out: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """How the kernel reduces ``rows`` rows of n columns to L bins and
    returns each row's ``out`` smallest winners: the regime ("warp": a warp
    a row, "cta": a CTA a row, "two_pass": chunks into a global scratch,
    then merges), G (a lane holds 4 G bins), the chunk of bins a warp
    reduces and the chunks a row, the selection ("rounds" of warp minima
    up to 32 keys, else a bitonic "sort" in shared memory), rows a CTA,
    threads, grid and dynamic shared bytes of the first kernel, the passes
    and the keys of the scratch, and the bytes of a key (8 for float32
    rows, 16 for float64). The wrapper hands it to the launch, which
    refuses a plan that does not fit the shape."""
    if not 1 <= out <= L <= n:
        raise ValueError(f"launch_plan: need 1 <= out={out} <= L={L} <= n={n}")
    plan = _plan(rows, n, L, out, _KEY_BYTES[dtype])
    plan["key_bytes"] = _KEY_BYTES[dtype]
    return plan


def _plan(rows, n, L, out, key_bytes):
    select = "rounds" if out <= _ROUNDS_MAX else "sort"
    if L <= _WARP_MAX_BINS:
        G = _pow2_at_least(-(-L // 128))
        chunks, chunk = 1, L
        shared = _WARP_ROWS * 128 * G * key_bytes  # a warp's keys, either way
        return dict(regime="warp", G=G, chunk=chunk, chunks=chunks,
                    select=select, rows_per_cta=_WARP_ROWS,
                    threads=32 * _WARP_ROWS, grid=-(-rows // _WARP_ROWS),
                    shared_bytes=shared, passes=1, scratch_keys=0)
    if L <= _CTA_BINS * _CTA_MAX_WARPS:
        chunks = -(-L // _CTA_BINS)
        chunk = -(-(-(-L // chunks)) // 4) * 4
        if select == "sort":
            shared = _pow2_at_least(chunks * _CTA_BINS) * key_bytes
        else:  # each warp's keys, then its out smallest for the merge
            shared = chunks * (_CTA_BINS + 32) * key_bytes
        return dict(regime="cta", G=_CTA_BINS // 128, chunk=chunk,
                    chunks=chunks, select=select, rows_per_cta=1,
                    threads=32 * chunks, grid=rows, shared_bytes=shared,
                    passes=1, scratch_keys=0)
    chunks = -(-L // _TWO_PASS_BINS)
    chunk = -(-(-(-L // chunks)) // 4) * 4
    length = min(out, chunk)
    scratch, nl, ln, passes = rows * chunks * length, chunks, length, 2
    while nl > 32:  # merges of 32 lists each until one group is left
        nl, ln = -(-nl // 32), min(out, 32 * ln)
        scratch += rows * nl * ln
        passes += 1
    shared = _WARP_ROWS * _TWO_PASS_BINS * key_bytes
    return dict(regime="two_pass", G=_TWO_PASS_BINS // 128, chunk=chunk,
                chunks=chunks, select="rounds" if length <= _ROUNDS_MAX else "sort",
                rows_per_cta=_WARP_ROWS, threads=32 * _WARP_ROWS,
                grid=-(-rows * chunks // _WARP_ROWS), shared_bytes=shared,
                passes=passes, scratch_keys=scratch)


def _out_width(n, k, recall_target, aggregate_to_topk):
    L = reduction_width(n, k, recall_target)
    if not aggregate_to_topk:
        return L, L
    if not 1 <= k <= L:
        raise ValueError(
            f"approx_min_k: k={k} outside [1, L={L}] (n={n}, "
            f"recall_target={recall_target})"
        )
    return L, k


def _order_keys(d: torch.Tensor) -> torch.Tensor:
    """(…, n) f32 → (…, n) int64 keys ordered as (value, column): the
    value's IEEE bits in a signed order (-0.0 as +0.0, NaN above +inf) in
    the high word, the column in the low word."""
    v = torch.where(d == 0, torch.zeros_like(d), d)
    s = v.view(torch.int32).to(torch.int64)
    o = torch.where(s >= 0, s, -(s & 0x7FFFFFFF) - 1)
    o = torch.where(torch.isnan(d), _NAN_ORDER, o)
    cols = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    return o * (1 << 32) + cols


def _order_keys64(d: torch.Tensor) -> torch.Tensor:
    """(…, n) f64 → (…, n) int64 value keys in the same signed order (-0.0
    as +0.0, NaN above +inf); the column is the second word of the pair."""
    v = torch.where(d == 0, torch.zeros_like(d), d)
    s = v.view(torch.int64)
    o = torch.where(s >= 0, s, -(s & 0x7FFFFFFFFFFFFFFF) - 1)
    return torch.where(torch.isnan(d), _NAN_ORDER64, o)


def _bin_winners64(d: torch.Tensor, L: int, out: int) -> torch.Tensor:
    """The f64 bin minimum by (value key, column) pairs: each bin's
    smallest key with ties to its lowest column (the first segment), NaN
    padding past n, then the winners sorted by (key, column), ``out``
    kept: (rows, out) int64 positions."""
    rows, n = d.shape
    keys = _order_keys64(d)
    pad = -n % L
    if pad:  # NaN padding loses to every real column, a real NaN included
        keys = torch.cat([keys, keys.new_full((rows, pad), _NAN_ORDER64)], -1)
    wk, seg = keys.view(rows, (n + pad) // L, L).min(dim=1)  # first on ties
    cols = seg * L + torch.arange(L, device=d.device)
    by_col = torch.argsort(cols, dim=-1)
    order = torch.gather(by_col, 1, torch.sort(torch.gather(wk, 1, by_col), dim=-1,
                                               stable=True).indices)
    return torch.gather(cols, 1, order[:, :out])


def approx_min_k_reference(dists: torch.Tensor, k: int,
                           recall_target: float = 0.95,
                           aggregate_to_topk: bool = True):
    """The plain version: pad the row with NaN to a multiple of L, view
    it as (…, rows, L), take each bin's minimum key (its smallest value,
    ties to the lowest column), sort the winners, keep k (or L)."""
    _check(dists)
    n = dists.shape[-1]
    L, out = _out_width(n, k, recall_target, aggregate_to_topk)
    lead = dists.shape[:-1]
    d = dists.reshape(-1, n)
    if d.dtype == torch.float64:
        pos = _bin_winners64(d, L, out)
    else:
        keys = _order_keys(d)
        pad = -n % L
        if pad:  # NaN padding loses to every real column, a real NaN included
            cols = torch.arange(n, n + pad, dtype=torch.int64, device=d.device)
            keys = torch.cat(
                [keys, (_NAN_ORDER * (1 << 32) + cols).expand(d.shape[0], pad)], -1)
        win = keys.view(d.shape[0], (n + pad) // L, L).amin(dim=1)
        pos = torch.sort(win, dim=-1).values[:, :out] & 0xFFFFFFFF
    vals = torch.gather(d, 1, pos)
    return vals.reshape(*lead, out), pos.reshape(*lead, out)


def approx_min_k(dists: torch.Tensor, k: int, recall_target: float = 0.95,
                 aggregate_to_topk: bool = True):
    """(…, n) float32 or float64 → ((…, out) values, (…, out) int64 column
    positions), out = k with ``aggregate_to_topk``, else
    ``reduction_width(n, k, recall_target)``; sorted by (value, column)."""
    _check(dists)
    if dists.device.type == "cpu":
        return approx_min_k_reference(dists, k, recall_target,
                                      aggregate_to_topk)
    n = dists.shape[-1]
    L, out = _out_width(n, k, recall_target, aggregate_to_topk)
    if not dists.is_contiguous():
        raise ValueError("approx_min_k: the kernel takes a contiguous tensor")
    lead = dists.shape[:-1]
    rows = dists.numel() // n
    vals = torch.empty((*lead, out), dtype=dists.dtype, device=dists.device)
    pos = torch.empty((*lead, out), dtype=torch.int64, device=dists.device)
    _launch(dists, n, rows, n, n, L, out, vals, pos=pos)
    return vals, pos


def _pad_lanes(dists, ids):
    """Pad the columns to a multiple of ``LANES`` with (+inf, INVALID_ID),
    as the JAX package does before every approximate reduction (its TPU
    op wedged on other widths); the sentinels never enter a k-smallest
    result."""
    q, c = dists.shape
    pad = -c % LANES
    if pad:
        dists = torch.cat([dists, dists.new_full((q, pad), _INF)], dim=-1)
        ids = torch.cat([ids, ids.new_full((q, pad), INVALID_ID)], dim=-1)
    return dists, ids


def _fused_width(c, k, method, recall_target):
    """(n_pad, L, out) of ``approx_smallest_k`` over c real columns."""
    if method not in ("approx", "approx-rerank"):
        raise ValueError(f"approx_smallest_k: method {method!r} is not approximate")
    n_pad = -(-c // LANES) * LANES
    if method == "approx":
        return (n_pad, *_out_width(n_pad, k, recall_target, True))
    L = reduction_width(n_pad, 4 * k, recall_target)
    return n_pad, L, min(k, L)


def approx_smallest_k_reference(dists, ids, k: int, method: str,
                                recall_target: float = 0.95):
    """The plain version of ``approx_smallest_k``: the chain the approximate
    branches of ``smallest_k`` ran before the fused form. Pad the lanes,
    reduce (``approx``: the k smallest bin winners; ``approx-rerank``: all
    L = L(4k) winners, then an exact stable sort keeping k), gather the
    ids, and set the +-inf slots' ids to INVALID_ID."""
    _fused_width(dists.shape[-1], k, method, recall_target)
    q, c = dists.shape
    if ids.ndim == 1:
        ids = ids[None, :].expand(q, c)
    dists, ids = _pad_lanes(dists, ids)
    if method == "approx-rerank":
        dists, pos = approx_min_k_reference(dists.contiguous(), 4 * k,
                                            recall_target,
                                            aggregate_to_topk=False)
        ids = torch.gather(ids, -1, pos)
        vals, order = torch.sort(dists, dim=-1, stable=True)
        vals, out_ids = vals[..., :k], torch.gather(ids, -1, order[..., :k])
    else:
        vals, pos = approx_min_k_reference(dists.contiguous(), k,
                                           recall_target)
        out_ids = torch.gather(ids, -1, pos)
    return vals, torch.where(torch.isinf(vals), INVALID_ID, out_ids)


def approx_smallest_k(dists, ids, k: int, method: str,
                      recall_target: float = 0.95):
    """``smallest_k(dists, ids, k, method)`` for the approximate methods in
    one launch: the (q, c) f32 or f64 tile is read where it lies (row stride
    kept; columns c up to the next multiple of 128 count as (+inf,
    INVALID_ID)), ids (c,) or (q, c) int32 are gathered in the epilogue.
    ``approx``: the k smallest of L = ``reduction_width(padded c, k)`` bin
    winners; ``approx-rerank``: the k smallest of L(4k) winners, which is
    what the exact finish over all L winners returns (they come sorted by
    (value, column), and a stable sort by value keeps that order). Returns
    (q, out) values ascending and (q, out) int32 ids, INVALID_ID where the
    value is +-inf; out = k (``approx-rerank``: min(k, L))."""
    _check(dists)
    if dists.device.type == "cpu":
        return approx_smallest_k_reference(dists, ids, k, method,
                                           recall_target)
    q, c = dists.shape
    n_pad, L, out = _fused_width(c, k, method, recall_target)
    if ids.dtype != torch.int32 or ids.device != dists.device:
        raise TypeError("approx_smallest_k: the kernel takes int32 ids on "
                        "the tile's device")
    if ids.shape not in ((c,), (q, c)):
        raise ValueError(f"approx_smallest_k: ids {tuple(ids.shape)} for a "
                         f"({q}, {c}) tile")
    if dists.stride(-1) != 1:
        dists = dists.contiguous()
    if ids.stride(-1) != 1:
        ids = ids.contiguous()
    ids_ld = ids.stride(0) if ids.ndim == 2 else 0
    vals = torch.empty((q, out), dtype=dists.dtype, device=dists.device)
    out_ids = torch.empty((q, out), dtype=torch.int32, device=dists.device)
    _launch(dists, dists.stride(0), q, c, n_pad, L, out, vals, ids=ids,
            ids_ld=ids_ld, out_ids=out_ids)
    return vals, out_ids


def _launch(d, ld, rows, c, n_pad, L, out, vals, pos=None, ids=None,
            ids_ld=0, out_ids=None):
    """One call of the kernel on d's card and current stream, by the plan
    of ``launch_plan``, writing vals and pos, or vals and out_ids (ids
    gathered); raises on a CUDA error."""
    if rows == 0:
        return
    plan = launch_plan(rows, n_pad, L, out, d.dtype)
    # the keys of the two-pass scratch, as int64 words (two a key for f64)
    scratch = (torch.empty(plan["scratch_keys"] * plan["key_bytes"] // 8,
                           dtype=torch.int64, device=d.device)
               if plan["scratch_keys"] else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (d.data_ptr(), ld, rows, c, n_pad, L, out,
            REGIMES.index(plan["regime"]), plan["G"], plan["chunk"],
            plan["chunks"], plan["shared_bytes"], ptr(scratch),
            plan["scratch_keys"], vals.data_ptr(), ptr(pos), ptr(ids), ids_ld,
            ptr(out_ids))
    fn = (_lib().approx_min_k_f64_launch if d.dtype == torch.float64
          else _lib().approx_min_k_launch)
    index = d.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, _stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _stream(index))
    if err:
        raise RuntimeError(f"approx_min_k launch failed (CUDA error {err}; "
                           f"plan {plan})")
    note_launch(LAUNCHES,
                "approx_min_k[f64]" if d.dtype == torch.float64 else "approx_min_k",
                lambda: dict(operands=(d, ids), outputs=(vals, pos, out_ids),
                             precision="none",
                             bytes=tensor_bytes(d, ids, vals, pos, out_ids)))


def _stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on card ``index``, without
    the Stream object ``torch.cuda.current_stream`` builds (2.5 µs a call
    against 0.1 on an H100's host; chip_smoke.py's ``approx_host``)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _check(dists):
    if dists.dtype not in _KEY_BYTES:
        raise TypeError(f"approx_min_k takes float32 or float64, got {dists.dtype}")
    if dists.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dists.device}")
    if dists.ndim < 1 or dists.shape[-1] < 1:
        raise ValueError("approx_min_k needs at least one column")


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.load("approx_topk"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a build of ``csrc/approx_topk.cu``."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.approx_min_k_launch.argtypes = [
        ptr, i64, i64, i32, i32, i32, i32,  # d, ld, rows, c, n_pad, L, out
        i32, i32, i32, i32, i32,            # regime, G, chunk, chunks, shared
        ptr, i64,                           # scratch, its keys
        ptr, ptr, ptr, i64, ptr,            # vals, pos, ids, ids_ld, out_ids
        ptr]                                # stream
    lib.approx_min_k_launch.restype = i32
    lib.approx_min_k_f64_launch.argtypes = lib.approx_min_k_launch.argtypes
    lib.approx_min_k_f64_launch.restype = i32
    return lib
