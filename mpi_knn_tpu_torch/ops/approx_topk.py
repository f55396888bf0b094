"""``lax.approx_min_k`` for the port: the TPU's partial top-k reduction as
a bin minimum, the wrapper of its Hopper kernel (``csrc/approx_topk.cu``)
and the kernel's plain PyTorch version.

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

The wrapper takes its plain version only because the tensor it was given
lies on the CPU; on a CUDA tensor it launches the kernel or raises. Each
launch adds one to ``LAUNCHES["approx_min_k"]``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mpi_knn_tpu_torch.ops import _build

LAUNCHES = {"approx_min_k": 0}
# the kernel sorts the L winners in shared memory as 64-bit keys, padded
# to a power of two: 16384 keys are 128 KB of a CTA's 227 KB
MAX_KERNEL_WIDTH = 16384

_NAN_ORDER = (1 << 31) - 1


def reset_launch_counts():
    LAUNCHES["approx_min_k"] = 0


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
    """(…, n) float32 → ((…, out) values, (…, out) int64 column positions),
    out = k with ``aggregate_to_topk``, else ``reduction_width(n, k,
    recall_target)``; sorted by (value, column)."""
    _check(dists)
    if dists.device.type == "cpu":
        return approx_min_k_reference(dists, k, recall_target,
                                      aggregate_to_topk)
    n = dists.shape[-1]
    L, out = _out_width(n, k, recall_target, aggregate_to_topk)
    check_kernel_width(L)
    if not dists.is_contiguous():
        raise ValueError("approx_min_k: the kernel takes a contiguous tensor")
    lead = dists.shape[:-1]
    rows = dists.numel() // n
    vals = torch.empty((*lead, out), dtype=torch.float32, device=dists.device)
    pos = torch.empty((*lead, out), dtype=torch.int64, device=dists.device)
    with torch.cuda.device(dists.device):
        err = _lib().approx_min_k_launch(
            dists.data_ptr(), vals.data_ptr(), pos.data_ptr(), rows, n, L,
            out, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"approx_min_k launch failed (CUDA error {err})")
    LAUNCHES["approx_min_k"] += 1
    return vals, pos


def check_kernel_width(L: int):
    """The kernel sorts at most ``MAX_KERNEL_WIDTH`` winners a row."""
    if L > MAX_KERNEL_WIDTH:
        raise ValueError(
            f"approx_min_k kernel: reduction width L={L} exceeds "
            f"{MAX_KERNEL_WIDTH} (the winners a CTA sorts in shared memory); "
            "use a lower recall_target or topk_method='exact'"
        )


def _check(dists):
    if dists.dtype != torch.float32:
        raise TypeError(f"approx_min_k takes float32, got {dists.dtype}")
    if dists.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dists.device}")
    if dists.ndim < 1 or dists.shape[-1] < 1:
        raise ValueError("approx_min_k needs at least one column")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("approx_topk")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.approx_min_k_launch.argtypes = [ptr, ptr, ptr, ctypes.c_int64, i32,
                                        i32, i32, ptr]
    lib.approx_min_k_launch.restype = i32
    lib.approx_min_k_max_width.restype = i32
    if lib.approx_min_k_max_width() != MAX_KERNEL_WIDTH:
        raise RuntimeError("csrc/approx_topk.cu and MAX_KERNEL_WIDTH disagree")
    return lib
