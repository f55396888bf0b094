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

The exact mode is full f32 (the plain versions' ``torch.matmul``, TF32
off). On the card it is two steps: the prologue ``stage_tf32_split`` splits
the queries and the corpus once each (once in all, when the queries are the
first rows of the corpus) into TF32 hi and lo planes (``tf32_split``:
x = hi + lo), zero-padded to ``split_width(d)``, with their squared norms;
the kernel (``launch_exact``) loads the planes by TMA and multiplies them
in three ``wgmma`` passes whose sums are f32-accurate. The prologue takes
its norms by the same product sequence, so an exact duplicate pair keeps a
distance of exactly 0.

``compress=True`` is the mixed policy's pass 1, as in the JAX kernels: the
dot runs on bf16-rounded operands with f32 sums, the norms come from the
unrounded rows, the zero mask is off (padding and self stay), and the
caller asks for the overfetch width as k. On the card it is two steps: the
staging prologue (``stage_bf16_rows``: a bf16 copy rounded to nearest even
and zero-padded to a multiple of ``STAGE_K``, plus the f32 squared norms
of the unrounded rows), once for the queries and once for the corpus, then
the bf16 tensor-core kernel on the copies (``launch_compress``). The sweep
form (K2[c]) runs one ``wgmma`` pass, filters the keys in registers, and
splits the corpus into the slices ``compress_sweep_plan`` picks, so that
a serving bucket's few query groups still fill the card; its output does
not depend on the split.

A serving index stages its corpus once (``stage_corpus`` -> ``StagedCorpus``)
and hands it to every call as ``staged_corpus``: a call then launches the
prologue on its queries alone, and the kernel reads the resident planes.

A wrapper takes its plain version only because the tensors it was given lie
on the CPU. For CUDA tensors it launches the kernel or raises. Each launch
adds one to ``LAUNCHES[name]``: the kernels' names carry ``[compress]`` in
that mode, the prologues' are ``stage_tf32_split`` and ``stage_bf16``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from mpi_knn_tpu_torch.ops import _build
from mpi_knn_tpu_torch.ops.distance import _mm_t, sq_norms
from mpi_knn_tpu_torch.types import INVALID_ID

_ZERO_RTOL = 1e-6  # the f32 zero-exclusion rtol (ops/topk.py)
STAGE_K = 32  # the compress tile's slice depth: staged widths are its multiples
SWEEP_ROWS = 128  # K2[c]'s query rows per item (csrc/knn_wgmma_bf16.cuh ROWS)
SWEEP_COLS = 256  # its columns per chunk (knn_wgmma_bf16.cuh COLS)
# the plan's cost of an item beyond its chunks, in chunks: list set-up, the
# first chunks' winners (every key beats an empty list), the emit and the
# slices' merge; fitted to K2[c]'s times at S = 1, 2, 3, 5 on the main
# shape (60416 x 61440 x 784, ov 40) on an H100 80GB HBM3 at 700 W
ITEM_OVERHEAD_CHUNKS = 30
MAX_SLICES = 64
SPLIT_K = 16  # the exact tile's k-block: the planes' pitch is its multiple

LAUNCHES = {"fused_knn_tiles": 0, "fused_knn_sweep": 0,
            "fused_knn_tiles[compress]": 0, "fused_knn_sweep[compress]": 0,
            "stage_tf32_split": 0, "stage_bf16": 0}
# the kernels of csrc/fused_knn.cu's kernel_info, by launch-count name
_KERNELS = ("fused_knn_tiles", "fused_knn_sweep", "fused_knn_tiles[compress]",
            "fused_knn_sweep[compress]")


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, with its C signatures set once at first load."""
    return configure(_build.load("fused_knn"))


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a build of csrc/fused_knn.cu."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    exact = [ptr] * 8 + [i32] * 5
    common = [ptr] * 6 + [i32] * 5
    flags = [i32, i32, i32, ctypes.c_float, ptr]
    lib.fused_knn_tiles_launch.argtypes = exact + [i32] + flags
    lib.fused_knn_sweep_launch.argtypes = exact + flags
    lib.fused_knn_tiles_compress_launch.argtypes = common + [i32] * 3 + [ptr]
    lib.fused_knn_sweep_compress_launch.argtypes = (
        [ptr] * 9 + [i32] * 5 + [i32] * 3 + [ptr])
    lib.compress_sweep_plan.argtypes = [i32] * 5 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.POINTER(i32)] * 5
    lib.bf16_tile_dots_launch.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    lib.stage_bf16_f32_launch.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.stage_tf32_split_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.split_tile_dots_launch.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    lib.exact_tile_dots_launch.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.kernel_info.argtypes = [i32, i32] + [ctypes.POINTER(i32)] * 4
    lib.exact_plan.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong),
                                           ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.mma_rate_launch.argtypes = [i32, i32, ptr, ptr]
    lib.mma_rate_launch.restype = ctypes.c_double
    lib.wgmma_rate_launch.argtypes = [i32, ptr, ptr]
    lib.wgmma_rate_launch.restype = ctypes.c_double
    for fn in (lib.fused_knn_tiles_launch, lib.fused_knn_sweep_launch,
               lib.fused_knn_tiles_compress_launch,
               lib.fused_knn_sweep_compress_launch, lib.stage_bf16_f32_launch,
               lib.stage_tf32_split_launch, lib.split_tile_dots_launch,
               lib.exact_tile_dots_launch, lib.kernel_info, lib.exact_plan,
               lib.compress_sweep_plan, lib.bf16_tile_dots_launch):
        fn.restype = i32
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


def _call(fn, name, device, tensors, out_shape, *args):
    """Launch ``fn(*tensors' pointers, out_d, out_i, *args, stream)`` into
    fresh (dists, ids) of ``out_shape``."""
    out_d = torch.empty(out_shape, dtype=torch.float32, device=device)
    out_i = torch.empty(out_shape, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), out_d.data_ptr(),
                out_i.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out_d, out_i


def _rows_f32(rows):
    if rows.dtype != torch.float32 or rows.ndim != 2 or not rows.is_contiguous():
        raise TypeError("rows must be a contiguous 2-D float32 tensor")


def split_width(d: int) -> int:
    """The pitch of the exact prologue's planes: d rounded up to ``SPLIT_K``."""
    return -(-d // SPLIT_K) * SPLIT_K


def stage_tf32_split(rows):
    """The exact kernels' prologue on an f32 (n, d) row set -> (hi, lo,
    norms): the TF32 planes ((n, split_width(d)) f32, x = hi + lo, zero
    past d) and the (n,) f32 squared norms, on the card by the exact tile's
    wgmma product sequence (the diagonal of each 128-row group's product
    with itself)."""
    _rows_f32(rows)
    n, d = rows.shape
    width = split_width(d)
    if rows.device.type == "cpu":
        return stage_tf32_split_reference(rows, width)
    hi, lo = (torch.empty((n, width), dtype=torch.float32, device=rows.device)
              for _ in range(2))
    norms = torch.empty(n, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().stage_tf32_split_launch(rows.data_ptr(), hi.data_ptr(),
                                            lo.data_ptr(), norms.data_ptr(), n, d,
                                            width, stream)
    if rc != 0:
        raise RuntimeError(f"stage_tf32_split launch failed: cudaError {rc}")
    LAUNCHES["stage_tf32_split"] += 1
    return hi, lo, norms


def stage_tf32_split_reference(rows, width=None):
    """Plain version of the exact prologue (any device): the planes of
    ``tf32_split`` zero-padded to ``width`` (default: d), and the rows' f32
    squared norms."""
    n, d = rows.shape
    width = d if width is None else width
    planes = []
    for part in tf32_split(rows):
        plane = torch.zeros((n, width), dtype=torch.float32, device=rows.device)
        plane[:, :d] = part
        planes.append(plane)
    return planes[0], planes[1], sq_norms(rows)


def _stage_exact(queries, corpus):
    """The prologue for an exact call: (staged queries, staged corpus). When
    the queries are the corpus' first rows (all-pairs mode), the corpus is
    staged once and the queries take its first rows."""
    if (queries.data_ptr() == corpus.data_ptr()
            and queries.shape[0] <= corpus.shape[0]):
        staged_c = stage_tf32_split(corpus)
        return tuple(t[:queries.shape[0]] for t in staged_c), staged_c
    return stage_tf32_split(queries), stage_tf32_split(corpus)


@dataclasses.dataclass
class StagedCorpus:
    """A corpus's prologue outputs, written once and read by every later
    call on that corpus (a serving index's resident planes): ``exact`` the
    (hi, lo, norms) of ``stage_tf32_split``, ``compress`` the (bf16 copy,
    norms) of ``stage_bf16_rows``, None where not staged. The tensors stay
    at one address for the object's life, so the kernels' TMA maps, encoded
    per launch from the pointers, always find them."""

    exact: tuple | None = None
    compress: tuple | None = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for part in (self.exact, self.compress) if part is not None
                   for t in part)


def stage_corpus(corpus, compress: bool = False) -> StagedCorpus:
    """Run one prologue once on a padded f32 corpus on the card: the exact
    planes, or with ``compress`` the compress copy."""
    if compress:
        return StagedCorpus(compress=stage_bf16_rows(corpus))
    return StagedCorpus(exact=stage_tf32_split(corpus))


def _stage_call(queries, corpus, staged_corpus, compress: bool):
    """(staged queries, staged corpus) of one card call: the corpus's from
    ``staged_corpus`` when given (one prologue launch, on the queries),
    else both staged here."""
    if staged_corpus is None:
        if compress:
            return stage_bf16_rows(queries), stage_bf16_rows(corpus)
        return _stage_exact(queries, corpus)
    part = staged_corpus.compress if compress else staged_corpus.exact
    if part is None:
        raise ValueError(
            f"staged_corpus holds no {'compress' if compress else 'exact'} "
            "prologue output"
        )
    if part[0].shape[0] != corpus.shape[0] or part[0].device != corpus.device:
        raise ValueError("staged_corpus was not staged from this corpus")
    if compress:
        return stage_bf16_rows(queries), part
    return stage_tf32_split(queries), part


def tf32_split(x):
    """Plain model of the exact tile's operand split: x = hi + lo with
    hi = tf32_rna(x) and lo = tf32_rna(x - hi) (round to nearest, ties away
    from zero, to 10 stored mantissa bits), on f32 tensors. A value with at
    most 11 significant bits has lo = 0; hi + lo is x within 2^-22 |x|."""

    def rna(v):
        bits = v.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(v), r, v)

    hi = rna(x)
    return hi, rna(x - hi)


def exact_tile_dots(queries, corpus):
    """The mma.sync exact tile's raw products queries · corpusᵀ ((Q, C)
    f32), the tile of K3a, K4 and K5: a test hook for the card (the ring
    prologue's norms are this product's diagonal); on the CPU,
    ``torch.matmul``. Not counted in ``LAUNCHES``."""
    _check(queries, corpus, 1, 1, 1)
    if queries.device.type == "cpu":
        return _mm_t(queries, corpus)
    (Q, D), C = queries.shape, corpus.shape[0]
    out = torch.empty((Q, C), dtype=torch.float32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().exact_tile_dots_launch(queries.data_ptr(), corpus.data_ptr(),
                                           out.data_ptr(), Q, C, D, stream)
    if rc != 0:
        raise RuntimeError(f"exact_tile_dots launch failed: cudaError {rc}")
    return out


def split_tile_dots(staged_q, staged_c):
    """The wgmma exact tile's raw products of two staged row sets ((hi, lo,
    norms) each, from ``stage_tf32_split``) -> (Q, C) f32: a test hook for
    the card (the prologue's norms are this product's diagonal); on the CPU,
    ``torch.matmul`` of hi + lo. Not counted in ``LAUNCHES``."""
    (qh, ql, _), (ch, cl, _) = staged_q, staged_c
    if qh.device.type == "cpu":
        return _mm_t(qh + ql, ch + cl)
    Q, C = qh.shape[0], ch.shape[0]
    out = torch.empty((Q, C), dtype=torch.float32, device=qh.device)
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().split_tile_dots_launch(qh.data_ptr(), ql.data_ptr(), ch.data_ptr(),
                                           cl.data_ptr(), out.data_ptr(), Q, C,
                                           qh.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"split_tile_dots launch failed: cudaError {rc}")
    return out


def staged_width(d: int) -> int:
    """The width of a staged bf16 copy: d rounded up to ``STAGE_K``."""
    return -(-d // STAGE_K) * STAGE_K


def stage_bf16_rows(rows):
    """The compress kernels' staging prologue on an f32 (n, d) row set ->
    ((n, staged_width(d)) bf16 copy rounded to nearest even, zero-padded;
    (n,) f32 squared norms of the unrounded rows)."""
    _rows_f32(rows)
    n, d = rows.shape
    width = staged_width(d)
    if rows.device.type == "cpu":
        return stage_bf16_rows_reference(rows, width)
    out = torch.empty((n, width), dtype=torch.bfloat16, device=rows.device)
    norms = torch.empty(n, dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().stage_bf16_f32_launch(rows.data_ptr(), out.data_ptr(),
                                          norms.data_ptr(), n, d, width, stream)
    if rc != 0:
        raise RuntimeError(f"stage_bf16 launch failed: cudaError {rc}")
    LAUNCHES["stage_bf16"] += 1
    return out, norms


def stage_bf16_rows_reference(rows, width=None):
    """Plain version of the staging prologue (any device): ``rows`` are the
    decoded f32 rows; the copy is zero-padded to ``width`` (default: d)."""
    n, d = rows.shape
    width = d if width is None else width
    copy = torch.zeros((n, width), dtype=torch.bfloat16, device=rows.device)
    copy[:, :d] = rows.to(torch.bfloat16)
    return copy, sq_norms(rows)


def launch_compress(base: str, staged_q, staged_c, m_corpus: int, k: int,
                    c_tile: int, exclude_self: bool = True,
                    all_pairs: bool = True, slices: int | None = None):
    """The compress kernel ``base`` ("fused_knn_tiles" or
    "fused_knn_sweep") on the prologue's ((Q, w) bf16, (Q,)) queries and
    ((C, w) bf16, (C,)) corpus, on the card: (n_c, Q, k) or (Q, k) raw
    dists and ids. ``slices`` forces the sweep's corpus split (default:
    ``compress_sweep_plan``'s); the output is the same for every split."""
    (qb, qn), (cb, cn) = staged_q, staged_c
    Q, C = qb.shape[0], cb.shape[0]
    name = base + "[compress]"
    if base == "fused_knn_tiles":
        return _call(_lib().fused_knn_tiles_compress_launch, name, qb.device,
                     (qb, qn, cb, cn), (C // c_tile, Q, k), Q, C, qb.shape[1],
                     m_corpus, k, c_tile, int(exclude_self), int(all_pairs))
    plan = compress_sweep_plan(Q, min(C, m_corpus), _sm_count(qb.device), slices)
    S = plan["slices"]
    dev = qb.device
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    part_d = part_i = counters = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if S > 1:
            part_d = torch.empty((S, Q, k), dtype=torch.float32, device=dev)
            part_i = torch.empty((S, Q, k), dtype=torch.int32, device=dev)
            counters = _group_counters(dev, stream, plan["groups"])
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        rc = _lib().fused_knn_sweep_compress_launch(
            qb.data_ptr(), qn.data_ptr(), cb.data_ptr(), cn.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), ptr(part_d), ptr(part_i),
            ptr(counters), Q, C, qb.shape[1], m_corpus, k, int(exclude_self),
            int(all_pairs), S, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out_d, out_i


_COUNTERS: dict = {}


def _group_counters(device, stream: int, groups: int) -> torch.Tensor:
    """K2[c]'s per-group counters on ``device`` for launches on ``stream``:
    zeroed once, and left at zero by every launch, so a call adds no fill
    (a buffer per stream: launches on two streams may overlap)."""
    key = (torch.device(device).index or 0, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < groups:
        buf = _COUNTERS[key] = torch.zeros(groups, dtype=torch.int32, device=device)
    return buf


@functools.cache
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sm_count(device) -> int:
    return _sm_count_of(torch.device(device).index or 0)


def compress_sweep_plan(Q: int, c_end: int, sms: int, slices: int | None = None,
                        cols: int = SWEEP_COLS) -> dict:
    """K2[c]'s work split: Q query rows in groups of ``SWEEP_ROWS`` against
    columns [0, c_end) in chunks of ``cols``, cut into ``slices`` corpus
    slices of ``span`` columns; an item is (query group, slice), walked
    slice-major by a persistent grid of min(items, sms) CTAs. Unless forced,
    S is the one (the smallest on ties) that minimises waves x (chunks per
    slice + ``ITEM_OVERHEAD_CHUNKS``): a few query groups are spread over
    the card, and a last wave's waste is weighed against each slice's
    set-up and merge. The kernel (csrc/knn_wgmma_bf16.cuh ``sweep_walk``)
    cuts the same spans."""
    groups = -(-Q // SWEEP_ROWS)
    chunks = max(1, -(-c_end // cols))

    def cost(s):
        return -(-groups * s // sms) * (-(-chunks // s) + ITEM_OVERHEAD_CHUNKS)

    if slices is None:
        slices = min(range(1, min(chunks, MAX_SLICES) + 1), key=cost)
        slices = -(-chunks // -(-chunks // slices))  # no empty slice
    if slices < 1:
        raise ValueError(f"slices={slices} must be >= 1")
    per = -(-chunks // slices)
    items = groups * slices
    grid = min(items, sms)
    return {"rows_per_cta": SWEEP_ROWS, "cols": cols, "groups": groups,
            "chunks": chunks, "slices": slices, "span": per * cols,
            "items": items, "grid": grid, "waves": items / grid}


def compress_sweep_items(plan: dict, c_end: int):
    """The (query group, first column, end column) of each item of a plan,
    in the kernel's slice-major order."""
    return [(n % plan["groups"], s * plan["span"],
             min((s + 1) * plan["span"], c_end))
            for n in range(plan["items"]) for s in [n // plan["groups"]]]


def compress_sweep_launch_plan(Q: int, C: int, m_corpus: int, k: int,
                               slices: int) -> dict:
    """K2[c]'s launch plan as the built kernel sees it (needs the card):
    items, the persistent grid, CTAs per SM, the span of a slice, the
    columns of a chunk and the dynamic shared bytes."""
    items = ctypes.c_longlong()
    vals = [ctypes.c_int() for _ in range(5)]
    rc = _lib().compress_sweep_plan(Q, C, m_corpus, k, slices, ctypes.byref(items),
                                    *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"compress_sweep_plan failed: cudaError {rc}")
    plan = dict(zip(("grid", "ctas_per_sm", "span", "cols", "smem_bytes"),
                    (v.value for v in vals)))
    return {"slices": slices, "items": items.value, **plan,
            "waves": items.value / plan["grid"], "cluster": 1}


def bf16_tile_dots(staged_q, staged_c, slices: int = 1, sink: bool = False):
    """K2[c]'s bf16 tile's raw products of two staged row sets ((copy,
    norms) each, from ``stage_bf16_rows``) -> (Q, C) f32: a test hook and,
    with ``sink`` (the products computed, nothing written; returns None),
    the tile's product alone. On the CPU, ``torch.matmul`` of the copies.
    Not counted in ``LAUNCHES``."""
    (qb, _), (cb, _) = staged_q, staged_c
    if qb.device.type == "cpu":
        return None if sink else _mm_t(qb, cb)
    Q, C = qb.shape[0], cb.shape[0]
    out = torch.empty((1, 1) if sink else (Q, C), dtype=torch.float32,
                      device=qb.device)
    with torch.cuda.device(qb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().bf16_tile_dots_launch(
            qb.data_ptr(), cb.data_ptr(), out.data_ptr(), Q, C, qb.shape[1],
            slices, int(sink), stream)
    if rc != 0:
        raise RuntimeError(f"bf16_tile_dots launch failed: cudaError {rc}")
    return None if sink else out


def launch_exact(base: str, staged_q, staged_c, m_corpus: int, k: int,
                 c_tile: int, exclude_self: bool = True,
                 exclude_zero: bool = True, all_pairs: bool = True,
                 zero_eps: float = 0.0):
    """The exact kernel ``base`` ("fused_knn_tiles" or "fused_knn_sweep")
    on the prologue's (hi, lo, norms) of the queries and of the corpus, on
    the card: (n_c, Q, k) or (Q, k) dists and ids."""
    (qh, ql, qn), (ch, cl, cn) = staged_q, staged_c
    Q, C = qh.shape[0], ch.shape[0]
    tensors = (qh, ql, qn, ch, cl, cn)
    shape_args = (Q, C, qh.shape[1], m_corpus, k)
    flags = (int(exclude_self), int(exclude_zero), int(all_pairs), float(zero_eps))
    if base == "fused_knn_tiles":
        return _call(_lib().fused_knn_tiles_launch, base, qh.device,
                     tensors, (C // c_tile, Q, k), *shape_args, c_tile, *flags)
    return _call(_lib().fused_knn_sweep_launch, base, qh.device, tensors,
                 (Q, k), *shape_args, *flags)


def wgmma_rate(device, iters: int = 4096) -> float:
    """The card's wgmma rate in TFLOP/s (m64n128k8 tf32, two warpgroups per
    SM as the exact tile runs them): a probe run twice, the second timed
    by CUDA events. The ceiling of the exact tile's products; on no
    kernel's path."""
    out = torch.empty(torch.cuda.get_device_properties(device).multi_processor_count
                      * 256, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(2):  # the first launch is the warm-up
            start.record()
            flop = _lib().wgmma_rate_launch(iters, out.data_ptr(), stream)
            end.record()
            if flop < 0:
                raise RuntimeError(f"wgmma_rate launch failed: cudaError {int(-flop)}")
        end.synchronize()
    return flop / (start.elapsed_time(end) * 1e-3) / 1e12


def exact_plan(base: str, Q: int, C: int, c_tile: int, k: int) -> dict:
    """The exact kernel's persistent launch plan (needs the card): items
    (query groups of 128 rows, times corpus tiles for the tiles form), the
    grid of CTAs and CTAs per SM."""
    items, grid, per_sm = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().exact_plan(_KERNELS.index(base), Q, C, c_tile, k, ctypes.byref(items),
                           ctypes.byref(grid), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"exact_plan failed: cudaError {rc}")
    return {"rows_per_cta": 128, "items": items.value, "grid": grid.value,
            "ctas_per_sm": per_sm.value, "waves": items.value / grid.value}


def mma_rate(device, tf32: bool, iters: int = 4096) -> float:
    """The card's mma.sync rate in TFLOP/s (m16n8k8 tf32, or m16n8k16 bf16
    when ``tf32`` is False): a probe run twice, the second timed by CUDA
    events. The ceiling of the tiles' products; on no kernel's path."""
    out = torch.empty(2 * torch.cuda.get_device_properties(device).multi_processor_count
                      * 256, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(2):  # the first launch is the warm-up
            start.record()
            flop = _lib().mma_rate_launch(int(tf32), iters, out.data_ptr(), stream)
            end.record()
            if flop < 0:
                raise RuntimeError(f"mma_rate launch failed: cudaError {int(-flop)}")
        end.synchronize()
    return flop / (start.elapsed_time(end) * 1e-3) / 1e12


def kernel_info(name: str, k: int) -> dict:
    """Registers and spilled (local) bytes a thread, CTAs per SM and dynamic
    shared bytes of the kernel ``name`` (a ``LAUNCHES`` kernel name) at
    list width k (needs the card)."""
    vals = [ctypes.c_int() for _ in range(4)]
    rc = _lib().kernel_info(_KERNELS.index(name), k,
                            *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"kernel_info failed: cudaError {rc}")
    return dict(zip(("registers", "spilled_bytes", "ctas_per_sm", "smem_bytes"),
                    (v.value for v in vals)))


def fused_knn_tiles(queries, corpus, m_corpus: int, k: int, q_tile: int,
                    c_tile: int, exclude_self: bool = True,
                    exclude_zero: bool = True, all_pairs: bool = True,
                    zero_eps: float = 0.0, compress: bool = False,
                    staged_corpus: StagedCorpus | None = None):
    """Per-(query, corpus-tile) local top-k -> (Q, n_c·k) dists and ids.
    ``staged_corpus``: the corpus's prologue outputs, staged once (read on
    the card only; the plain version reads ``corpus``)."""
    _check(queries, corpus, k, q_tile, c_tile)
    if queries.device.type == "cpu":
        outd, outi = _tiles_plain(queries, corpus, m_corpus, k, c_tile,
                                  exclude_self, exclude_zero, all_pairs,
                                  zero_eps, compress)
    elif compress:
        outd, outi = launch_compress(
            "fused_knn_tiles",
            *_stage_call(queries, corpus, staged_corpus, True), m_corpus, k,
            c_tile, exclude_self, all_pairs)
    else:
        outd, outi = launch_exact(
            "fused_knn_tiles",
            *_stage_call(queries, corpus, staged_corpus, False), m_corpus, k,
            c_tile, exclude_self, exclude_zero, all_pairs, zero_eps)
    return _candidate_lists(outd, outi)


def fused_knn_sweep(queries, corpus, m_corpus: int, k: int, q_tile: int,
                    c_tile: int, exclude_self: bool = True,
                    exclude_zero: bool = True, all_pairs: bool = True,
                    zero_eps: float = 0.0, compress: bool = False,
                    staged_corpus: StagedCorpus | None = None):
    """Full fused all-kNN: the final (Q, k) dists and ids. The kernel
    picks its own query sub-tile; the result does not depend on tiling.
    ``staged_corpus`` as for ``fused_knn_tiles``."""
    _check(queries, corpus, k, q_tile, c_tile)
    if queries.device.type == "cpu":
        return fused_knn_sweep_reference(
            queries, corpus, m_corpus, k, q_tile, c_tile, exclude_self,
            exclude_zero, all_pairs, zero_eps, compress,
        )
    if compress:
        return launch_compress(
            "fused_knn_sweep",
            *_stage_call(queries, corpus, staged_corpus, True), m_corpus, k,
            c_tile, exclude_self, all_pairs)
    return launch_exact(
        "fused_knn_sweep", *_stage_call(queries, corpus, staged_corpus, False),
        m_corpus, k, c_tile, exclude_self, exclude_zero, all_pairs, zero_eps)


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
    """(Q, c) masked squared-L2 distances of one corpus tile + its ids;
    in compress mode ``queries`` is the staged bf16 copy and the product
    is taken with the tile's."""
    if compress:
        tile_b, c_sq = stage_bf16_rows_reference(tile)
        xy = _mm_t(queries, tile_b)
    else:
        c_sq = sq_norms(tile)
        xy = _mm_t(queries, tile)
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
    if compress:
        queries, q_sq = stage_bf16_rows_reference(queries)
    else:
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


def fused_knn_sweep_split_reference(queries, corpus, m_corpus, k, q_tile,
                                    c_tile, exclude_self=True, all_pairs=True,
                                    slices=1, cols=SWEEP_COLS):
    """Plain model of K2[c]'s corpus split (tests only): the compress sweep
    over each of ``slices`` slices of the columns [0, min(C, m_corpus)),
    cut as ``compress_sweep_plan`` cuts them, then the slices' lists merged
    by (distance, column) as the group's last CTA merges them. Equal bit
    for bit to ``fused_knn_sweep_reference(..., compress=True)`` for every
    S."""
    _check(queries, corpus, k, q_tile, c_tile)
    qb, q_sq = stage_bf16_rows_reference(queries)
    c_end = min(corpus.shape[0], m_corpus)
    plan = compress_sweep_plan(queries.shape[0], c_end, 1, slices, cols)
    Q, dev = queries.shape[0], queries.device
    lists_d, lists_i = [], []
    for s in range(plan["slices"]):
        c0, c1 = s * plan["span"], min((s + 1) * plan["span"], c_end)
        d = torch.full((Q, k), float("inf"), device=dev)
        ids = torch.full((Q, k), INVALID_ID, dtype=torch.int32, device=dev)
        if c1 > c0:
            sd, si = _select(*_masked_tile(qb, q_sq, corpus[c0:c1], c0, m_corpus,
                                           exclude_self, False, all_pairs, 0.0,
                                           compress=True), k)
            d[:, :sd.shape[1]], ids[:, :si.shape[1]] = sd, si
        lists_d.append(d)
        lists_i.append(ids)
    return _select(torch.cat(lists_d, dim=1), torch.cat(lists_i, dim=1), k)
