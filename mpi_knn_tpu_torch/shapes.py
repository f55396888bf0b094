"""The port's shape rules, in plain integers: tile sizes, the clustered
search's tile and chunk widths, k-means' block widths and the sharded
exchange's route cap.

The search, build and serving code and the planner's memory model
(``analysis/memory.py``, ``plan.py``) read these same functions, so a
change to a rule moves the prediction with it. Nothing here imports torch.
"""

from __future__ import annotations

import math

from mpi_knn_tpu_torch.config import KNNConfig

# bytes of the exact finish's f64 copy of one row chunk's candidates
RERANK_CHUNK_BYTES = 1 << 30
# row-block width of k-means' assignment pass (the JAX package's)
ASSIGN_BLOCK = 2048
# rows a one-hot block of k-means' update covers: bounds its (k, rows) f64
# matrix
SUM_BLOCK = 65536
# held-out sample size of the nprobe tuning
TUNE_SAMPLE = 256


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest padded size >= n that is a multiple of `multiple` (>= 1)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return ((n + multiple - 1) // multiple) * multiple


# ---------------------------------------------------------------------------
# dense tiles


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


def serving_c_tile(cfg: KNNConfig, m: int) -> int:
    """The corpus tile of a serial serving index over ``m`` rows."""
    return cap_corpus_tile(cfg.query_tile,
                           min(cfg.corpus_tile, pad_to_multiple(m, 128)),
                           cfg.max_tile_elems)


def serving_corpus_rows(m: int, headroom: float, c_tile: int) -> int:
    """Rows a serial serving index pads its corpus to: the corpus and its
    ``bucket_headroom`` spare rows, to a multiple of the corpus tile."""
    return pad_to_multiple(max(m, int(math.ceil(m * (1.0 + headroom)))), c_tile)


def ring_tiles(cfg: KNNConfig, m: int, nq: int, dp: int, ring_n: int):
    """Per-rank tile sizes and padded global sizes: (q_tile, c_tile,
    q_pad, c_pad), the JAX package's policy."""
    num_dev = dp * ring_n
    c_tile = min(cfg.corpus_tile, -(-m // ring_n))
    q_tile = min(cfg.query_tile, -(-nq // num_dev))
    c_tile = cap_corpus_tile(q_tile, c_tile, cfg.max_tile_elems)
    c_pad = pad_to_multiple(m, ring_n * c_tile)
    q_pad = pad_to_multiple(nq, num_dev * q_tile)
    return q_tile, c_tile, q_pad, c_pad


# ---------------------------------------------------------------------------
# the clustered index


def padded_bucket_cap(largest: int, headroom: float) -> int:
    """The clustered store's bucket capacity: the largest bucket's rows
    times ``1 + headroom``, padded to a multiple of 8."""
    return pad_to_multiple(max(1, int(math.ceil(largest * (1.0 + headroom)))), 8)


def finish_rows(v: int, d: int) -> int:
    """Query rows a chunk of the exact finish takes at v candidates of
    width d."""
    return max(1, RERANK_CHUNK_BYTES // (8 * v * d))


def ivf_q_tile(cfg: KNNConfig, nprobe: int, bucket_cap: int, dim: int,
               nq: int) -> int:
    """An IVF batch's q_tile (the JAX package's rule): the probe gather
    holds q_tile · nprobe · bucket_cap · dim elements, so q_tile halves
    until that fits ``cfg.max_tile_elems`` (or reaches 1)."""
    q_tile = min(cfg.query_tile, pad_to_multiple(nq, 8))
    per_row = max(1, nprobe * bucket_cap * dim)
    while q_tile > 1 and q_tile * per_row > cfg.max_tile_elems:
        q_tile = max(1, q_tile // 2)
    return q_tile


def resolve_route_cap(cfg: KNNConfig, q_tile: int, nprobe: int) -> int:
    """The static per-(home, owner) route capacity of one query tile:
    ``cfg.ivf_route_cap`` clamped to the safe cap ``q_tile·nprobe``, or the
    safe cap itself when unset (no probe can drop)."""
    safe = max(1, q_tile * nprobe)
    if cfg.ivf_route_cap is None:
        return safe
    return min(cfg.ivf_route_cap, safe)


def exchange_elems(shards: int, route_cap: int, cap: int, dim: int) -> int:
    """Elements of one tile's largest exchange buffer, the (S, route_cap,
    cap, d) candidate rows."""
    return shards * route_cap * cap * dim


def exchange_bytes_per_tile(shards: int, route_cap: int, cap: int, dim: int,
                            itemsize: int, scale_bytes: int = 0) -> int:
    """Bytes one query tile's exchange moves a shard: the int32 request
    table, then per route the rows at the store's width (a quantized
    store's packed code lanes at itemsize 1), ids (int32), norms (f32) and
    ``scale_bytes`` (4 for a quantized store's per-row scale)."""
    per_route = 4 + cap * (dim * itemsize + 4 + 4 + scale_bytes)
    return shards * route_cap * per_route


def sharded_tile_elems(cfg: KNNConfig, nprobe: int, bucket_cap: int,
                       dim: int, shards: int, q_tile: int) -> int:
    """The larger of one sharded tile's finish (q_tile·nprobe·cap·d) and
    its exchange buffer (S·route_cap·cap·d), in elements."""
    rc = resolve_route_cap(cfg, q_tile, nprobe)
    return max(q_tile * max(1, nprobe * bucket_cap * dim),
               exchange_elems(shards, rc, bucket_cap, dim))


def sharded_q_tile(cfg: KNNConfig, nprobe: int, bucket_cap: int, dim: int,
                   nq: int, shards: int) -> int:
    """A sharded batch's q_tile: it halves until
    :func:`sharded_tile_elems` fits ``cfg.max_tile_elems`` (or reaches 1)."""
    q_tile = min(cfg.query_tile, pad_to_multiple(max(1, -(-nq // shards)), 8))
    while q_tile > 1 and sharded_tile_elems(
            cfg, nprobe, bucket_cap, dim, shards, q_tile) > cfg.max_tile_elems:
        q_tile = max(1, q_tile // 2)
    return q_tile
