"""The port's device-memory model: the bytes each serving layout keeps
resident, and the transient bytes of its build and of one batch, stage by
stage, read off the code that allocates them.

The JAX package prices its peak with a liveness analysis over compiled
HLO plus a 6× slack on a tile's working set (its ``analysis/memory.py``
``R7_TEMP_SLACK``). Eager PyTorch allocates tensor by tensor, so the port
counts the tensors each stage holds at once instead, and takes no slack
beyond what the allocator itself adds: :func:`alloc` rounds every tensor
up to the CUDA caching allocator's 512-byte granularity and adds the up
to 1 MiB it may leave unsplit on a block above 1 MiB. The planner
(``plan.py``) and the doctor's plan line read these functions; the smoke
holds them against ``torch.cuda.max_memory_allocated`` on the card.

Clustered (IVF) search, one query tile (``ivf/search.py``; q = q_tile,
v = nprobe·bucket_cap, d = dim, P = partitions, l = the store's bytes a
row, s = the finish's chunk rows,
``shapes.finish_rows(v, d)`` capped at q):

====================  ===========================  ===================================
stage                 where                        live at its peak (bytes)
====================  ===========================  ===================================
score                 search.py:97-102,            q_sq 4q; xy, −2xy, sum, clamp 4qP
                      distance.py:124-132,         each (3 at once); sort values 4qP,
                      topk.py:77-86                positions 8qP
gather                search.py:105-113            rows q·v·l; ids, norms 4qv each;
                                                   scales 4qv (int8/int4); probe 8q·np
dequantize            quant.py:97-106, 65-73       int8: f32 copy 4qvd and product 4qvd;
(int8 / int4)                                      int4 also the nibbles 2·q·v·l and
                                                   their stack q·v·2l
widen (bfloat16)      search.py:129                f32 rows 4qvd beside the bf16 ones
finish products       rerank.py:81-85              f32 rows 4qvd, ids, norms (scales;
                                                   bfloat16: its gathered rows q·v·l);
                                                   c64 8svd, c64·c64 8svd, xy 8sv,
                                                   c_sq 8sv, q64 8sd
finish distances      rerank.py:86-87, 97-99,      c64 8svd, xy, c_sq 8sv each; the
                      topk.py:149-168              sum's two temporaries 8sv each, d
                                                   4sv, pair scale 8sv + 4sv, masks 3sv,
                                                   the masked tile 4sv
selection             topk.py:59-62, 89-120        d 4sv, sort values 4sv, positions
                                                   8sv, ids 4sk
====================  ===========================  ===================================

The rows of every finished chunk, (q, k) dists and ids, stay until the
tile is stacked (12qk). The build (``ivf/index.py:194-311``) holds the
centered corpus X (4md) from start to end, and on top of it:

====================  ===========================  ===================================
stage                 where                        live at its peak (bytes)
====================  ===========================  ===================================
k-means rounds        kmeans.py:102-125, 52-74     data64 8md, data_sq 4m; assignment
                                                   8m + min distance 4m, and their
                                                   blocks while they are joined (same
                                                   again); the one-hot block (bool and
                                                   f64) 9·P·b, b = min(m, 65536); the
                                                   far-point sort 12m
layout                index.py:268-281             assign, order, sa, within (and the
                                                   searchsorted beside it) 8m each;
                                                   buckets 4·P·cap·d, X[order] 4md,
                                                   ids 4·P·cap, order as int32 4m
quantize              quant.py:76-94, index.py:    f32 buckets; x·inv and its rounding
(int8 / int4)         283-292                      (4·P·cap·d each, two at once); then
                                                   codes, the dequantized f32 copy and
                                                   its product for the norms
tune (nprobe None)    index.py:314-361             the resident store; the sample's
                                                   rows; one search tile at every
                                                   nprobe the tuner tries
====================  ===========================  ===================================

Dense serving (``backends/serial.py``, the serial twolevel schedule; the
ring runs the same step per rank): one (q_tile, c_tile) step holds the
distance product and its three elementwise temporaries, the pair scale,
the masks and the masked tile (4·q·c each, the masks one byte), and the
tile's sort (12·q·c); the twolevel cascade keeps each tile's (q, k)
survivors (12·q·k a tile).

The tile, chunk and block widths are the port's own rules, read from
``shapes.py`` (the search and build code read the same functions) under
the ``KNNConfig`` the caller passes.

Rule R7 (:func:`r7_check`) holds a recorded run's live-bytes peak
(``utils/op_trace.py``) to the JAX package's budget and cross-checks it
against this model on the CPU (``MODEL_BAND``) and against the caching
allocator on the card (``ALLOCATOR_BAND``). Nothing here imports torch.
"""

from __future__ import annotations

import math

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.shapes import (
    ASSIGN_BLOCK,
    SUM_BLOCK,
    TUNE_SAMPLE,
    finish_rows,
    ivf_q_tile,
    pad_to_multiple,
)

ALLOC_ROUND = 512  # the caching allocator's block granularity
ALLOC_LARGE = 1 << 20  # above this a block may keep up to 1 MiB unsplit

# bytes a coordinate of a store at rest; int4 packs two a byte
STORE_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0, "int4": 0.5}
QUANT = ("int8", "int4")
# the cuBLAS workspace PyTorch keeps per (thread, stream) on sm_90 (its
# CUBLAS_WORKSPACE_CONFIG default, ":4096:8"), from the caching allocator
CUBLAS_WORKSPACE = 32 << 20


def alloc(nbytes: float) -> int:
    """Bytes the caching allocator counts for one tensor of ``nbytes``."""
    n = int(math.ceil(nbytes))
    if n <= 0:
        return 0
    n = -(-n // ALLOC_ROUND) * ALLOC_ROUND
    return n + (ALLOC_LARGE if n > ALLOC_LARGE else 0)


def live(*nbytes: float) -> int:
    """Allocator bytes of tensors live at once."""
    return sum(alloc(b) for b in nbytes)


def row_lanes(d: int, dtype: str) -> int:
    """Bytes one row of the store occupies at rest (codes, no scale)."""
    if dtype == "int4":
        return (d + 1) // 2
    return int(d * STORE_BYTES[dtype])


# ---------------------------------------------------------------------------
# clustered (IVF)

def ivf_resident_bytes(partitions: int, cap: int, d: int, dtype: str,
                       shards: int = 1) -> int:
    """A device's share of the clustered store: the buckets at rest, their
    ids and norms (and scales), and the replicated centroid table."""
    p_local = -(-partitions // shards)
    slots = p_local * cap
    store = live(slots * row_lanes(d, dtype), 4 * slots, 4 * slots,
                 4 * slots if dtype in QUANT else 0)
    return store + live(4 * partitions * d, 4 * partitions)


def ivf_tile_stages(q: int, nprobe: int, cap: int, d: int, partitions: int,
                    k: int, dtype: str) -> dict:
    """Live bytes of one query tile's stages (the module's first table),
    each the largest of its moments."""
    v = nprobe * cap
    s = min(q, finish_rows(v, d))
    lanes = row_lanes(d, dtype)
    P = partitions
    quant = dtype in QUANT
    side = (4 * q * v, 4 * q * v) + ((4 * q * v,) if quant else ())
    base = (4 * q, 8 * q * nprobe)  # q_sq, probe
    rest = q * v * lanes
    f32_rows = 4 * q * v * d
    stages = {
        # the product and two of its elementwise temporaries; then the
        # clamped tile beside the sort's values and positions
        "score": max(live(4 * q, 4 * q * P, 4 * q * P, 4 * q * P),
                     live(4 * q, 4 * q * P, 4 * q * P, 8 * q * P)),
        "gather": live(*base, rest, *side),
    }
    if dtype == "int8":
        stages["dequantize"] = live(*base, rest, *side, f32_rows, f32_rows)
    elif dtype == "int4":
        # the shifted nibbles and their stack; then the stack beside the
        # f32 copy and its product
        stages["dequantize"] = max(
            live(*base, rest, *side, rest, rest, 2 * rest),
            live(*base, rest, *side, 2 * rest, f32_rows, f32_rows))
    elif dtype == "bfloat16":
        stages["widen"] = live(*base, rest, *side, f32_rows)
    # the f32 rows and the finished chunks' results; a bfloat16 tile keeps
    # its gathered rows too (search.py:129 widens them in the call)
    held = (*base, f32_rows, *side, 12 * q * k,
            *((rest,) if dtype == "bfloat16" else ()))
    sv = s * v
    c64 = 8 * sv * d
    stages["finish products"] = live(*held, c64, c64, 8 * sv, 8 * sv,
                                     8 * s * d)
    stages["finish distances"] = max(
        # the distance expression: two f64 temporaries at a time
        live(*held, c64, 8 * sv, 8 * sv, 8 * sv, 8 * sv),
        # the pair scale beside the distances
        live(*held, c64, 8 * sv, 8 * sv, 4 * sv, 8 * sv, 4 * sv),
        # the masks: threshold, three boolean tiles, the masked tile
        live(*held, c64, 8 * sv, 8 * sv, 4 * sv, 4 * sv, 4 * sv,
             sv, sv, sv, 4 * sv))
    stages["selection"] = live(*held, 4 * sv, 4 * sv, 8 * sv, 4 * s * k)
    return stages


def ivf_build_stages(m: int, d: int, partitions: int, cap: int,
                     dtype: str) -> dict:
    """Live bytes of the build's stages before the nprobe tuning (the
    module's second table), each the largest of its moments; every figure
    includes the centered corpus."""
    P = partitions
    X = 4 * m * d
    b1 = min(m, SUM_BLOCK)
    b2 = min(max(m - SUM_BLOCK, 0), SUM_BLOCK)
    slots = P * cap
    lanes = row_lanes(d, dtype)
    res = (4 * m, 4 * P * d)  # the k-means result: assignments, centroids
    # the layout's locals, held to the end of the build: assign (int64),
    # order, sa, within; the ids table
    kept = (*res, 8 * m, 8 * m, 8 * m, 8 * m, 4 * slots)
    stages = {
        "kmeans": max(
            # the norms' square beside the corpus
            live(X, X, 4 * m),
            # a round: data64, norms, assignment and distances with their
            # blocks, the one-hot blocks (the next built while the last is
            # still bound, its boolean compare beside it)
            live(X, 8 * m * d, 4 * m, 8 * m, 4 * m, 8 * m, 4 * m,
                 8 * P * b1, P * max(b1, b2), 8 * P * b2,
                 12 * ASSIGN_BLOCK * P, 16 * P * d)),
        "layout": live(X, *res, 8 * m, 8 * m, 8 * m, 8 * m, 8 * m,
                       4 * slots * d, X, 4 * slots, 4 * m),
    }
    f32 = 4 * slots * d
    if dtype == "float32":
        stages["norms"] = live(X, *kept, f32, f32, 4 * slots)
    elif dtype == "bfloat16":
        stages["norms"] = max(live(X, *kept, f32, slots * lanes),
                              live(X, *kept, slots * lanes, f32, f32,
                                   4 * slots))
    else:
        stages["quantize"] = max(
            # |x| for the row maxima; then x·inv and its rounding beside
            # the int8 codes they narrow to
            live(X, *kept, f32, f32, 4 * slots),
            live(X, *kept, f32, f32, f32, slots * d, 12 * slots),
            # int4: the nibble halves and their packing
            live(X, *kept, f32, slots * d, 3 * slots * lanes, 12 * slots))
        stages["norms"] = live(X, *kept, slots * lanes, 4 * slots, f32,
                               f32, 4 * slots)
    return stages


def ivf_tune_peak(cfg: KNNConfig, m: int, d: int, partitions: int, cap: int,
                  dtype: str) -> int:
    """Transient bytes of the nprobe tuning beside the resident store: the
    corpus (still held by the build), the sample's rows and one search
    tile at each nprobe the tuner may try (every nprobe up to the
    partitions: the bisection's points lie between the doubling's)."""
    ns = min(TUNE_SAMPLE, m)
    held = live(4 * m * d, 4 * ns * d, 8 * ns, 4 * ns,
                4 * m, 8 * m)  # X, the sample rows, positions, flat ids
    worst = 0
    for n in range(1, partitions + 1):
        q = ivf_q_tile(cfg, n, cap, d, ns)
        worst = max(worst, max(ivf_tile_stages(q, n, cap, d, partitions,
                                               cfg.k, dtype).values()))
    return held + worst


def ivf_batch_bytes(rows: int, q_tile: int, d: int, k: int) -> int:
    """One batch's own device tensors: the padded query tiles and ids, and
    the stacked (q_pad, k) results."""
    q_pad = pad_to_multiple(rows, q_tile)
    return live(4 * q_pad * d, 4 * q_pad, 4 * q_pad * k, 8 * q_pad * k)


def entry_bytes(cfg: KNNConfig, bucket: int, q_tile: int, d: int) -> int:
    """The engine's entry (``serve/engine.py`` ``_new_entry``): its padded
    query ids, and ``cfg.dispatch_depth`` in-flight padded batches'
    queries and (dists, ids)."""
    q_pad = pad_to_multiple(bucket, q_tile)
    return live(4 * q_pad) + cfg.dispatch_depth * q_pad * (4 * d + 8 * cfg.k)


# ---------------------------------------------------------------------------
# dense (serial, ring)

def dense_step_peak(q: int, c: int, k: int, tiles: int) -> int:
    """One (q, c) step of the serial twolevel schedule, with every earlier
    tile's (q, k) survivors held for the cascade."""
    return live(4 * q * c, 4 * q * c, 4 * q * c, 4 * q * c, 4 * q * c,
                q * c, q * c, 4 * q * c, 4 * q * c, 8 * q * c,
                12 * q * k * (tiles + 1), 4 * q)


# ---------------------------------------------------------------------------
# R7-peak-memory over a recorded run (``analysis/rules.py`` wraps it)

R7_TEMP_SLACK = 6  # the JAX package's working-set slack
# The band R7 holds a cell's trace peak to on the card: the caching
# allocator's peak growth over the cell must lie within
# [peak_alloc − lo, peak_alloc + hi], ``peak_alloc`` the trace's peak with
# every storage rounded as :func:`alloc` rounds it. Below: the allocator
# cannot hold less than the storages the trace saw live at once, but a
# cell may free a storage made before it (1 MiB of slack for that, an
# unsplit block's worth). Above: the cuBLAS workspace of a stream that
# first calls cuBLAS inside the cell, and one unsplit large block.
ALLOCATOR_BAND = (ALLOC_LARGE, CUBLAS_WORKSPACE + ALLOC_LARGE)
# the band R7 holds the trace's rounded peak to against the port's model
# on the CPU, as a fraction of the modelled bytes: the model counts the
# tensors each stage holds at its largest moment, but not the few index
# vectors of under 1 KiB beside them (0.6 % at the lint's clustered cells)
MODEL_BAND = (0.25, 1.05)

LEDGER_TOL_REL = 0.02
LEDGER_TOL_ABS = 4096


def temp_budget_bytes(meta: dict) -> int:
    """The working-set allowance (the JAX package's): 6× the larger of the
    strict bound, 4·q_tile·c_tile and the registered extras, plus the
    extras only the peak needs, at the accumulation width."""
    from mpi_knn_tpu_torch.analysis.rules import R2_SLACK

    tile = R2_SLACK * meta["q_tile"] * meta["c_tile"]
    base = max(meta.get("budget_elems") or 0, tile, meta.get("extra_elems", 0))
    return (R7_TEMP_SLACK * base + meta.get("peak_extra_elems", 0)) \
        * meta["acc_bytes"]


def peak_budget_bytes(meta: dict) -> int:
    """The cell's inputs as the call stages them (``args_bytes``), its
    outputs, and the working-set allowance; never a largest-input floor.
    A served batch's device results count as outputs: the slot the engine
    preallocates is the host's staging, which the results are copied
    into. A mutation writes its store in place and has none."""
    outs = 0 if meta.get("mutate") else meta.get("out_bytes", 0)
    return meta.get("args_bytes", 0) + outs + temp_budget_bytes(meta)


def model_peak_bytes(target, meta: dict, cfg) -> int | None:
    """The port's model of a one-shot cell's transient peak, where it has
    one: an unsharded clustered search (a query tile's stages, plus the
    batch's own tensors), or a serial exact f32 search with the exact
    selection (a step at the cell's tiles, plus its padded inputs and
    results). None elsewhere."""
    if target.mutate or target.serve or target.backend == "ivf-sharded":
        return None
    if target.backend == "ivf":
        c = meta["cost"]
        q_pad = c["q"]
        stages = ivf_tile_stages(meta["q_tile"], c["nprobe"], c["bucket_cap"],
                                 c["d"], c["partitions"], cfg.k, cfg.dtype)
        return max(stages.values()) + ivf_batch_bytes(q_pad, meta["q_tile"],
                                                      c["d"], cfg.k)
    if target.backend == "serial" and target.policy == "exact" \
            and target.dtype == "float32" and cfg.topk_method == "exact":
        c = meta["cost"]
        tiles = c["c"] // meta["c_tile"]
        return (dense_step_peak(meta["q_tile"], meta["c_tile"], cfg.k, tiles)
                + live(meta.get("args_bytes", 0), meta.get("out_bytes", 0)))
    return None


def ledger_entry(trace, budget: int, measured, model) -> dict:
    big = max(trace.allocations(), key=lambda a: a[1], default=None)
    return {
        "peak_bytes": int(trace.peak_bytes),
        "peak_alloc_bytes": int(trace.peak_alloc),
        "budget_bytes": int(budget),
        "allocations": len(trace.allocations()),
        "largest_alloc": None if big is None else {
            "bytes": int(big[1]), "op": big[0].name, "index": big[0].index},
        "measured_bytes": measured,
        "model_bytes": model,
    }


def r7_check(ctx, trace) -> list:
    """(message, evidence) pairs of R7; stashes the ledger entry in
    ``ctx.meta["r7_analysis"]``."""
    meta = ctx.meta
    budget = peak_budget_bytes(meta)
    measured = meta.get("allocator_growth")
    model = (model_peak_bytes(ctx.target, meta, ctx.cfg)
             if ctx.stage == "cpu" else None)
    entry = ledger_entry(trace, budget, measured, model)
    meta["r7_analysis"] = entry
    out = []
    if trace.peak_bytes > budget:
        big = entry["largest_alloc"] or {}
        out.append((
            f"peak live bytes {trace.peak_bytes} > budget {budget} (inputs "
            f"{meta.get('args_bytes', 0)} + un-donated outputs + "
            f"{R7_TEMP_SLACK}× working set) — largest allocation "
            f"{big.get('bytes')}B {big.get('op')!r} at op {big.get('index')}",
            {"peak_bytes": trace.peak_bytes, "budget_bytes": budget}))
    if measured is not None:
        lo = trace.peak_alloc - ALLOCATOR_BAND[0]
        hi = trace.peak_alloc + ALLOCATOR_BAND[1]
        if not lo <= measured <= hi:
            out.append((
                f"the allocator's peak growth {measured} lies outside "
                f"[{lo}, {hi}] around the trace's rounded peak "
                f"{trace.peak_alloc}: the trace lost or invented storages",
                {"measured": measured, "peak_alloc": trace.peak_alloc}))
    if model is not None:
        lo, hi = MODEL_BAND[0] * model, MODEL_BAND[1] * model
        if not lo <= trace.peak_alloc <= hi:
            out.append((
                f"the trace's rounded peak {trace.peak_alloc} lies outside "
                f"[{int(lo)}, {int(hi)}] of the model's {model}: the model "
                "or the code moved",
                {"model": model, "peak_alloc": trace.peak_alloc}))
    return out


def _peak_culprit(cell: dict) -> str:
    big = cell.get("largest_alloc") or {}
    return (f"largest allocation {big.get('bytes')}B {big.get('op')!r} at op "
            f"{big.get('index')}")


def _ledger_spec():
    from mpi_knn_tpu_torch.analysis import ledger

    return ledger.LedgerSpec(
        kind="memory", schema_version=1,
        source="mpi_knn_tpu_torch.analysis.memory",
        regen_cmd="python -m mpi_knn_tpu_torch lint --device cpu --memory",
        tol_rel=LEDGER_TOL_REL, tol_abs=LEDGER_TOL_ABS,
        metrics=(ledger.MetricSpec(key="peak_bytes", noun="peak",
                                   culprit=_peak_culprit),),
    )


LEDGER_SPEC = _ledger_spec()
