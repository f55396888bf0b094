"""``python -m mpi_knn_tpu_torch plan`` — the capacity planner (the JAX
package's ``plan.py``, on the port's own models).

Given a corpus shape (m, d), k, a recall target, an offered q/s and a
fleet (device count, memory per device, a declared device profile),
search the configuration space — backend, partitions, nprobe, at-rest
dtype, shards, bucket headroom — and emit the port's ``build-index`` /
``serve`` commands with the predicted peak device bytes, bytes on the
wire and roofline q/s. Infeasible inputs are REFUSED with the named
binding constraint (exit 2, structured JSON): ``recall`` (target
unreachable even at nprobe == partitions for the permitted dtypes),
``hbm`` (the smallest feasible layout still overflows a device), or
``qps`` (offered rate above the roofline of every fitting config).

Where each number comes from:

- **Peak device bytes** (``source: "model"``): the port's own memory
  model (``analysis/memory.py``), tensor by tensor from the code that
  allocates them — the resident store of the port's layouts, the
  engine's entry, and the largest stage of the build and of one batch.
  The JAX package reads in-matrix configurations from its committed R7
  ledger; the port has no such ledger, so every prediction is the
  model's. The smoke holds it at or above the card's
  ``torch.cuda.max_memory_allocated`` growth over a build, a one-shot
  search and serving.
- **bucket_cap**: the largest k-means cluster at ``KMEANS_IMBALANCE``×
  the mean, measured on the port's own k-means (below).
- **Recall**: interpolated from the port's committed calibration
  (``analysis/plan_calibration.json``, written by
  ``tools/plan_calibration.py`` with the port's code on the CPU): recall
  against probe fraction, and each at-rest dtype's cap. Recall is a
  property of the algorithm, not of the chip.
- **q/s**: the closed-form FLOPs (``analysis.cost.analytical_mxu_flops``)
  and a byte-traffic model, fed to the roofline under the device profile.
  The f64 finish's products are priced at the profile's TF32×3 rate, far
  above the card's f64 rate, so the roofline stays an upper bound.

Torch-free at import: the planner answers on a machine with no card.
Only ``--device-profile auto`` (the default) imports torch, to read which
device this is.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys

from mpi_knn_tpu_torch import shapes
from mpi_knn_tpu_torch.analysis import cost as _cost
from mpi_knn_tpu_torch.analysis import memory as _memory
from mpi_knn_tpu_torch.config import KNNConfig

DEFAULT_CALIBRATION = (pathlib.Path(__file__).resolve().parent / "analysis"
                       / "plan_calibration.json")

# k-means skew allowance for the bucket_cap model: the build pads every
# bucket to the LARGEST cluster (ivf/index.py), so the planner budgets for
# the largest cluster, not the mean. The port's k-means (25 rounds,
# k-means++ from a seeded torch.Generator) on make_sift_like(m, seed=0),
# largest cluster / mean:
#
#   m        partitions  ratio   where
#   100000   256         3.11    the README deployment, H100 (PERF.md §5)
#   100000   2048        4.59    H100 (chip_smoke.py's plan_cli, PERF.md §5)
#   100000   256         2.92    CPU
#   2048     16          2.31    CPU
#   4096     32          2.56    CPU
#   8192     64          3.27    CPU
#   8192     128         4.52    CPU
#   8192     256         4.56    CPU
#   16384    64          3.71    CPU
#   16384    128         5.14    CPU
#   16384    256         5.14    CPU
#   16384    512         2.66    CPU
#   32768    128         4.07    CPU
#   32768    256         5.22    CPU
#   32768    512         2.33    CPU
#   65536    512         2.26    CPU
#   65536    1024        4.22    CPU
#   100000   512         2.25    CPU
#   100000   1024        4.13    CPU
#   100000   2048        5.57    CPU
#   16384    1024        4.56    CPU
#   32768    1024        4.28    CPU
#   65536    2048        5.28    CPU
#
# The ratio is no monotone function of the mean cluster size (the corpus
# draws from 256 generating centres: partitions near a multiple of them
# split blobs unevenly), so the allowance is one constant, the largest
# measured ratio rounded up: 5.6. The JAX package's 2.5 would predict a
# bucket_cap of 977 on the README deployment against the 1216 built.
KMEANS_IMBALANCE = 5.6

PLAN_BACKENDS = ("serial", "ring", "ivf", "ivf-sharded")
PLAN_DTYPES = tuple(_memory.STORE_BYTES)
PACKAGE = "python -m mpi_knn_tpu_torch"


# ---------------------------------------------------------------------------
# recall calibration


def load_calibration(path=DEFAULT_CALIBRATION) -> dict:
    """The planner's recall calibration: ``points`` — measured
    (probe_fraction, recall@k) pairs of the ``ivf_query`` nprobe sweep;
    ``dtype_scale`` — each at-rest dtype's recall relative to the float32
    store at the same nprobe (the quantization cap), the lower of the
    calibration corpus's (``ivf_at_rest``) and the denser corpus's
    (``ivf_at_rest_dense``, the README deployment's ``sift:100000``):
    quantization costs more recall where neighbours lie closer, and a
    planner that does not know the user's corpus takes the worse. The file
    has the JAX package's bench schema (``results`` rows of ``op``
    ``ivf_query`` and ``ivf_at_rest``; the reference's loader skips the
    dense rows). Raises loudly — a planner with no calibration must not
    guess."""
    doc = json.loads(pathlib.Path(path).read_text())
    points = sorted(
        (float(r["probe_fraction"]), float(r["recall_at_k"]))
        for r in doc["results"]
        if r.get("op") == "ivf_query" and "recall_at_k" in r
    )
    at_rest = {
        r["variant"].rsplit("-", 1)[-1]: float(r["recall_at_k"])
        for r in doc["results"]
        if r.get("op") == "ivf_at_rest" and "recall_at_k" in r
    }
    if not points or "float32" not in at_rest:
        raise ValueError(
            f"calibration {path} carries no ivf_query recall sweep / "
            "ivf_at_rest float32 row — regenerate it with "
            "`python tools/plan_calibration.py`"
        )
    scale = {dt: rec / at_rest["float32"] for dt, rec in at_rest.items()}
    dense = {
        r["variant"].rsplit("-", 1)[-1]: float(r["recall_at_k"])
        for r in doc["results"] if r.get("op") == "ivf_at_rest_dense"
    }
    for dt, rec in dense.items():
        scale[dt] = min(scale.get(dt, 1.0), rec / dense["float32"])
    return {"points": points, "dtype_scale": scale, "path": str(path)}


def predict_recall(fraction: float, dtype: str, calib: dict) -> float:
    """Recall@k at one probe fraction and at-rest dtype. Log-linear
    interpolation between the measured fractions; fraction 1.0 is the
    exact degenerate scan (recall 1.0 before the dtype cap); below the
    smallest measured fraction the first segment's slope extrapolates DOWN
    (never clamps up)."""
    scale = calib["dtype_scale"].get(dtype, 1.0)
    if fraction >= 1.0:
        return scale
    pts = calib["points"] + [(1.0, 1.0)]
    lo = pts[0]
    if fraction <= lo[0]:
        (x0, y0), (x1, y1) = pts[0], pts[1]
        t = (math.log(fraction) - math.log(x0)) / (
            math.log(x1) - math.log(x0)
        )
        return max(0.0, (y0 + t * (y1 - y0))) * scale
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if fraction <= x1:
            t = (math.log(fraction) - math.log(x0)) / (
                math.log(x1) - math.log(x0)
            )
            return (y0 + t * (y1 - y0)) * scale
    return scale


# ---------------------------------------------------------------------------
# the candidate configuration and its predicted numbers


@dataclasses.dataclass(frozen=True)
class Workload:
    m: int
    d: int
    k: int = 10
    recall_target: float = 0.95
    qps: float = 0.0  # offered queries/s the plan must sustain
    bucket: int = 1024  # serve row bucket (batch size of the roofline)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Fleet:
    devices: int = 1
    profile: str = _cost.DEFAULT_PROFILE
    hbm_bytes: int | None = None  # None = the profile's capacity
    hbm_headroom: float = 0.1  # memory fraction kept free per device

    def resolved(self) -> dict:
        prof = _cost.get_profile(self.profile)
        cap = self.hbm_bytes if self.hbm_bytes is not None \
            else int(prof["hbm_bytes"])
        return {**prof, "hbm_bytes": cap,
                "budget_bytes": int(cap * (1.0 - self.hbm_headroom))}

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Candidate:
    backend: str  # serial | ring | ivf | ivf-sharded
    dtype: str = "float32"
    partitions: int | None = None
    nprobe: int | None = None
    shards: int | None = None
    bucket_headroom: float = 0.0


class Infeasible(Exception):
    """No candidate satisfies every constraint. ``constraint`` names the
    BINDING one: the check that killed the candidate that got furthest
    (recall → hbm → qps, in evaluation order)."""

    def __init__(self, constraint: str, detail: str, candidate: dict,
                 rejected: dict):
        super().__init__(f"{constraint}: {detail}")
        self.constraint = constraint
        self.detail = detail
        self.candidate = candidate
        self.rejected = rejected


def bucket_cap_for(m: int, partitions: int, headroom: float) -> int:
    """The planner's model of the build's bucket capacity (ivf/index.py:
    ``pad(max_cluster · (1 + headroom))`` to a multiple of 8), with the
    largest cluster at ``KMEANS_IMBALANCE``× the mean, and never more rows
    than the corpus has."""
    need = min(m, math.ceil(m / partitions * KMEANS_IMBALANCE))
    return shapes.padded_bucket_cap(need, headroom)


def _cfg(wl: Workload) -> KNNConfig:
    """The serving config the planned commands run: the defaults, at the
    workload's k and bucket."""
    return KNNConfig(k=wl.k, query_bucket=wl.bucket)


def _dense_tiles(cand: Candidate, wl: Workload) -> tuple[int, int, int]:
    """(q_tile, c_tile, rows a device holds) of a dense candidate: the
    serial index's tiles (serve/index.py, engine.bucket_shapes), or the
    ring's (shapes.ring_tiles) over its ranks."""
    cfg = _cfg(wl)
    if cand.backend == "serial":
        q_tile = shapes.effective_tiles(cfg, wl.m, wl.bucket)[0]
        c_tile = shapes.serving_c_tile(cfg, wl.m)
        return q_tile, c_tile, shapes.serving_corpus_rows(
            wl.m, cand.bucket_headroom, c_tile)
    ring_n = cand.shards or 1
    q_tile, c_tile, _, c_pad = shapes.ring_tiles(cfg, wl.m, wl.bucket, 1,
                                                 ring_n)
    return q_tile, c_tile, c_pad // ring_n


def _ivf_shape(cand: Candidate, wl: Workload, rows: int) -> tuple[int, int]:
    """(bucket_cap, q_tile) of a clustered candidate serving batches of
    ``rows`` rows (shapes.ivf_q_tile; a sharded batch's tile also bounds
    its exchange, shapes.sharded_q_tile)."""
    cap = bucket_cap_for(wl.m, cand.partitions, cand.bucket_headroom)
    shards = cand.shards or 1
    if shards == 1:
        return cap, shapes.ivf_q_tile(_cfg(wl), cand.nprobe, cap, wl.d, rows)
    return cap, shapes.sharded_q_tile(_cfg(wl), cand.nprobe, cap, wl.d, rows,
                                      shards)


def _exchange_per_tile(cand: Candidate, wl: Workload, q_tile: int,
                       cap: int) -> int:
    """Bytes one sharded query tile's exchange moves a shard at the safe
    route cap (ivf/sharded.exchange_wire_args: a quantized store's code
    lanes at one byte and its scale)."""
    rc = shapes.resolve_route_cap(_cfg(wl), q_tile, cand.nprobe)
    if cand.dtype in _memory.QUANT:
        wire = (_memory.row_lanes(wl.d, cand.dtype), 1, 4)
    else:
        wire = (wl.d, int(_memory.STORE_BYTES[cand.dtype]), 0)
    return shapes.exchange_bytes_per_tile(cand.shards, rc, cap, *wire)


def _resident_bytes(cand: Candidate, wl: Workload) -> int:
    """Per-device resident bytes: what the index holds on a device before
    any batch runs (its ``engine._resident_bytes``)."""
    if cand.backend in ("serial", "ring"):
        _, _, rows = _dense_tiles(cand, wl)
        return _memory.live(4 * rows * wl.d, 4 * rows, 4 * rows)
    cap = bucket_cap_for(wl.m, cand.partitions, cand.bucket_headroom)
    return _memory.ivf_resident_bytes(cand.partitions, cap, wl.d,
                                      cand.dtype, cand.shards or 1)


def predict_peak_hbm(cand: Candidate, wl: Workload, *,
                     tuned_build: bool = False,
                     batch_rows: int | None = None) -> dict:
    """Per-device predicted peak bytes of deploying ``cand``: the largest
    of the build's stages, the nprobe tuning's (when the build tunes it:
    ``tuned_build``), a one-shot search of ``batch_rows`` device-resident
    queries (default: one bucket) and a serving batch beside the engine's
    entry — each stage read off the code by ``analysis/memory.py`` — plus
    the cuBLAS workspace of the host thread that runs the products.
    ``stages`` names each moment's bytes."""
    rows = batch_rows or wl.bucket
    resident = _resident_bytes(cand, wl)
    stages: dict = {}
    if cand.backend in ("serial", "ring"):
        q_tile, c_tile, held = _dense_tiles(cand, wl)
        tiles = held // c_tile
        stages["build"] = _memory.live(4 * wl.m * wl.d) + resident
        step = _memory.dense_step_peak(q_tile, c_tile, wl.k, tiles)
        entry = _memory.entry_bytes(_cfg(wl), wl.bucket, q_tile, wl.d)
        stages["serve"] = resident + entry + step
        q_pad = shapes.pad_to_multiple(rows, q_tile)
        stages["search"] = resident + _memory.live(
            4 * q_pad * wl.d, 4 * rows * wl.d, 12 * q_pad * wl.k) + step
    else:
        shards = cand.shards or 1
        cap, q_tile = _ivf_shape(cand, wl, wl.bucket)
        for name, b in _memory.ivf_build_stages(
                wl.m, wl.d, cand.partitions, cap, cand.dtype).items():
            stages[f"build {name}"] = b
        if tuned_build:
            stages["tune"] = resident + _memory.ivf_tune_peak(
                _cfg(wl), wl.m, wl.d, cand.partitions, cap, cand.dtype)
        tile = max(_memory.ivf_tile_stages(
            q_tile, cand.nprobe, cap, wl.d, cand.partitions, wl.k,
            cand.dtype).values())
        entry = _memory.entry_bytes(_cfg(wl), wl.bucket, q_tile, wl.d)
        stages["serve"] = resident + entry + tile
        _, q_one = _ivf_shape(cand, wl, rows)
        one = max(_memory.ivf_tile_stages(
            q_one, cand.nprobe, cap, wl.d, cand.partitions, wl.k,
            cand.dtype).values())
        stages["search"] = resident + _memory.live(4 * rows * wl.d) + \
            _memory.ivf_batch_bytes(rows, q_one, wl.d, wl.k) + one
        if shards > 1:
            # a shard's slice of the store and its exchange buffers: every
            # owner's gathered candidates and every home's received tile
            stages["serve"] += _memory.alloc(
                2 * _exchange_per_tile(cand, wl, q_tile, cap))
    peak = max(stages.values()) + _memory.CUBLAS_WORKSPACE
    return {"peak_hbm_bytes": int(peak), "source": "model",
            "resident_bytes": int(resident),
            "stages": {k: int(v) for k, v in stages.items()}}


def _wire_bytes(cand: Candidate, wl: Workload) -> int:
    """Per-batch link bytes, at the wire dtype: the ring's uni rotation
    (backends/ring.ring_wire_bytes_per_batch: (P − 1)·P blocks of rows and
    their int32 ids), the sharded exchange at its safe route cap
    (shapes.exchange_bytes_per_tile, every tile)."""
    if cand.backend == "ring" and (cand.shards or 1) > 1:
        ring_n = cand.shards
        _, _, b = _dense_tiles(cand, wl)
        block = b * (wl.d * 4 + 4)
        return (ring_n - 1) * ring_n * block
    if cand.backend == "ivf-sharded":
        cap, q_tile = _ivf_shape(cand, wl, wl.bucket)
        qt = shapes.pad_to_multiple(wl.bucket, cand.shards * q_tile) // q_tile
        return int(qt * _exchange_per_tile(cand, wl, q_tile, cap))
    return 0


def _cost_facts(cand: Candidate, wl: Workload) -> dict:
    """The closed-form FLOP facts of one planned batch."""
    if cand.backend in ("serial", "ring"):
        ring_n = cand.shards or 1
        _, _, rows = _dense_tiles(cand, wl)
        return {"scheme": "dense", "q": wl.bucket, "c": rows,
                "d": wl.d, "sites": 1, "trips": ring_n,
                "queries": wl.bucket}
    cap = bucket_cap_for(wl.m, cand.partitions, cand.bucket_headroom)
    shards = cand.shards or 1
    return {"scheme": "ivf", "q": max(1, wl.bucket // shards),
            "d": wl.d, "partitions": cand.partitions,
            "nprobe": cand.nprobe, "bucket_cap": cap,
            "queries": wl.bucket}


def _hbm_traffic(cand: Candidate, wl: Workload) -> int:
    """Per-device bytes one batch must move through device memory — the
    roofline's memory leg: the dense backends read the resident store
    once a query tile; the clustered ones read the centroid table a
    tile and each query's probed buckets at rest (rows, ids, norms, and
    scales), and every backend reads its queries and writes its
    results."""
    io = wl.bucket * wl.d * 4 + wl.bucket * wl.k * 8
    if cand.backend in ("serial", "ring"):
        q_tile = _dense_tiles(cand, wl)[0]
        qtiles = shapes.pad_to_multiple(wl.bucket, q_tile) // q_tile
        return qtiles * _resident_bytes(cand, wl) + io
    cap, q_tile = _ivf_shape(cand, wl, wl.bucket)
    qtiles = shapes.pad_to_multiple(wl.bucket, q_tile) // q_tile
    shards = cand.shards or 1
    q_local = max(1, wl.bucket // shards)
    quant = cand.dtype in _memory.QUANT
    row = _memory.row_lanes(wl.d, cand.dtype) + 4 + 4 + (4 if quant else 0)
    gather = q_local * cand.nprobe * cap * row
    cents = qtiles * cand.partitions * wl.d * 4
    return int(cents + gather + io)


def predict_qps(cand: Candidate, wl: Workload, profile: dict) -> dict:
    """Roofline q/s of the planned config under one device profile."""
    flops = _cost.analytical_mxu_flops(_cost_facts(cand, wl))
    hbm = _hbm_traffic(cand, wl)
    ici = _wire_bytes(cand, wl)
    roof = _cost.roofline(flops, hbm, ici, wl.bucket, profile)
    return {"mxu_flops": int(flops), "hbm_bytes": int(hbm),
            "wire_bytes": int(ici), **roof}


# ---------------------------------------------------------------------------
# the search


def _candidates(wl: Workload, fleet: Fleet, backends, dtypes,
                bucket_headroom: float):
    """Deterministic candidate enumeration. Dense candidates are
    float32/exact (the recall-1.0 anchors); clustered candidates sweep
    power-of-two partition counts around √m across the permitted
    at-rest dtypes."""
    if fleet.devices == 1:
        dense = ["serial"] if "serial" in backends else []
        clustered = ["ivf"] if "ivf" in backends else []
        shards = None
    else:
        dense = ["ring"] if "ring" in backends else []
        clustered = ["ivf-sharded"] if "ivf-sharded" in backends else []
        shards = fleet.devices
    for b in dense:
        if "float32" in dtypes:
            yield Candidate(backend=b, shards=shards,
                            bucket_headroom=bucket_headroom)
    parts = []
    p = 8
    while p <= max(8, wl.m // 8):
        parts.append(p)
        p *= 2
    root = math.sqrt(wl.m)
    parts = [p for p in parts if root / 8 <= p <= root * 8] or parts[:1]
    for b in clustered:
        for dt in PLAN_DTYPES:
            if dt not in dtypes:
                continue
            for p in parts:
                if shards is not None and p < shards:
                    continue
                yield Candidate(backend=b, dtype=dt, partitions=p,
                                shards=shards,
                                bucket_headroom=bucket_headroom)


def _min_nprobe(cand: Candidate, wl: Workload, calib: dict):
    """Smallest nprobe reaching the recall target (recall is monotone in
    probe fraction), or None when even the exact scan misses it. No
    nprobe probes less than the smallest calibrated fraction: below it
    ``predict_recall`` extrapolates, and the port's own tuner found the
    extrapolation high (on ``sift:100000`` at 256 partitions nprobe 1,
    1/256, reads under 0.95 where it predicts 0.983)."""
    lowest = math.ceil(calib["points"][0][0] * cand.partitions - 1e-9)
    for n in range(max(1, lowest), cand.partitions + 1):
        if predict_recall(
            n / cand.partitions, cand.dtype, calib
        ) >= wl.recall_target:
            return n
    return None


def plan(wl: Workload, fleet: Fleet, *, backends=PLAN_BACKENDS,
         dtypes=PLAN_DTYPES, bucket_headroom: float = 0.0,
         calib: dict | None = None) -> dict:
    """Search the configuration space and return the best feasible plan
    (highest roofline q/s; ties break toward the leaner store). Raises
    :class:`Infeasible` with the named binding constraint otherwise."""
    calib = calib if calib is not None else load_calibration()
    prof = fleet.resolved()
    feasible = []
    rejected = {"recall": 0, "hbm": 0, "qps": 0}
    # the furthest-failing candidate names the binding constraint; among
    # same-stage failures the BEST one makes the refusal honest
    closest = None
    STAGE = {"recall": 0, "hbm": 1, "qps": 2}

    def reject(constraint, cand_doc, detail, score=0.0):
        nonlocal closest
        rejected[constraint] += 1
        key = (STAGE[constraint], score)
        if closest is None or key > (closest[0], closest[1]):
            closest = (*key, cand_doc, constraint, detail)

    for cand in _candidates(wl, fleet, backends, dtypes, bucket_headroom):
        doc = dataclasses.asdict(cand)
        # -- recall ----------------------------------------------------
        if cand.backend in ("serial", "ring"):
            recall = 1.0
            if wl.recall_target > 1.0:
                reject("recall", doc,
                       f"recall target {wl.recall_target} exceeds 1.0")
                continue
        else:
            n = _min_nprobe(cand, wl, calib)
            if n is None:
                ceiling = predict_recall(1.0, cand.dtype, calib)
                reject(
                    "recall", doc,
                    f"recall target {wl.recall_target} unreachable at "
                    f"max nprobe: even the exact nprobe=partitions="
                    f"{cand.partitions} scan predicts "
                    f"{ceiling:.4f} on a {cand.dtype} store (the "
                    "measured quantization cap, "
                    "mpi_knn_tpu_torch/analysis/plan_calibration.json)",
                    score=ceiling,
                )
                continue
            cand = dataclasses.replace(cand, nprobe=n)
            doc = dataclasses.asdict(cand)
            recall = predict_recall(n / cand.partitions, cand.dtype, calib)
        # -- hbm -------------------------------------------------------
        peak = predict_peak_hbm(cand, wl)
        if peak["peak_hbm_bytes"] > prof["budget_bytes"]:
            reject(
                "hbm", doc,
                f"predicted peak HBM {peak['peak_hbm_bytes']} B/device "
                f"exceeds the budget {prof['budget_bytes']} B "
                f"({fleet.devices} × {prof['hbm_bytes']} B at "
                f"{fleet.hbm_headroom:.0%} headroom) — resident store "
                f"{peak['resident_bytes']} B dominates",
                score=-peak["peak_hbm_bytes"],
            )
            continue
        # -- qps -------------------------------------------------------
        perf = predict_qps(cand, wl, prof)
        if wl.qps and perf["qps"] < wl.qps:
            reject(
                "qps", doc,
                f"offered {wl.qps:.0f} q/s exceeds the roofline "
                f"{perf['qps']:.0f} q/s (bound: {perf['bound']} leg "
                f"of profile {fleet.profile!r})",
                score=perf["qps"],
            )
            continue
        feasible.append((cand, recall, peak, perf))

    if not feasible:
        _, _, cand_doc, constraint, detail = closest
        raise Infeasible(constraint, detail, cand_doc, rejected)

    cand, recall, peak, perf = max(
        feasible,
        key=lambda f: (f[3]["qps"], -f[2]["resident_bytes"]),
    )
    cap = (None if cand.partitions is None
           else bucket_cap_for(wl.m, cand.partitions, cand.bucket_headroom))
    return {
        "feasible": True,
        "workload": wl.to_json(),
        "fleet": {**fleet.to_json(), "profile_facts": prof},
        "config": dataclasses.asdict(cand),
        "predicted": {
            "recall_at_k": round(recall, 4),
            "bucket_cap": cap,
            "resident_bytes": peak["resident_bytes"],
            "peak_hbm_bytes": peak["peak_hbm_bytes"],
            "peak_hbm_source": peak["source"],
            "peak_hbm_stages": peak["stages"],
            "wire_bytes_per_batch": perf["wire_bytes"],
            "mxu_flops_per_batch": perf["mxu_flops"],
            "hbm_bytes_per_batch": perf["hbm_bytes"],
            "qps": round(perf["qps"], 1),
            "wall_s_per_batch": perf["wall_s"],
            "roofline_bound": perf["bound"],
        },
        "rejected": rejected,
        "commands": _commands(cand, wl, fleet),
    }


# ---------------------------------------------------------------------------
# command emission


def _commands(cand: Candidate, wl: Workload, fleet: Fleet,
              data: str | None = None,
              index_out: str = "plan.ivf.npz") -> dict:
    """The port's commands that deploy this plan: dense layouts boot the
    HTTP front end on the corpus; a clustered store is built once by
    ``build-index`` and the front end boots the saved file
    (``serve --index-load``), every at-rest dtype included."""
    data = data or f"synthetic:{wl.m}x{wl.d}"
    out = {}
    serve = [
        PACKAGE, "serve", "--data", data, "--k", str(wl.k),
        "--bucket", str(wl.bucket),
    ]
    if cand.backend in ("serial", "ring"):
        serve += ["--backend",
                  "serial" if cand.backend == "serial" else "ring"]
        if cand.backend == "ring":
            serve += ["--devices", str(fleet.devices)]
        out["serve"] = " ".join(serve)
        return out
    build = [
        PACKAGE, "build-index", "--data", data,
        "--partitions", str(cand.partitions),
        "--nprobe", str(cand.nprobe),
        "--dtype", cand.dtype, "--k", str(wl.k),
        "--out", index_out,
    ]
    if cand.bucket_headroom:
        build += ["--bucket-headroom", str(cand.bucket_headroom)]
    if cand.backend == "ivf-sharded":
        build += ["--backend", "ring"]
    out["build_index"] = " ".join(build)
    serve += ["--index-load", index_out]
    if cand.backend == "ivf-sharded":
        serve += ["--backend", "ring", "--devices", str(fleet.devices)]
    out["serve"] = " ".join(serve)
    return out


# ---------------------------------------------------------------------------
# CLI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch plan",
        description="capacity planner: solve for a serving configuration "
        "from corpus shape, recall target, offered QPS, and fleet; exit 2 "
        "+ structured refusal naming the binding constraint (recall/hbm/"
        "qps) when infeasible",
    )
    w = p.add_argument_group("workload")
    w.add_argument("--corpus", type=int, required=True, metavar="M",
                   help="corpus rows")
    w.add_argument("--dim", type=int, required=True, metavar="D",
                   help="corpus dimensionality")
    w.add_argument("--k", type=int, default=10)
    w.add_argument("--recall-target", type=float, default=0.95,
                   help="predicted recall@k the plan must reach "
                   "(calibrated from analysis/plan_calibration.json)")
    w.add_argument("--qps", type=float, default=0.0,
                   help="offered queries/s the roofline must sustain "
                   "(0 = no throughput constraint)")
    w.add_argument("--bucket", type=int, default=1024,
                   help="serve row bucket (the roofline's batch size)")
    f = p.add_argument_group("fleet")
    f.add_argument("--devices", type=int, default=1)
    f.add_argument("--device-profile", default="auto",
                   help="declared device profile (analysis/"
                   "device_profiles.json: cpu-test, h100-sxm-80gb); auto "
                   "(default): this machine's card if one is visible, "
                   "else the CPU's — refused on a card with no profile")
    f.add_argument("--hbm-bytes", type=int, default=None,
                   help="per-device memory capacity override (default: "
                   "the profile's)")
    f.add_argument("--hbm-headroom", type=float, default=0.1,
                   help="memory fraction kept free per device")
    s = p.add_argument_group("search space")
    s.add_argument("--backend", action="append", choices=PLAN_BACKENDS,
                   help="restrict the searched backends; repeatable")
    s.add_argument("--dtype", action="append", choices=PLAN_DTYPES,
                   help="restrict the searched at-rest dtypes; "
                   "repeatable (forcing int4 is how a recall refusal "
                   "becomes reachable)")
    s.add_argument("--bucket-headroom", type=float, default=0.0,
                   help="mutation headroom built into the planned "
                   "bucket_cap")
    o = p.add_argument_group("output")
    o.add_argument("--data", default=None,
                   help="corpus spec to embed in the emitted commands "
                   "(default: synthetic:MxD)")
    o.add_argument("--index-out", default="plan.ivf.npz",
                   help="index artifact path in the emitted "
                   "build-index command")
    o.add_argument("--calibration", default=None, metavar="PATH",
                   help="recall calibration (default: mpi_knn_tpu_torch/"
                   "analysis/plan_calibration.json)")
    o.add_argument("-q", "--quiet", action="store_true",
                   help="JSON only (no human summary line on stderr)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    profile = args.device_profile
    if profile == "auto":
        facts = _cost.detected_profile()
        if facts is None:
            print("error: no shipped device profile for this machine's "
                  "device; name one with --device-profile", file=sys.stderr)
            return 2
        profile = facts["name"]
    wl = Workload(m=args.corpus, d=args.dim, k=args.k,
                  recall_target=args.recall_target, qps=args.qps,
                  bucket=args.bucket)
    fleet = Fleet(devices=args.devices, profile=profile,
                  hbm_bytes=args.hbm_bytes,
                  hbm_headroom=args.hbm_headroom)
    try:
        calib = load_calibration(args.calibration or DEFAULT_CALIBRATION)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        doc = plan(
            wl, fleet,
            backends=tuple(args.backend or PLAN_BACKENDS),
            dtypes=tuple(args.dtype or PLAN_DTYPES),
            bucket_headroom=args.bucket_headroom,
            calib=calib,
        )
    except KeyError as e:  # unknown profile
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    except Infeasible as e:
        print(json.dumps({
            "feasible": False,
            "binding_constraint": e.constraint,
            "detail": e.detail,
            "closest_candidate": e.candidate,
            "rejected": e.rejected,
            "workload": wl.to_json(),
            "fleet": fleet.to_json(),
        }, indent=1))
        if not args.quiet:
            print(f"plan: INFEASIBLE — {e.constraint}: {e.detail}",
                  file=sys.stderr)
        return 2
    doc["commands"] = _commands(
        Candidate(**doc["config"]), wl, fleet,
        data=args.data, index_out=args.index_out,
    )
    print(json.dumps(doc, indent=1))
    if not args.quiet:
        pred = doc["predicted"]
        print(
            f"plan: {doc['config']['backend']} "
            f"(dtype {doc['config']['dtype']}"
            + (f", partitions {doc['config']['partitions']}, nprobe "
               f"{doc['config']['nprobe']}"
               if doc["config"]["partitions"] else "")
            + f") on {profile} — recall {pred['recall_at_k']}, peak "
            f"{pred['peak_hbm_bytes']} B/device [{pred['peak_hbm_source']}]"
            f", {pred['qps']} q/s ({pred['roofline_bound']}-bound)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
