"""Device-time attribution: what the device spent a profiled window on
(the JAX package's ``obs/attribution.py``, over a ``torch.profiler``
trace instead of an XPlane).

:func:`attribute_trace` parses every trace file a profiled run wrote
(``obs/kineto.py``), picks the plane that carries the device work (a
``/device:GPU:<i>`` plane where the trace has one, else the host's) and
reduces it to the per-category busy split the serving report embeds
beside its p50 / p99: matmul / sort-topk / collective / copy / dma-wait /
other, with the collective-under-matmul overlap fraction.

``dma_wait_ms`` is 0.0 on every CUDA trace. The reference splits the
fused rotation's in-kernel semaphore stalls out of compute because the
TPU trace emits them as events; K4's waits on its neighbours' flags emit
none, so on a card that time stays inside the kernel's duration. The key
and the category are kept; the zero is the absence of such events, not a
measured zero wait.

Invariant: the per-category milliseconds sum to ``busy_total_ms`` (every
event carries exactly one category, and host events are cut to their self
time), so a report whose categories sum past the total is a parser bug.
"""

from __future__ import annotations

from mpi_knn_tpu_torch.obs.kineto import analyze, find_traces, parse_trace


def _busy_total(plane_report: dict) -> float:
    return round(sum(plane_report["busy_ms_by_category"].values()), 3)


def pick_device_plane(planes: dict) -> str | None:
    """The plane to attribute: the busiest device plane ('/device:...'),
    else the busiest plane (a CPU-only trace has only '/host:CPU')."""
    if not planes:
        return None
    device = [p for p in planes if "/device:" in p]
    pool = device or list(planes)
    return max(pool, key=lambda p: _busy_total(planes[p]))


def attribute_trace(trace_dir: str, top: int = 10) -> dict:
    """Per-category device-time split of one profiled run.

    Returns ``busy_ms`` (category → ms over the chosen plane),
    ``busy_total_ms`` (their sum), the collective totals,
    ``overlap_fraction`` (collective time hidden under matmul ÷ collective
    time; the span form where the trace has async pairs, else the
    busy-interval form; None without collectives), ``dma_wait_ms``,
    ``top_ops_ms``, and the plane and file census. A run with no parseable
    events returns ``{"error": ...}``, never a zero-filled split."""
    files = find_traces(trace_dir)
    if not files:
        return {"error": f"no trace .json under {trace_dir}"}
    planes: dict = {}
    casualties = []
    for f in files:
        try:
            for plane, rep in analyze(parse_trace(f), top=top).items():
                # one plane in several files (several captures): keep the
                # busier, never merge disjoint runs
                if plane not in planes or \
                        _busy_total(rep) > _busy_total(planes[plane]):
                    planes[plane] = rep
        except (ValueError, OSError) as e:
            casualties.append({"file": f, "error": f"{type(e).__name__}: {e}"})
    chosen = pick_device_plane(planes)
    if chosen is None:
        return {
            "error": f"no events parsed from {len(files)} trace file(s)",
            "casualties": casualties,
        }
    rep = planes[chosen]
    coll = rep["collective_total_ms"]
    span = rep["collective_span_ms"]
    if span > 0:
        frac = rep["collective_span_overlapped_with_matmul_ms"] / span
    elif coll > 0:
        frac = rep["collective_overlapped_with_matmul_ms"] / coll
    else:
        frac = None
    out = {
        "plane": chosen,
        "planes_seen": sorted(planes),
        "busy_ms": dict(rep["busy_ms_by_category"]),
        "busy_total_ms": _busy_total(rep),
        "collective_ms": coll,
        "collective_overlapped_with_matmul_ms":
            rep["collective_overlapped_with_matmul_ms"],
        "collective_span_ms": span,
        "collective_span_overlapped_with_matmul_ms":
            rep["collective_span_overlapped_with_matmul_ms"],
        "overlap_fraction": None if frac is None else round(frac, 4),
        # no wait events on a CUDA trace: the category exists, empty
        "dma_wait_ms": rep["busy_ms_by_category"].get("dma-wait", 0.0),
        "top_ops_ms": dict(rep["top_ops_ms"]),
    }
    if casualties:
        out["casualties"] = casualties
    return out
