"""Observability (the JAX package's ``obs/``): two pillars every claim
about the serving session reads its evidence from.

- :mod:`~mpi_knn_tpu_torch.obs.metrics`: the process-wide metrics
  registry (counters, gauges, fixed-bucket histograms with deterministic
  percentiles), the capture of the port's compiles (nvcc builds and
  serving entry builds), JSON and Prometheus text exposition;
- :mod:`~mpi_knn_tpu_torch.obs.spans`: the span flight recorder, trace
  spans (index build, entry builds, each batch's dispatch → retire, retry
  and ladder events, heartbeats, mutations) appended to a JSONL ring file
  so a SIGKILLed worker's record survives, with schema validation and a
  Chrome trace-event exporter.

``python -m mpi_knn_tpu_torch metrics`` (:mod:`~mpi_knn_tpu_torch.obs.
cli`) renders, validates and exports these artifacts. A third pillar
reads the card's own time: :mod:`~mpi_knn_tpu_torch.obs.kineto` parses a
``torch.profiler`` trace (the reference's ``xplane``) and
:mod:`~mpi_knn_tpu_torch.obs.attribution` reduces it to the per-category
device-time split ``ServeSession.profile`` and ``query
--profile-batches`` report.

Nothing here imports torch: supervisors read flight records and metrics
snapshots in processes that must never touch the card.
"""

from __future__ import annotations

_EXPORTS = {
    # metrics
    "Counter": "mpi_knn_tpu_torch.obs.metrics",
    "Gauge": "mpi_knn_tpu_torch.obs.metrics",
    "Histogram": "mpi_knn_tpu_torch.obs.metrics",
    "MetricsRegistry": "mpi_knn_tpu_torch.obs.metrics",
    "get_registry": "mpi_knn_tpu_torch.obs.metrics",
    "record_compile": "mpi_knn_tpu_torch.obs.metrics",
    "watch_compiles": "mpi_knn_tpu_torch.obs.metrics",
    "to_prometheus": "mpi_knn_tpu_torch.obs.metrics",
    "parse_prometheus": "mpi_knn_tpu_torch.obs.metrics",
    "load_snapshot": "mpi_knn_tpu_torch.obs.metrics",
    # spans
    "FlightRecorder": "mpi_knn_tpu_torch.obs.spans",
    "RECORDER_ENV": "mpi_knn_tpu_torch.obs.spans",
    "get_recorder": "mpi_knn_tpu_torch.obs.spans",
    "set_recorder": "mpi_knn_tpu_torch.obs.spans",
    "span": "mpi_knn_tpu_torch.obs.spans",
    "event": "mpi_knn_tpu_torch.obs.spans",
    "begin_span": "mpi_knn_tpu_torch.obs.spans",
    "end_span": "mpi_knn_tpu_torch.obs.spans",
    "read_flight": "mpi_knn_tpu_torch.obs.spans",
    "reconstruct_spans": "mpi_knn_tpu_torch.obs.spans",
    "summarize_flight": "mpi_knn_tpu_torch.obs.spans",
    "validate_flight": "mpi_knn_tpu_torch.obs.spans",
    "to_chrome_trace": "mpi_knn_tpu_torch.obs.spans",
    # kineto / attribution
    "ParseError": "mpi_knn_tpu_torch.obs.kineto",
    "parse_trace": "mpi_knn_tpu_torch.obs.kineto",
    "parse_trace_bytes": "mpi_knn_tpu_torch.obs.kineto",
    "find_traces": "mpi_knn_tpu_torch.obs.kineto",
    "analyze": "mpi_knn_tpu_torch.obs.kineto",
    "categorize": "mpi_knn_tpu_torch.obs.kineto",
    "attribute_trace": "mpi_knn_tpu_torch.obs.attribution",
    "pick_device_plane": "mpi_knn_tpu_torch.obs.attribution",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
