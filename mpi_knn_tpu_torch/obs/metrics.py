"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms, and the capture of the port's compiles (the JAX package's
``obs/metrics.py``).

Why fixed buckets: serving percentiles must be assertable. A test (or a
CI gate) that says "p99 under 50 ms" needs the same answer from the same
observations every time, on every platform. A fixed-bucket histogram
quantizes each observation into a predetermined bucket, so
:meth:`Histogram.percentile` is a deterministic function of the counts
(the upper bound of the bucket the quantile falls in), never an
interpolation over a float stream.

Why one registry: :func:`get_registry` is the single process-wide sink
every instrumented layer writes to (the serving engine, the AOT cache,
live mutation, the kernel build), so "zero steady-state compiles" is a
registry fact that any consumer (tests, ``python -m mpi_knn_tpu_torch
metrics``, the doctor verdict) can read.

Compiles. The reference counts XLA backend compiles through
``jax.monitoring`` (``jax_compiles_total``, ``jax_compile_seconds``). The
port has two kinds of compile and counts both through
:func:`record_compile`:

- ``nvcc``: a kernel library built from ``csrc/`` (``ops/_build.py``),
  counted in ``nvcc_builds_total`` / ``nvcc_build_seconds``;
- ``entry``: the serving engine's per-(bucket, config) state built once
  (``serve/engine.py``), counted in ``serve_entry_builds_total`` /
  ``serve_entry_build_seconds``.

:func:`watch_compiles` yields a list that grows by the kind of each
compile in its scope, from every thread, as the reference's grows by one
event per XLA compile.

Export: :meth:`MetricsRegistry.snapshot` is the JSON form;
:func:`to_prometheus` renders a snapshot as Prometheus text exposition,
and :func:`parse_prometheus` is the strict re-parser a CI gate uses to
prove the exposition is well-formed. Snapshots and expositions are the
reference's formats: each package's parser reads the other's output.

Labels: counters and gauges accept a ``labels`` dict. The metric is
registered under its canonical sample name (``name{key="value"}``, keys
sorted), so every (name, labels) combination is its own monotonic series
and the exposition emits one ``HELP``/``TYPE`` header per base name.
Histograms take no labels (the ``_bucket`` suffix belongs between the
base name and the label set, which name-keyed storage cannot express).

No torch import: the resilience supervisors import through here.
"""

from __future__ import annotations

import contextlib
import json
import math
import threading

# latency histograms (seconds): sub-ms serving batches up to the
# multi-second compile/build tail; +Inf overflow bucket is implicit
DEFAULT_LATENCY_BUCKETS_S = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# compile durations: a serving entry builds in milliseconds, an nvcc build
# of a kernel library takes seconds to minutes
COMPILE_BUCKETS_S = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)

# the two kinds of compile the port has, as watch_compiles names them
COMPILE_KINDS = ("nvcc", "entry")


def _valid_metric_name(name: str) -> bool:
    return bool(name) and not name[0].isdigit() and all(
        c.isalnum() or c in "_:" for c in name
    )


def sample_name(name: str, labels: dict | None = None) -> str:
    """The canonical exposition sample name for (name, labels):
    ``name`` bare, or ``name{k="v",...}`` with keys sorted so the same
    label set always produces the same registry key. Label values that
    would need exposition escaping (quotes, backslashes, newlines) are
    rejected loudly — a tenant id is an identifier, not free text."""
    if not _valid_metric_name(name):
        raise ValueError(f"bad metric name {name!r}")
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        if not _valid_metric_name(k) or ":" in k:
            raise ValueError(f"bad label name {k!r} for metric {name!r}")
        v = str(labels[k])
        if any(c in v for c in ('"', "\\", "\n")):
            raise ValueError(
                f"label value {v!r} for {name}{{{k}}} needs escaping; "
                "use plain identifier-like values"
            )
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"


class Counter:
    """Monotonic counter. Negative increments are a caller bug and raise
    (a counter that can go down silently corrupts every rate read off
    it)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not (n >= 0.0) or not math.isfinite(n):
            raise ValueError(f"counter {self.name}: bad increment {n!r}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        # under the lock: a scrape races inc() from serving threads
        with self._lock:
            return {"kind": self.kind, "help": self.help,
                    "value": self._value}


class Gauge:
    """Last-set value (queue depth, current ladder rung index, …)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        if not math.isfinite(v):
            raise ValueError(f"gauge {self.name}: non-finite value {v!r}")
        with self._lock:
            self._value = float(v)

    def add(self, n: float) -> None:
        if not math.isfinite(n):
            raise ValueError(f"gauge {self.name}: non-finite delta {n!r}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "help": self.help,
                    "value": self._value}


class Histogram:
    """Fixed-bucket histogram (upper bounds + implicit +Inf overflow).

    Percentiles are deterministic: the quantile's bucket upper bound, a
    pure function of the counts — assertable in tests and stable across
    runs/platforms, which a streaming-quantile sketch is not.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(not math.isfinite(b) for b in bounds) or \
                list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name}: buckets must be finite, strictly "
                f"increasing and non-empty, got {buckets!r}"
            )
        self.name = name
        self.help = help
        self.buckets = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            # a NaN latency is an upstream bug; swallowing it would make
            # every percentile read off this histogram silently wrong
            raise ValueError(f"histogram {self.name}: non-finite {v!r}")
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """The upper bound of the bucket holding the q-th percentile
        (q in [0, 100]); +Inf when it falls in the overflow bucket,
        NaN when the histogram is empty."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile {q!r} not in [0, 100]")
        with self._lock:
            count = self._count
            counts = list(self._counts)
        if count == 0:
            return math.nan
        rank = max(1, math.ceil(count * q / 100.0))
        cum = 0
        for j, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return (
                    self.buckets[j] if j < len(self.buckets) else math.inf
                )
        return math.inf  # unreachable

    def snapshot(self) -> dict:
        # counts/sum/count must come from ONE critical section: a scrape
        # racing observe() otherwise exports counts summing to count±1 —
        # a torn histogram no strict re-parser can detect (the numbers
        # are each individually plausible)
        with self._lock:
            return {
                "kind": self.kind,
                "help": self.help,
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class MetricsRegistry:
    """Name → metric, get-or-create. A name re-requested with a
    different kind (or different histogram buckets) raises — two call
    sites silently sharing a name across kinds would corrupt both."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        # base family name -> metric class: the kind-collision guard must
        # key on the part BEFORE the label set, or a labeled counter and
        # a bare gauge sharing one base would coexist and render a
        # mixed-kind family under a single TYPE header (malformed
        # exposition a real scraper mis-types)
        self._kinds: dict[str, type] = {}

    def _get_or_create(self, cls, name, help, **kw):
        base = name.split("{", 1)[0]
        with self._lock:
            known = self._kinds.get(base)
            if known is not None and known is not cls:
                raise ValueError(
                    f"metric family {base!r} already registered as "
                    f"{known.kind}, requested {cls.kind}"
                )
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[name] = m
                self._kinds[base] = cls
                return m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        if kw.get("buckets") is not None and \
                tuple(float(b) for b in kw["buckets"]) != m.buckets:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                "buckets"
            )
        return m

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get_or_create(Counter, sample_name(name, labels), help)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get_or_create(Gauge, sample_name(name, labels), help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS_S,
                  labels: dict | None = None) -> Histogram:
        if labels:
            raise ValueError(
                f"histogram {name!r}: labels are not supported (the "
                "_bucket suffix belongs between the base name and the "
                "label set, which name-keyed storage cannot express) — "
                "keep per-label latency in caller state instead"
            )
        return self._get_or_create(
            Histogram, sample_name(name), help, buckets=buckets
        )

    def snapshot(self) -> dict:
        """JSON-able snapshot of every metric (sorted by name — the
        stable on-disk form ``mpi-knn metrics`` renders)."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {
            "schema": "mpi_knn_tpu.obs.metrics/1",
            "metrics": {name: m.snapshot() for name, m in items},
        }

    def to_prometheus(self) -> str:
        return to_prometheus(self.snapshot())

    def clear(self) -> None:
        """Drop every metric (test isolation / a fresh reporting
        window)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()


_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every instrumented layer writes to."""
    return _default_registry


# ---------------------------------------------------------------------------
# Prometheus text exposition


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def to_prometheus(snapshot: dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` document as Prometheus
    text exposition format (histograms as cumulative ``_bucket{le=...}``
    series plus ``_sum``/``_count``)."""
    out = []
    # labeled series share one HELP/TYPE header per BASE name (the part
    # before the label set) — duplicate TYPE lines for one metric family
    # are malformed exposition
    seen_bases: set[str] = set()
    for name, m in snapshot.get("metrics", {}).items():
        kind = m["kind"]
        base = name.split("{", 1)[0]
        if base not in seen_bases:
            seen_bases.add(base)
            if m.get("help"):
                out.append(f"# HELP {base} {m['help']}")
            out.append(f"# TYPE {base} {kind}")
        if kind in ("counter", "gauge"):
            out.append(f"{name} {_prom_num(m['value'])}")
        elif kind == "histogram":
            cum = 0
            for b, c in zip(m["buckets"], m["counts"]):
                cum += c
                out.append(f'{name}_bucket{{le="{_prom_num(b)}"}} {cum}')
            cum += m["counts"][-1]
            out.append(f'{name}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{name}_sum {_prom_num(m['sum'])}")
            out.append(f"{name}_count {m['count']}")
        else:
            raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
    return "\n".join(out) + ("\n" if out else "")


def parse_prometheus(text: str) -> dict[str, float]:
    """Strict parser for the exposition format this module emits —
    the CI gate's proof that the export is machine-readable, not just
    printable. Returns ``{sample_name[{labels}]: value}``; malformed
    lines raise ValueError."""
    samples: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not name:
            raise ValueError(f"line {lineno}: no sample name: {line!r}")
        base = name.split("{", 1)[0]
        if not base or not all(
            c.isalnum() or c in "_:" for c in base
        ) or base[0].isdigit():
            raise ValueError(f"line {lineno}: bad metric name {base!r}")
        if "{" in name and not name.endswith("}"):
            raise ValueError(f"line {lineno}: unterminated labels: {name!r}")
        try:
            v = float(value)
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad sample value {value!r}"
            ) from None
        if name in samples:
            raise ValueError(f"line {lineno}: duplicate sample {name!r}")
        samples[name] = v
    if not samples:
        raise ValueError("no samples in exposition")
    return samples


def load_snapshot(path: str) -> dict:
    """Read a snapshot JSON written by ``--metrics-out`` (or any
    ``snapshot()`` dump); schema-checked so the CLI fails loudly on a
    file that merely looks like JSON. A doctor VERDICT nests the
    registry snapshot under its own ``"metrics"`` key — unwrap it by its
    schema marker, so ``mpi-knn metrics verdict.json`` works as the CLI
    help documents."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        inner = doc.get("metrics")
        if isinstance(inner, dict) and str(
            inner.get("schema", "")
        ).startswith("mpi_knn_tpu.obs.metrics/"):
            doc = inner
    if not isinstance(doc, dict) or not isinstance(
        doc.get("metrics"), dict
    ) or not all(
        isinstance(m, dict) and "kind" in m for m in doc["metrics"].values()
    ):
        raise ValueError(f"{path}: not a metrics snapshot (no 'metrics' map)")
    return doc


# ---------------------------------------------------------------------------
# the port's compile capture

_watch_lock = threading.Lock()
_watchers: list[list] = []

_COMPILE_METRICS = {
    "nvcc": ("nvcc_builds_total", "kernel libraries built by nvcc",
             "nvcc_build_seconds", "nvcc build durations"),
    "entry": ("serve_entry_builds_total",
              "serving (bucket, config) entries built",
              "serve_entry_build_seconds", "serving entry build durations"),
}


def record_compile(kind: str, secs: float) -> None:
    """Count one compile of ``kind`` ("nvcc" or "entry") taking ``secs``
    in the default registry, and report it to every open
    :func:`watch_compiles` scope."""
    if kind not in _COMPILE_METRICS:
        raise ValueError(f"unknown compile kind {kind!r}: {COMPILE_KINDS}")
    counter, chelp, hist, hhelp = _COMPILE_METRICS[kind]
    reg = get_registry()
    reg.counter(counter, help=chelp).inc()
    try:
        reg.histogram(hist, help=hhelp, buckets=COMPILE_BUCKETS_S).observe(secs)
    except ValueError:
        # a non-finite duration must not fail the build that reported it
        reg.counter(
            "compile_bad_duration_total",
            help="compiles whose duration was non-finite",
        ).inc()
    with _watch_lock:
        for events in _watchers:
            events.append(kind)


@contextlib.contextmanager
def watch_compiles():
    """Count the port's compiles over a scope: the one machine check behind
    every "this built nothing" assertion. Yields a list that grows by the
    kind ("nvcc" or "entry") of each compile any thread records while the
    scope is open; the same compiles also feed the shared registry."""
    events: list[str] = []
    with _watch_lock:
        _watchers.append(events)
    try:
        yield events
    finally:
        with _watch_lock:
            _watchers.remove(events)
