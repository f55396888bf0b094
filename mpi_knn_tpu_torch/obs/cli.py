"""``python -m mpi_knn_tpu_torch metrics``: render, check and export the
observability artifacts without importing torch (the JAX package's
``obs/cli.py``; both read either package's files).

Two artifact families, one tool:

- a METRICS SNAPSHOT (the JSON ``MetricsRegistry.snapshot()`` form that
  ``query --metrics-out`` and the doctor verdict write) renders as
  Prometheus text exposition (default) or JSON; ``--check`` round-trips
  the exposition through the strict parser, a CI gate's proof that the
  export is machine-readable;
- a FLIGHT RECORD (the append-only span JSONL the recorder writes)
  summarizes by default, validates against the span schema with
  ``--validate`` (exit 1 on any problem), and exports to Chrome
  trace-event JSON loadable in Perfetto with ``--chrome OUT``.

Snapshot flags given with ``--flight`` (and flight flags without it) are
refused with exit 2: a check wired to the wrong artifact must fail
loudly, not pass without running.

Examples::

    python -m mpi_knn_tpu_torch metrics serve-metrics.json         # Prometheus
    python -m mpi_knn_tpu_torch metrics serve-metrics.json --format json
    python -m mpi_knn_tpu_torch metrics serve-metrics.json --check
    python -m mpi_knn_tpu_torch metrics --flight flight.jsonl      # summary
    python -m mpi_knn_tpu_torch metrics --flight flight.jsonl --validate
    python -m mpi_knn_tpu_torch metrics --flight flight.jsonl --chrome t.json
"""

from __future__ import annotations

import argparse
import json
import sys

from mpi_knn_tpu_torch.obs.metrics import (
    load_snapshot,
    parse_prometheus,
    to_prometheus,
)
from mpi_knn_tpu_torch.obs.spans import (
    read_flight,
    reconstruct_spans,
    summarize_flight,
    to_chrome_trace,
    validate_flight,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch metrics",
        description="render/check metrics snapshots and span flight "
        "records (mpi_knn_tpu_torch.obs)",
    )
    p.add_argument("snapshot", nargs="?", default=None,
                   help="metrics snapshot JSON (from `query "
                   "--metrics-out` or the doctor verdict)")
    p.add_argument("--format", choices=["prom", "json"], default=None,
                   help="snapshot output: Prometheus text exposition "
                   "(the default) or the JSON snapshot itself")
    p.add_argument("--check", action="store_true",
                   help="with a snapshot: render the exposition AND "
                   "re-parse it with the strict parser; exit 1 if either "
                   "fails (the CI gate)")
    p.add_argument("--flight", default=None, metavar="JSONL",
                   help="operate on a span flight record instead of a "
                   "metrics snapshot")
    p.add_argument("--validate", action="store_true",
                   help="with --flight: validate every record against "
                   "the span schema (no NaN/negative durations, ends "
                   "match opens, parents exist); exit 1 on any problem "
                   "or an empty record")
    p.add_argument("--chrome", default=None, metavar="OUT.json",
                   help="with --flight: export to Chrome trace-event "
                   "JSON (Perfetto/chrome://tracing)")
    return p


def _write_chrome(records, out: str) -> None:
    doc = to_chrome_trace(records)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"{len(doc['traceEvents'])} trace event(s) written to {out}")


def _flight_mode(args) -> int:
    records = read_flight(args.flight)
    if args.validate:
        problems = validate_flight(records)
        if not records:
            problems = [f"no records in {args.flight}"]
        for pb in problems:
            print(f"INVALID: {pb}", file=sys.stderr)
        spans, events = reconstruct_spans(records)
        print(json.dumps({
            "flight": args.flight,
            "records": len(records),
            "spans": len(spans),
            "events": len(events),
            "problems": len(problems),
        }))
        if args.chrome:
            # compose, never silently drop the export (the exit code is
            # still the validation's — a corrupt record's trace is worth
            # having open in Perfetto while debugging it)
            _write_chrome(records, args.chrome)
        return 1 if problems else 0
    if args.chrome:
        _write_chrome(records, args.chrome)
        return 0
    summary = summarize_flight(records)
    if summary is None:
        print(f"error: no records in {args.flight}", file=sys.stderr)
        return 1
    print(json.dumps(summary, indent=1))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if (args.flight is None) == (args.snapshot is None):
        print("error: give exactly one of SNAPSHOT or --flight JSONL",
              file=sys.stderr)
        return 2
    if args.flight is None and (args.validate or args.chrome):
        print("error: --validate/--chrome operate on a flight record "
              "(--flight)", file=sys.stderr)
        return 2
    if args.flight is not None and (args.check or args.format is not None):
        # the inert-knob refusal convention: a CI step wired as
        # `--flight F --check` must fail loudly, not "pass" a check that
        # silently never ran
        print("error: --check/--format operate on a metrics snapshot, "
              "not --flight", file=sys.stderr)
        return 2
    if args.flight is not None:
        return _flight_mode(args)
    try:
        snap = load_snapshot(args.snapshot)
    except (OSError, ValueError) as e:
        print(f"error: cannot load snapshot {args.snapshot!r}: {e}",
              file=sys.stderr)
        return 1
    if args.check:
        try:
            samples = parse_prometheus(to_prometheus(snap))
        except ValueError as e:
            print(f"error: exposition does not re-parse: {e}",
                  file=sys.stderr)
            return 1
        print(json.dumps({
            "snapshot": args.snapshot,
            "metrics": len(snap["metrics"]),
            "samples": len(samples),
            "ok": True,
        }))
        return 0
    if args.format == "json":
        print(json.dumps(snap, indent=1))
    else:  # prom (the default)
        sys.stdout.write(to_prometheus(snap))
    return 0


if __name__ == "__main__":
    sys.exit(main())
