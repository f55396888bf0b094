"""``python -m mpi_knn_tpu_torch query``: build a resident corpus index,
stream query batches through it, report per-batch latency and end-to-end
throughput (the JAX package's ``serve/cli.py``, single device).

The corpus is loaded and indexed once; query batches stream through the
bucketed engine with bounded dispatch-ahead (``mpi_knn_tpu_torch.serve``).
The summary reports how many bucket entries the run built, so "no entry
built in steady state" is visible per invocation.

Combinations the engine cannot honor exit 2 with the reason (a pallas
index with a cosine metric or a non-float32 dtype, mixed precision over a
bf16 index, a ring backend), and so do the JAX CLI's flags whose layers
are not ported yet (IVF, the ring, resilience, flight record, metrics,
profiling, the AOT cache).

Examples::

    python -m mpi_knn_tpu_torch query --data synthetic:512x32c4 \\
        --synthetic 100 --backend pallas --device cpu
    python -m mpi_knn_tpu_torch query --data mnist --synthetic 10000 \\
        --k 10 --backend pallas --batch 256 --report serve.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from mpi_knn_tpu_torch.config import (
    BACKENDS,
    METRICS,
    PRECISION_POLICIES,
    TOPK_METHODS,
    KNNConfig,
)
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE

# the JAX CLI's flags whose layers the port does not have yet: (flag, takes
# a value), each refused with exit 2
UNPORTED_FLAGS = (
    ("--index-load", True), ("--nprobe", True), ("--route-cap", True),
    ("--devices", True), ("--ring-schedule", True),
    ("--ring-transfer-dtype", True), ("--batch-deadline-ms", True),
    ("--retries", True), ("--degrade-after", True),
    ("--no-nan-sentinel", False), ("--flight-record", True),
    ("--metrics-out", True), ("--profile-batches", True),
    ("--profile-dir", True), ("--cache-dir", True),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch query",
        description="streamed query serving against a resident corpus "
        "index (bucketed engine, per-bucket state built once)",
    )
    d = p.add_argument_group("data")
    d.add_argument("--data", default="mnist",
                   help="corpus spec, as the run command's --data: 'mnist', "
                   "'digits', 'synthetic:MxDcC', 'sift:M', a .fvecs/.bvecs "
                   "file or a .mat file")
    d.add_argument("--limit", type=int, default=None,
                   help="use the first N corpus rows only")
    q = p.add_mutually_exclusive_group()
    q.add_argument("--queries", default=None,
                   help=".npy/.mat/.fvecs/.bvecs file of query points, "
                   "streamed in --batch-row chunks")
    q.add_argument("--synthetic", type=int, default=None, metavar="N",
                   help="serve N synthetic query rows (uniform over the "
                   "corpus's value range, corpus dim) instead of a file")
    d.add_argument("--batch", type=int, default=256,
                   help="rows per streamed batch (the final batch may be "
                   "ragged; it pads to its bucket)")

    k = p.add_argument_group("kNN / serving")
    k.add_argument("--k", type=int, default=30)
    k.add_argument("--metric", choices=METRICS, default="l2")
    k.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="serial or pallas (auto resolves to serial on one "
                   "device); the ring backends are not served yet")
    k.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "float64"],
                   help="resident/compute dtype; bfloat16 stores the index "
                   "at half width (serial)")
    k.add_argument("--query-tile", type=int, default=1024)
    k.add_argument("--corpus-tile", type=int, default=2048)
    k.add_argument("--precision-policy", choices=list(PRECISION_POLICIES),
                   default="exact")
    k.add_argument("--topk-method", choices=list(TOPK_METHODS),
                   default="exact")
    k.add_argument("--bucket", type=int, default=1024,
                   help="base row bucket: batches pad to bucket*2^j rows and "
                   "each (bucket, config) entry is built once")
    k.add_argument("--dispatch-depth", type=int, default=2,
                   help="max batches in flight (2 = double buffering)")
    o = p.add_argument_group("output")
    o.add_argument("--tenant", default=None, metavar="NAME",
                   help="attribute this stream to a tenant id: a per-tenant "
                   "block in the summary and --report")
    o.add_argument("--report", default=None, help="write JSON report here")
    o.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    o.add_argument("-q", "--quiet", action="store_true")
    u = p.add_argument_group("not yet ported (exit 2; see ROADMAP.md)")
    for flag, takes_value in UNPORTED_FLAGS:
        u.add_argument(flag, default=None,
                       **({"metavar": "X"} if takes_value
                          else {"action": "store_true"}))
    return p


def _refused_flag(args) -> str | None:
    for flag, _ in UNPORTED_FLAGS:
        value = getattr(args, flag.lstrip("-").replace("-", "_"))
        if value not in (None, False):
            return flag
    return None


def _load_query_stream(args, X):
    """Iterator of numpy batches from --queries or --synthetic."""
    if args.synthetic is not None:
        rng = np.random.default_rng(1)
        lo, hi = float(np.min(X)), float(np.max(X))
        for s in range(0, args.synthetic, args.batch):
            n = min(args.batch, args.synthetic - s)
            yield rng.uniform(lo, hi, size=(n, X.shape[1])).astype(np.float32)
        return
    from mpi_knn_tpu_torch.cli import load_queries

    Q = load_queries(args.queries)
    if Q.ndim != 2 or Q.shape[1] != X.shape[1]:
        raise SystemExit(
            f"error: queries shape {Q.shape} does not match corpus dim "
            f"{X.shape[1]}"
        )
    for s in range(0, len(Q), args.batch):
        yield Q[s: s + args.batch]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refused = _refused_flag(args)
    if refused is not None:
        print(f"error: {refused}: not yet ported to mpi_knn_tpu_torch (see "
              "ROADMAP.md)", file=sys.stderr)
        return 2
    if args.queries is None and args.synthetic is None:
        print("error: provide a query stream (--queries FILE or "
              "--synthetic N)", file=sys.stderr)
        return 2
    if args.queries is not None and not os.path.isfile(args.queries):
        print(f"error: --queries {args.queries!r}: no such file",
              file=sys.stderr)
        return 2
    if args.batch < 1:
        print("error: --batch must be >= 1", file=sys.stderr)
        return 2
    if args.synthetic is not None and args.synthetic < 1:
        print("error: --synthetic must be >= 1", file=sys.stderr)
        return 2
    from mpi_knn_tpu_torch.serve.engine import _check_tenant

    try:
        _check_tenant(args.tenant)
    except ValueError as e:
        print(f"error: --tenant: {e}", file=sys.stderr)
        return 2

    from mpi_knn_tpu_torch.cli import load_corpus
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.serve import ServeSession, build_index
    from mpi_knn_tpu_torch.utils.logs import setup_logging

    setup_logging(quiet=args.quiet)
    device = resolve_device(args.device)
    X, _, source = load_corpus(args.data, limit=args.limit)
    if args.limit is not None:
        X = X[:args.limit]
    try:
        cfg = KNNConfig(
            k=args.k,
            metric=args.metric,
            backend=args.backend,
            dtype=args.dtype,
            query_tile=args.query_tile,
            corpus_tile=args.corpus_tile,
            precision_policy=args.precision_policy,
            topk_method=args.topk_method,
            query_bucket=args.bucket,
            dispatch_depth=args.dispatch_depth,
        )
    except ValueError as e:
        # an invalid knob combination: a loud usage error, never a
        # silently adjusted run
        print(f"error: {e}", file=sys.stderr)
        return 2

    t_build0 = time.perf_counter()
    try:
        index = build_index(X, cfg, device=device)
        session = ServeSession(index, device=device)
    except ValueError as e:
        # the engine cannot honor this combination (pallas + cosine, a
        # compressed index + mixed, a ring backend)
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t_build0
    return _stream_and_report(args, session, index, X, source, build_s)


def _stream_and_report(args, session, index, X, source, build_s) -> int:
    """Stream the query batches, print per-batch latency lines, emit the
    summary and the report (the JAX serving summary's keys)."""
    from mpi_knn_tpu_torch.serve.engine import index_peak_hbm_bytes

    cfg = session.cfg
    stream = _load_query_stream(args, X)
    t0 = time.perf_counter()
    n_batches = 0
    for res in session.stream(stream, tenant=args.tenant):
        n_batches += 1
        if not args.quiet:
            print(f"batch {res.seq}: rows={res.rows} bucket={res.bucket} "
                  f"latency={res.latency_s * 1e3:.2f}ms")
    wall = time.perf_counter() - t0

    lats = np.asarray(session.latencies)
    summary = {
        "corpus": source,
        "shape": list(X.shape),
        "backend": index.backend,
        "k": cfg.k,
        "queries": session.queries_served,
        "batches": n_batches,
        # PyTorch compiles nothing: the bucket entries this run built
        "executables_compiled": len(index._cache),
        "index_build_s": round(build_s, 4),
        "wall_s": round(wall, 4),
        "throughput_qps": round(session.queries_served / wall, 2)
        if wall > 0 else None,
        "latency_p50_ms": round(float(np.percentile(lats, 50)) * 1e3, 3)
        if len(lats) else None,
        "latency_p99_ms": round(float(np.percentile(lats, 99)) * 1e3, 3)
        if len(lats) else None,
        "peak_hbm_bytes": index_peak_hbm_bytes(index),
        # the JAX CLI's shipped roofline profile: none for this card yet
        "device_profile": None,
    }
    if session.tenant_stats:
        summary["tenants"] = {
            t: {
                "queries": st["queries"],
                "batches": st["batches"],
                "latency_sum_ms": round(st["latency_sum_s"] * 1e3, 3),
                "latency_max_ms": round(st["latency_max_s"] * 1e3, 3),
            }
            for t, st in sorted(session.tenant_stats.items())
        }
    if not args.quiet:
        print(
            f"[mpi_knn_tpu_torch query] {summary['queries']} queries in "
            f"{summary['batches']} batches: {summary['throughput_qps']} q/s "
            f"(p50 {summary['latency_p50_ms']}ms, "
            f"p99 {summary['latency_p99_ms']}ms, "
            f"{summary['executables_compiled']} bucket entr"
            f"{'y' if summary['executables_compiled'] == 1 else 'ies'} "
            f"built, index build {summary['index_build_s']}s)"
        )
    if args.report:
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
        if not args.quiet:
            print(f"report written to {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
