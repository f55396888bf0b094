"""``python -m mpi_knn_tpu_torch query``: build a resident corpus index,
stream query batches through it, report per-batch latency and end-to-end
throughput (the JAX package's ``serve/cli.py``, one controlling process).

The corpus is loaded and indexed once; query batches stream through the
bucketed engine with bounded dispatch-ahead (``mpi_knn_tpu_torch.serve``).
The summary reports how many bucket entries the run built, so "no entry
built in steady state" is visible per invocation.

Combinations the engine cannot honor exit 2 with the reason (a pallas
index with a cosine metric or a non-float32 dtype, mixed precision over a
bf16 index, the int8 wire without the mixed policy), and so do the JAX
package's refusals of knobs that would do nothing.

Resilience (``resilience/``): ``--batch-deadline-ms`` and ``--retries``
put the session under a policy (a per-batch deadline, retries of
transient faults, the NaN / all-inf sentinel, the degradation ladder);
``--degrade-after`` and ``--no-nan-sentinel`` shape it, and are refused
where they would do nothing. Observability (``obs/``): ``--flight-record``
writes the span flight record, ``--metrics-out`` the registry snapshot at
exit. ``--cache-dir`` keeps the kernel libraries nvcc builds in a
persistent cache (``serve/aotcache.py``; also ``TKNN_AOT_CACHE``).
``--index-load`` serves a saved clustered index (``build-index``, either
package's ``.npz``) at ``--nprobe`` (default: the index's tuned one); the
corpus-side flags baked into it (``--corpus-tile``, ``--dtype`` other than
the store's, the ring's flags) are refused beside it, and the report adds
its partitions, nprobe and at-rest bytes. The ring backends serve over
``--devices`` ranks of the one device (``--ring-schedule``,
``--ring-transfer-dtype``), and the report carries the rotation's static
wire bytes (``ring_transfer``). ``--index-load`` with ``--backend ring
--devices S`` serves the saved index sharded over S ranks
(``ivf/sharded.py``; ``--route-cap`` bounds its exchange), and the report
adds the exchange's story (``sharded``). ``--profile-batches N`` profiles
N more batches after the stream under ``torch.profiler`` and reports the
device-time split (``device_time``; ``--profile-dir`` keeps the trace).

Examples::

    python -m mpi_knn_tpu_torch query --data synthetic:512x32c4 \\
        --synthetic 100 --backend pallas --device cpu
    python -m mpi_knn_tpu_torch query --data synthetic:512x32c4 \\
        --synthetic 100 --backend ring-overlap --devices 4 \\
        --ring-schedule bidir --ring-transfer-dtype int8 \\
        --precision-policy mixed --device cpu
    python -m mpi_knn_tpu_torch query --data mnist --synthetic 10000 \\
        --k 10 --backend pallas --batch 256 --report serve.json
    python -m mpi_knn_tpu_torch query --data sift:100000 \\
        --index-load sift.ivf.npz --synthetic 10000 --batch 512 --k 10
    python -m mpi_knn_tpu_torch query --data synthetic:2048x32c8 \\
        --index-load i.npz --backend ring --devices 4 --route-cap 64 \\
        --synthetic 512 --batch 128 --device cpu --profile-batches 2
    python -m mpi_knn_tpu_torch query --data synthetic:512x32c4 \\
        --synthetic 100 --backend pallas --device cpu \\
        --batch-deadline-ms 50 --retries 2 --flight-record f.jsonl \\
        --metrics-out m.json
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
    RING_SCHEDULES,
    TOPK_METHODS,
    KNNConfig,
)
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE



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
    d.add_argument("--index-load", default=None, metavar="PATH.npz",
                   help="serve a saved clustered (IVF) index (from "
                   "`build-index`, either package's) instead of building a "
                   "dense one; --data still gives the query stream's "
                   "dimension and value range")
    d.add_argument("--nprobe", type=int, default=None,
                   help="partitions probed per query with --index-load "
                   "(default: the index's tuned nprobe)")
    d.add_argument("--route-cap", type=int, default=None,
                   help="with --index-load --backend ring: the static "
                   "per-(home, owner)-shard route capacity of the candidate "
                   "exchange per query tile (default: the safe cap "
                   "q_tile*nprobe, no probe drops); a smaller cap bounds "
                   "the exchange's memory and drops the overflow probes, "
                   "counted in the metrics and the report, never answered "
                   "wrong")

    k = p.add_argument_group("kNN / serving")
    k.add_argument("--k", type=int, default=30)
    k.add_argument("--metric", choices=METRICS, default="l2")
    k.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="serial, pallas, ring or ring-overlap (auto: "
                   "ring-overlap over --devices > 1 ranks, else serial)")
    k.add_argument("--devices", type=int, default=None,
                   help="ring size for the ring backends: ranks on the one "
                   "device")
    k.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16", "float64"],
                   help="resident/compute dtype (default float32); bfloat16 "
                   "stores the index at half width (serial); with "
                   "--index-load it must name the saved store's")
    k.add_argument("--query-tile", type=int, default=1024)
    k.add_argument("--corpus-tile", type=int, default=None,
                   help="corpus tile (default 2048; baked into a saved "
                   "clustered index)")
    k.add_argument("--precision-policy", choices=list(PRECISION_POLICIES),
                   default="exact")
    k.add_argument("--topk-method", choices=list(TOPK_METHODS),
                   default="exact")
    k.add_argument("--ring-schedule", choices=list(RING_SCHEDULES),
                   default=None, help="ring rotation schedule (default uni)")
    k.add_argument("--ring-transfer-dtype",
                   choices=["bfloat16", "float32", "int8"], default=None,
                   help="dtype of the corpus block on the rotation wire "
                   "(ring backends): int8 codes and scales (quantized once "
                   "at build, the resident shards hold them; requires "
                   "--precision-policy mixed)")
    k.add_argument("--bucket", type=int, default=1024,
                   help="base row bucket: batches pad to bucket*2^j rows and "
                   "each (bucket, config) entry is built once")
    k.add_argument("--dispatch-depth", type=int, default=2,
                   help="max batches in flight (2 = double buffering)")
    k.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="persistent cache of the kernel libraries "
                   "(serve/aotcache.py; also TKNN_AOT_CACHE): a library "
                   "nvcc builds is stored here and loaded by the next run "
                   "without a build; a damaged entry is rebuilt loudly")
    r = p.add_argument_group(
        "resilience (deadline, retry, sentinel, degradation ladder)")
    r.add_argument("--batch-deadline-ms", type=float, default=None,
                   metavar="MS",
                   help="per-batch latency deadline (dispatch -> retire); "
                   "on --degrade-after consecutive breaches the session "
                   "sheds one rung of the degradation ladder (smaller "
                   "nprobe -> mixed precision -> smaller bucket)")
    r.add_argument("--retries", type=int, default=None, metavar="N",
                   help="bounded exponential-backoff retries of a batch "
                   "dispatch on transient faults (default 2 when a "
                   "resilience policy is active)")
    r.add_argument("--degrade-after", type=int, default=None, metavar="N",
                   help="consecutive deadline breaches before shedding one "
                   "ladder rung (default 2)")
    r.add_argument("--no-nan-sentinel", action="store_true",
                   help="disable the NaN/all-inf sentinel on returned top-k "
                   "(on by default under a resilience policy)")
    o = p.add_argument_group("output / observability")
    o.add_argument("--tenant", default=None, metavar="NAME",
                   help="attribute this stream to a tenant id: a per-tenant "
                   "block in the summary and --report")
    o.add_argument("--report", default=None, help="write JSON report here")
    o.add_argument("--flight-record", default=None, metavar="JSONL",
                   help="record trace spans (index build, entry builds, each "
                   "batch's dispatch -> retire, retry and ladder events) to "
                   "this append-only JSONL ring file, written as they happen "
                   "so it survives a killed process; inspect with the "
                   "metrics subcommand's --flight")
    o.add_argument("--metrics-out", default=None, metavar="JSON",
                   help="write the metrics registry's snapshot at exit; "
                   "render it with the metrics subcommand")
    o.add_argument("--profile-batches", type=int, default=None, metavar="N",
                   help="after the stream, profile N more steady-state "
                   "batches under torch.profiler and put the per-category "
                   "device-time split in the summary and --report "
                   "(device_time)")
    o.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="with --profile-batches: keep the trace here "
                   "(default: a temporary directory)")
    o.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    o.add_argument("-q", "--quiet", action="store_true")
    return p


def _resilience_policy(args):
    """A ResiliencePolicy when a policy flag was given, else None. A knob
    that shapes a policy without one that activates it is refused (it
    would do nothing)."""
    if args.degrade_after is not None and args.batch_deadline_ms is None:
        # degradation is driven by deadline breaches
        raise ValueError(
            "--degrade-after without --batch-deadline-ms: degradation is "
            "triggered by deadline breaches, so the knob would be silently "
            "inert")
    if args.batch_deadline_ms is None and args.retries is None:
        if args.no_nan_sentinel:
            raise ValueError(
                "--no-nan-sentinel without --batch-deadline-ms or --retries: "
                "no resilience policy is active, so the knob would be "
                "silently inert")
        return None
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy

    return ResiliencePolicy(
        batch_deadline_s=(args.batch_deadline_ms / 1e3
                          if args.batch_deadline_ms is not None else None),
        max_retries=args.retries if args.retries is not None else 2,
        degrade_after=args.degrade_after if args.degrade_after is not None else 2,
        nan_sentinel=not args.no_nan_sentinel,
    )


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
    try:
        policy = _resilience_policy(args)
    except ValueError as e:
        # inert or invalid resilience knobs (a negative deadline, ...)
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.profile_dir is not None and args.profile_batches is None:
        # a kept trace directory without a profiling pass records nothing
        print("error: --profile-dir without --profile-batches: no "
              "profiling pass runs, so the knob would be silently inert",
              file=sys.stderr)
        return 2
    if args.profile_batches is not None and args.profile_batches < 1:
        print("error: --profile-batches must be >= 1", file=sys.stderr)
        return 2
    if args.flight_record:
        # before any index work, so the index build and the entry builds
        # land in the record; fresh: a new run does not append to an old one
        from mpi_knn_tpu_torch.obs.spans import FlightRecorder, set_recorder

        set_recorder(FlightRecorder(args.flight_record, fresh=True))
    if args.cache_dir:
        # before any kernel library loads
        from mpi_knn_tpu_torch.serve import aotcache

        aotcache.set_cache_dir(args.cache_dir)

    from mpi_knn_tpu_torch.cli import load_corpus
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.serve import ServeSession, build_index
    from mpi_knn_tpu_torch.utils.logs import setup_logging

    setup_logging(quiet=args.quiet)
    device = resolve_device(args.device)
    X, _, source = load_corpus(args.data, limit=args.limit)
    if args.limit is not None:
        X = X[:args.limit]
    if args.index_load:
        return _serve_loaded_index(args, X, source, device, policy)
    if args.nprobe is not None:
        # a probe count without a clustered index would be ignored
        print("error: --nprobe requires --index-load (probing is a "
              "clustered-index knob)", file=sys.stderr)
        return 2
    if args.route_cap is not None:
        print("error: --route-cap requires --index-load --backend ring "
              "(the route cap bounds the sharded clustered candidate "
              "exchange)", file=sys.stderr)
        return 2
    try:
        cfg = KNNConfig(
            k=args.k,
            metric=args.metric,
            backend=args.backend,
            dtype=args.dtype or "float32",
            query_tile=args.query_tile,
            corpus_tile=args.corpus_tile or 2048,
            precision_policy=args.precision_policy,
            topk_method=args.topk_method,
            ring_schedule=args.ring_schedule or "uni",
            ring_transfer_dtype=args.ring_transfer_dtype,
            num_devices=args.devices,
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
        session = ServeSession(index, resilience=policy, device=device)
    except ValueError as e:
        # the engine cannot honor this combination (pallas + cosine, a
        # compressed index + mixed, more ring ranks than devices allow)
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t_build0
    return _stream_and_report(args, session, index, X, source, build_s)


def _serve_loaded_index(args, X, source, device, policy) -> int:
    """``--index-load``: serve a saved clustered index through the same
    session. Corpus-side knobs come from the saved index; flags that
    conflict with it are refused, never dropped."""
    from mpi_knn_tpu_torch.ivf import load_ivf_index
    from mpi_knn_tpu_torch.serve import ServeSession

    sharded = args.backend == "ring"
    refusals = (
        (args.backend not in ("auto", "serial", "ring"),
         f"--index-load × --backend {args.backend} is not supported: a "
         "clustered index serves on one device (serial/auto) or sharded "
         "over the ring mesh (ring: the routed candidate exchange); the "
         "pallas kernels scan the full corpus by construction, and the "
         "exchange has no overlap schedule (use --backend ring, not "
         "ring-overlap)"),
        (args.metric != "l2",
         f"--index-load × --metric {args.metric} is not supported: the "
         "clustered index's k-means partitions and centroid score are "
         "L2 geometry"),
        (args.devices is not None and not sharded,
         "--devices with --index-load requires --backend ring (the shard "
         "count of the sharded clustered index); the single-device "
         "clustered search cannot honor it"),
        (args.route_cap is not None and not sharded,
         "--route-cap with --index-load requires --backend ring: the route "
         "cap bounds the sharded candidate exchange, and nothing is routed "
         "on one device"),
        (args.corpus_tile is not None,
         "--corpus-tile has no meaning with --index-load (the bucket "
         "layout was baked in at build time)"),
        (args.ring_transfer_dtype is not None,
         "--ring-transfer-dtype has no meaning with --index-load: the "
         "clustered search never rotates a ring, and the store's "
         "at-rest dtype was baked in at build time"),
        (args.ring_schedule is not None,
         "--ring-schedule has no meaning with --index-load (the "
         "clustered search never rotates a ring)"),
    )
    refusal = next((msg for cond, msg in refusals if cond), None)
    if refusal is not None:
        print(f"error: {refusal}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        index = load_ivf_index(args.index_load, device=device)
    except (OSError, KeyError, ValueError) as e:
        print(f"error: cannot load index {args.index_load!r}: {e}",
              file=sys.stderr)
        return 2
    if args.dtype is not None and args.dtype != index.cfg.dtype:
        print(f"error: --dtype {args.dtype} conflicts with the loaded "
              f"index's at-rest dtype ({index.cfg.dtype}); the dtype is "
              "baked in at build time", file=sys.stderr)
        return 2
    if X.shape[1] != index.dim:
        print(f"error: --data {args.data!r} has dim {X.shape[1]} but the "
              f"loaded index was built at dim {index.dim}", file=sys.stderr)
        return 2
    try:
        if sharded:
            # the layout is derived here from --devices: the saved file
            # holds none, so it serves on any shard count
            from mpi_knn_tpu_torch.ivf import shard_ivf_index

            index = shard_ivf_index(index, shards=args.devices,
                                    route_cap=args.route_cap)
        cfg = index.compatible_cfg(index.cfg.replace(
            k=args.k,
            query_tile=args.query_tile,
            precision_policy=args.precision_policy,
            topk_method=args.topk_method,
            nprobe=args.nprobe,  # None: the index's tuned default
            query_bucket=args.bucket,
            dispatch_depth=args.dispatch_depth,
        ))
        session = ServeSession(index, cfg, resilience=policy, device=device)
    except ValueError as e:
        # nprobe > partitions, mixed over a bf16 store, more shards than
        # devices, ...
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    return _stream_and_report(args, session, index, X, source,
                              time.perf_counter() - t0)


def _stream_and_report(args, session, index, X, source, build_s) -> int:
    """Stream the query batches, print per-batch latency lines, emit the
    summary and the report (the JAX serving summary's keys)."""
    from mpi_knn_tpu_torch.analysis.cost import detected_profile
    from mpi_knn_tpu_torch.serve.engine import index_peak_hbm_bytes

    cfg = session.cfg
    stream = _load_query_stream(args, X)
    t0 = time.perf_counter()
    n_batches = 0
    degraded_batches = 0
    for res in session.stream(stream, tenant=args.tenant):
        n_batches += 1
        degraded_batches += res.degraded is not None
        if not args.quiet:
            # the resilience stamps ride the batch's line, whose number is
            # the seq a sentinel trip or a degradation names
            extra = ""
            if res.degraded is not None:
                extra += f" degraded={res.degraded}"
            if res.retries:
                extra += f" retries={res.retries}"
            if res.deadline_breached:
                extra += " DEADLINE-BREACH"
            print(f"batch {res.seq}: rows={res.rows} bucket={res.bucket} "
                  f"latency={res.latency_s * 1e3:.2f}ms{extra}")
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
        # the shipped device profile the planner predicted q/s under
        # (analysis/cost.py), null off the profile map
        "device_profile": detected_profile(index.device),
    }
    if index.backend in ("ivf", "ivf-sharded"):
        summary["partitions"] = index.partitions
        summary["nprobe"] = cfg.nprobe
        summary["probe_fraction"] = round(cfg.nprobe / index.partitions, 4)
        # the at-rest level and the bytes it keeps resident and probes
        summary["at_rest"] = {
            "dtype": cfg.dtype,
            "resident_bytes": index.nbytes_resident,
            "probe_bytes_per_query": index.probe_bytes,
        }
    elif index.shards is not None:
        from mpi_knn_tpu_torch.backends.ring import ring_wire_bytes_per_batch

        # the transfer level and the static per-batch rotation bytes at
        # the wire dtype
        summary["ring_transfer"] = {
            "dtype": cfg.ring_transfer_dtype or cfg.dtype,
            "wire_bytes_per_batch": ring_wire_bytes_per_batch(
                cfg, sum(t[0].shape[0] for t in index.shards), index.dim,
                index.ring_meta[3]),
        }
        summary["resident_bytes"] = index.nbytes_resident
    from mpi_knn_tpu_torch.serve import aotcache

    disk = aotcache.active_cache()
    if disk is not None:
        # the cache's size and this process's hits, misses and errors
        from mpi_knn_tpu_torch.obs.metrics import get_registry

        reg = get_registry()
        summary["aot_cache"] = {
            **disk.stats(),
            **{kind: int(reg.counter(f"aot_cache_{kind}_total").value)
               for kind in ("hits", "misses", "errors")},
        }
    if session.policy is not None:
        # the degradation story beside the per-batch stamps
        summary["resilience"] = {
            "batch_deadline_ms": (session.policy.batch_deadline_s * 1e3
                                  if session.policy.batch_deadline_s is not None
                                  else None),
            "ladder": [label for label, _ in session.ladder],
            "staged_bytes": session.staged_bytes,
            "final_rung": session.rung,
            "degraded_batches": degraded_batches,
            "deadline_breaches": session.deadline_breaches,
            "retries_total": session.retries_total,
            "degradations": session.degradations,
        }
    if session.exchange is not None:
        # the sharded candidate exchange: routed probes, the overflow drops
        # a route cap costs (counted), the exchange's bytes and each
        # shard's load as owner
        summary["sharded"] = {
            "shards": session.exchange["shards"],
            "route_cap": cfg.ivf_route_cap,  # None: the safe cap
            "routed_total": session.exchange["routed_total"],
            "overflow_dropped_total": session.exchange["dropped_total"],
            "exchange_bytes_total": session.exchange["exchange_bytes_total"],
            "served_per_shard": session.exchange["served_per_shard"],
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
    if args.profile_batches:
        # the stream's shape (--batch rows, uniform over the corpus's
        # range); the session builds and warms their buckets before the
        # trace opens, so the trace holds serving, not set-up
        rng = np.random.default_rng(2)
        lo, hi = float(np.min(X)), float(np.max(X))
        prof_batches = [
            rng.uniform(lo, hi, size=(args.batch, X.shape[1])).astype(np.float32)
            for _ in range(args.profile_batches)
        ]
        summary["device_time"] = session.profile(prof_batches,
                                                 trace_dir=args.profile_dir)
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
    if args.metrics_out:
        from mpi_knn_tpu_torch.obs.metrics import get_registry

        with open(args.metrics_out, "w") as f:
            json.dump(get_registry().snapshot(), f, indent=1)
            f.write("\n")
        if not args.quiet:
            print(f"metrics snapshot written to {args.metrics_out}")
    if args.flight_record:
        from mpi_knn_tpu_torch.obs.spans import set_recorder

        set_recorder(None)  # close and flush
        if not args.quiet:
            print(f"flight record written to {args.flight_record}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(summary, f, indent=1)
            f.write("\n")
        if not args.quiet:
            print(f"report written to {args.report}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
