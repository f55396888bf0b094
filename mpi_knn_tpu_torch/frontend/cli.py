"""The ``serve``, ``loadgen`` and ``router`` subcommands: the network front
end, its load generator and the replicated tier (the JAX package's
``frontend/cli.py``).

``serve`` builds a resident index over ``--data`` (the run CLI's corpus
specs) on ``--platform`` (``auto`` and ``cuda``: the card; ``cpu``: the
plain versions of the kernels), wraps a
:class:`~mpi_knn_tpu_torch.serve.ServeSession` in the coalescing front end,
and listens on a loopback (or given) HTTP port: ``POST /query`` (JSON or
raw f32 rows, ``X-Tenant`` header), ``POST /upsert`` / ``/delete``, ``GET
/metrics`` (Prometheus exposition), ``GET /healthz``. ``--port 0`` binds an
ephemeral port; ``--ready-file`` writes the final URL once the server is
listening (a script's rendezvous: parsing a log for a port number is a
race, a file appearing is not).

``loadgen`` drives a running server with open-loop multi-tenant load and
prints/writes the throughput-vs-p50/p99 rows (``frontend/loadgen.py``;
``--sweep`` runs several offered-QPS levels). ``router`` fronts running
replicas (``--replicas``) or spawns and supervises them (``--spawn N``,
serve flags after ``--``). Neither loads torch: ``__main__`` routes both
before the run CLI.

Usage error convention as everywhere: combinations the stack cannot
honor exit 2 loudly.

Examples::

    python -m mpi_knn_tpu_torch serve --data sift:100000 --k 10 \
        --bucket 512 --port 8080
    python -m mpi_knn_tpu_torch serve --data synthetic:8192x64c10 \
        --port 0 --ready-file /tmp/knn.url --platform cpu
    python -m mpi_knn_tpu_torch loadgen --url http://127.0.0.1:8080 \
        --tenants 8 --qps 50 --requests 40 --rows 16 --report curve.json
    python -m mpi_knn_tpu_torch router --spawn 2 --cache-dir /tmp/kc \
        --port 0 --ready-file /tmp/r.url -- --data mnist --k 10 \
        --backend pallas
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

from mpi_knn_tpu_torch.config import (
    BACKENDS,
    PRECISION_POLICIES,
    KNNConfig,
)


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch serve",
        description="multi-tenant HTTP serving front end: request "
        "coalescing into the engine's bucketed entries, SLO-aware "
        "admission, queue-driven degradation ladder",
    )
    d = p.add_argument_group("data / index")
    d.add_argument("--data", default="mnist",
                   help="corpus spec (the run CLI's forms: 'mnist', 'digits', "
                   "'synthetic:MxDcC', 'sift:M', *.fvecs/bvecs, .mat)")
    d.add_argument("--limit", type=int, default=None)
    d.add_argument("--k", type=int, default=30)
    d.add_argument("--backend", choices=BACKENDS, default="auto")
    d.add_argument("--devices", type=int, default=None,
                   help="ring size for distributed backends")
    d.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "float64"])
    d.add_argument("--query-tile", type=int, default=1024)
    d.add_argument("--corpus-tile", type=int, default=2048)
    d.add_argument("--precision-policy", choices=list(PRECISION_POLICIES),
                   default="exact")
    d.add_argument("--bucket", type=int, default=1024,
                   help="base row bucket of the engine's entries; batches "
                   "pad to bucket*2^j rows")
    d.add_argument("--dispatch-depth", type=int, default=2)
    d.add_argument("--partitions", type=int, default=None,
                   help="serve a CLUSTERED (IVF) index: train this many "
                   "k-means partitions at startup (sublinear probing; "
                   "enables the background compactor for live mutation)")
    d.add_argument("--nprobe", type=int, default=None,
                   help="partitions probed per query (None with "
                   "--partitions = recall-targeted auto-tune)")
    d.add_argument("--index-load", default=None, metavar="PATH.npz",
                   help="serve a clustered index saved by build-index "
                   "instead of building one: its partitions, nprobe and "
                   "at-rest dtype (int8 / int4 included) are the file's; "
                   "--data must name its corpus (its dim is checked)")
    d.add_argument("--bucket-headroom", type=float, default=0.0,
                   help="fractional spare capacity per bucket/tile for "
                   "LIVE mutation (POST /upsert, /delete): pre-allocated "
                   "free slots the in-place scatters fill. 0.0 (default) "
                   "= zero-rent frozen corpus; 0.25-0.5 for mutable ones "
                   "(headroom rows ride every batch's work)")
    d.add_argument("--mutation-bucket", type=int, default=256,
                   help="base row bucket of mutation chunks (chunks pad "
                   "to mutation_bucket*2^j)")
    d.add_argument("--compactor-interval-s", type=float, default=0.25,
                   help="background compactor trigger-poll period for "
                   "clustered indices; 0 disables the compactor")
    d.add_argument("--compact-fill-threshold", type=float, default=0.9)
    d.add_argument("--compact-tombstone-fraction", type=float,
                   default=0.3)
    d.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="persistent cache of the kernel libraries "
                   "(serve/aotcache.py; also via TKNN_AOT_CACHE): a "
                   "restarted server loads every library nvcc built "
                   "from disk instead of building it again. A damaged "
                   "entry is rebuilt loudly; the dir is safe to share "
                   "between concurrent processes (atomic-rename writes)")
    d.add_argument("--warm-threads", type=int, default=None,
                   help="thread-pool width of the start-up warm "
                   "(default: auto = min(cells, cpu count); 1 forces "
                   "the sequential walk)")

    f = p.add_argument_group("front end (coalescing / SLO)")
    f.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="coalescing deadline: no request waits longer "
                   "than this for co-travelers before its batch "
                   "dispatches ragged")
    f.add_argument("--max-batch-rows", type=int, default=None,
                   help="coalesced batch row target (default: --bucket, "
                   "so steady-state fill batches land in one entry)")
    f.add_argument("--max-queue-rows", type=int, default=8192,
                   help="per-tenant queued-row ceiling; beyond it "
                   "requests are refused with a structured 429")
    f.add_argument("--tenant-qps", type=float, default=None,
                   help="per-tenant admission rate limit (token bucket "
                   "of --burst); default unlimited")
    f.add_argument("--burst", type=int, default=32)
    f.add_argument("--shed-queue-rows", type=int, default=None,
                   help="total queued rows that, sustained for "
                   "--shed-hold-ms, walk the serving degradation ladder "
                   "one rung down (recovery restores it); default: never "
                   "shed")
    f.add_argument("--shed-hold-ms", type=float, default=50.0)
    f.add_argument("--recover-hold-ms", type=float, default=250.0)

    n = p.add_argument_group("network / output")
    n.add_argument("--host", default="127.0.0.1")
    n.add_argument("--port", type=int, default=8080,
                   help="0 = ephemeral (printed, and written to "
                   "--ready-file)")
    n.add_argument("--request-timeout-s", type=float, default=30.0)
    n.add_argument("--ready-file", default=None, metavar="PATH",
                   help="write the listening URL here once ready (script "
                   "rendezvous)")
    n.add_argument("--flight-record", default=None, metavar="JSONL",
                   help="span flight record (coalesce events, batch "
                   "spans with tenant composition, shed/restore walks)")
    n.add_argument("--metrics-out", default=None, metavar="JSON",
                   help="write the metrics-registry snapshot at shutdown")
    n.add_argument("--platform", choices=["auto", "cpu", "cuda"],
                   default="auto",
                   help="where the index lives and its batches run: auto "
                   "and cuda = the card (refused without one), cpu = the "
                   "plain versions of the kernels")
    n.add_argument("-q", "--quiet", action="store_true")
    return p


def _load_served_index(args, cfg: KNNConfig, X, device):
    """The clustered index ``--index-load`` names, on ``device``, and its
    config with the query-side knobs of ``cfg``; the build-side flags must
    not be given (they are the file's). ValueError names what does not
    fit."""
    from mpi_knn_tpu_torch.ivf import load_ivf_index

    if args.partitions is not None or args.nprobe is not None:
        raise ValueError("--partitions / --nprobe are the loaded index's "
                         "own; drop them with --index-load")
    try:
        index = load_ivf_index(args.index_load, device=device)
    except (OSError, KeyError) as e:
        raise ValueError(f"cannot load index {args.index_load!r}: {e}") from e
    if X.shape[1] != index.dim:
        raise ValueError(f"--data {args.data!r} has dim {X.shape[1]} but the "
                         f"loaded index was built at dim {index.dim}")
    if args.backend in ("ring", "ring-overlap"):
        # the sharded deployment: the layout is derived from --devices
        from mpi_knn_tpu_torch.ivf import shard_ivf_index

        index = shard_ivf_index(index, shards=args.devices)
    return index, index.compatible_cfg(index.cfg.replace(
        k=cfg.k, query_tile=cfg.query_tile,
        precision_policy=cfg.precision_policy,
        query_bucket=cfg.query_bucket, dispatch_depth=cfg.dispatch_depth,
        mutation_bucket=cfg.mutation_bucket,
        compact_fill_threshold=cfg.compact_fill_threshold,
        compact_tombstone_fraction=cfg.compact_tombstone_fraction))


def serve_main(argv=None) -> int:
    args = build_serve_parser().parse_args(argv)
    if args.max_wait_ms < 0:
        print("error: --max-wait-ms must be >= 0", file=sys.stderr)
        return 2
    if args.port < 0:
        print("error: --port must be >= 0", file=sys.stderr)
        return 2
    if args.recover_hold_ms < 0 or args.shed_hold_ms < 0:
        print("error: hold times must be >= 0", file=sys.stderr)
        return 2
    if args.shed_queue_rows is None and (
        args.shed_hold_ms != 50.0 or args.recover_hold_ms != 250.0
    ):
        # the serve-CLI inert-knob convention: hold times only matter
        # once a shed threshold exists
        print("error: --shed-hold-ms/--recover-hold-ms without "
              "--shed-queue-rows: no shed threshold is set, so the "
              "knobs would be silently inert", file=sys.stderr)
        return 2

    if args.warm_threads is not None and args.warm_threads < 1:
        print("error: --warm-threads must be >= 1", file=sys.stderr)
        return 2

    if args.flight_record:
        from mpi_knn_tpu_torch.obs.spans import FlightRecorder, set_recorder

        set_recorder(FlightRecorder(args.flight_record, fresh=True))

    if args.cache_dir:
        from mpi_knn_tpu_torch.serve import aotcache

        aotcache.set_cache_dir(args.cache_dir)

    from mpi_knn_tpu_torch.cli import load_corpus
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.frontend.scheduler import SLOPolicy
    from mpi_knn_tpu_torch.frontend.server import Frontend, FrontendHTTPServer
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy
    from mpi_knn_tpu_torch.serve import ServeSession, build_index

    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    X, _, source = load_corpus(args.data, limit=args.limit)
    if args.limit is not None:
        X = X[:args.limit]
    try:
        cfg = KNNConfig(
            k=args.k,
            backend=args.backend,
            dtype=args.dtype,
            query_tile=args.query_tile,
            corpus_tile=args.corpus_tile,
            precision_policy=args.precision_policy,
            num_devices=args.devices,
            query_bucket=args.bucket,
            dispatch_depth=args.dispatch_depth,
            partitions=args.partitions,
            nprobe=args.nprobe,
            bucket_headroom=args.bucket_headroom,
            mutation_bucket=args.mutation_bucket,
            compact_fill_threshold=args.compact_fill_threshold,
            compact_tombstone_fraction=args.compact_tombstone_fraction,
        )
        policy = SLOPolicy(
            max_batch_rows=args.max_batch_rows or args.bucket,
            max_wait_s=args.max_wait_ms / 1e3,
            max_queue_rows=max(
                args.max_queue_rows, args.max_batch_rows or args.bucket
            ),
            max_tenant_qps=args.tenant_qps,
            burst=args.burst,
            shed_queue_rows=args.shed_queue_rows,
            shed_hold_s=args.shed_hold_ms / 1e3,
            recover_hold_s=args.recover_hold_ms / 1e3,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    try:
        if args.index_load is not None:
            index, cfg = _load_served_index(args, cfg, X, device)
        elif args.partitions is not None:
            # the clustered index serves through the same engine and
            # front end, and is the layout the background compactor
            # supervises
            from mpi_knn_tpu_torch.ivf import build_ivf_index

            index = build_ivf_index(X, cfg, device=device)
        else:
            index = build_index(X, cfg, device=device)
        # a ResiliencePolicy (even the default) builds the degradation
        # ladder the queue-driven shed walks; without one the session
        # would have only its full rung
        session = ServeSession(index, cfg, resilience=ResiliencePolicy(),
                               device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # start-up order: bind the port and write the ready file BEFORE
    # warming; the warm-up runs on a background thread and /healthz
    # reports its entries-ready/total progress, so time-to-listening is
    # the index build, not the warm-up; traffic is admitted per bucket as
    # entries land (a not-yet-ready bucket gets a structured 503
    # "warming", never a hung socket)
    frontend = Frontend(session, policy)
    frontend.start(
        background=True, warm_parallel=args.warm_threads,
    )
    server = FrontendHTTPServer(
        frontend, host=args.host, port=args.port,
        request_timeout_s=args.request_timeout_s, quiet=args.quiet,
    ).start()
    build_s = time.perf_counter() - t0
    if not args.quiet:
        print(
            f"[mpi_knn_tpu_torch serve] {source} shape={list(X.shape)} "
            f"backend={index.backend} k={cfg.k} bucket={cfg.query_bucket} "
            f"max_wait={args.max_wait_ms}ms (index+bind {build_s:.2f}s, "
            "warming in background)"
        )
        print(f"[mpi_knn_tpu_torch serve] listening on {server.url}",
              flush=True)
    if args.ready_file:
        # atomic publish (utils.atomicio): another process polls this file
        # while it is being written; it must read nothing or the full URL,
        # never a truncated prefix
        from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

        atomic_write_text(args.ready_file, server.url + "\n")

    def _report_warm():
        frontend._serving_ready.wait()
        rep = session.warm_report or {}
        if not args.quiet and rep:
            print(
                f"[mpi_knn_tpu_torch serve] warm done in "
                f"{rep.get('wall_s')}s: {rep.get('cells')} cells "
                f"({rep.get('built')} built, {rep.get('reused')} reused, "
                f"{rep.get('deduped')} deduped)"
                + (f" cache={args.cache_dir}" if args.cache_dir else ""),
                flush=True,
            )

    threading.Thread(target=_report_warm, daemon=True,
                     name="warm-report").start()

    # background compaction: clustered indices get the trigger-driven
    # re-cluster/compact worker (heartbeat and flight recorded, deferred
    # while the session sheds load); the dense layouts reclaim tombstones
    # in place and need none
    compactor = None
    if args.compactor_interval_s > 0 and index.backend in (
        "ivf", "ivf-sharded"
    ):
        compactor = session.start_compactor(
            interval_s=args.compactor_interval_s
        )

    stop = threading.Event()

    def _sig(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        if compactor is not None:
            compactor.stop()
        server.stop()
        frontend.stop()
        if args.metrics_out:
            from mpi_knn_tpu_torch.obs.metrics import get_registry
            from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

            atomic_write_text(
                args.metrics_out,
                json.dumps(get_registry().snapshot(), indent=1) + "\n",
            )
        if not args.quiet:
            st = frontend.stats()
            print(
                f"[mpi_knn_tpu_torch serve] shutdown: "
                f"{st['queries_served']} query "
                f"rows in {st['batches_retired']} batches, "
                f"{st['rejected']} rejected, rung={st['rung']}"
            )
    return 0


# ---------------------------------------------------------------------------


def build_loadgen_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch loadgen",
        description="open-loop multi-tenant load generator for a running "
        "`serve` (throughput-vs-p50/p99 rows; open loop so an "
        "overloaded server shows growing latency, not a slowing client)",
    )
    p.add_argument("--url", default=None,
                   help="server base URL (e.g. http://127.0.0.1:8080)")
    p.add_argument("--targets", default=None, metavar="URL1,URL2,...",
                   help="drive several endpoints at once (tenant i pins "
                   "to target i mod N — the router drill's multi-replica "
                   "direct baseline); replaces --url")
    p.add_argument("--connect", choices=["reuse", "per-request"],
                   default="reuse",
                   help="HTTP transport: 'reuse' = fixed worker pool "
                   "with persistent keep-alive connections (default); "
                   "'per-request' = legacy fresh connect + thread per "
                   "request")
    p.add_argument("--connections", type=int, default=4,
                   help="keep-alive connections per tenant stream "
                   "(reuse mode)")
    p.add_argument("--tenants", type=int, default=4,
                   help="concurrent tenant streams")
    p.add_argument("--qps", type=float, default=20.0,
                   help="offered request rate PER TENANT stream")
    p.add_argument("--sweep", default=None, metavar="Q1,Q2,...",
                   help="sweep these offered per-tenant QPS levels "
                   "instead of the single --qps")
    p.add_argument("--requests", type=int, default=20,
                   help="requests per tenant per level")
    p.add_argument("--rows", type=int, default=16,
                   help="query rows per request")
    p.add_argument("--timeout-s", type=float, default=30.0)
    p.add_argument("--report", default=None, help="write JSON rows here")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def loadgen_main(argv=None) -> int:
    args = build_loadgen_parser().parse_args(argv)
    if args.tenants < 1 or args.requests < 1 or args.rows < 1:
        print("error: --tenants/--requests/--rows must be >= 1",
              file=sys.stderr)
        return 2
    if args.qps <= 0:
        print("error: --qps must be > 0", file=sys.stderr)
        return 2
    if args.connections < 1:
        print("error: --connections must be >= 1", file=sys.stderr)
        return 2
    targets = None
    if args.targets:
        targets = [u.strip() for u in args.targets.split(",") if u.strip()]
        if not targets:
            print(f"error: bad --targets {args.targets!r}",
                  file=sys.stderr)
            return 2
    if targets is None and not args.url:
        print("error: one of --url / --targets is required",
              file=sys.stderr)
        return 2
    levels = [args.qps]
    if args.sweep:
        try:
            levels = [float(v) for v in args.sweep.split(",") if v.strip()]
        except ValueError:
            levels = []
        if not levels or any(v <= 0 for v in levels):
            print(f"error: bad --sweep {args.sweep!r}: want a "
                  "comma-separated list of positive QPS levels",
                  file=sys.stderr)
            return 2

    from mpi_knn_tpu_torch.frontend import loadgen

    probe_url = targets[0] if targets else args.url
    try:
        health = loadgen.probe_server(probe_url, timeout_s=args.timeout_s)
    except OSError as e:
        print(f"error: cannot reach {probe_url}: {e}", file=sys.stderr)
        return 2
    if not args.quiet:
        print(
            f"[mpi_knn_tpu_torch loadgen] {probe_url}"
            + (f" (+{len(targets) - 1} more)"
               if targets and len(targets) > 1 else "")
            + f": backend={health['backend']} "
            f"dim={health['dim']} k={health['k']} "
            f"max_batch_rows={health['max_batch_rows']} "
            f"connect={args.connect}"
        )
    rows_out = []
    for qps in sorted(levels):
        rep = loadgen.run_http(
            args.url, targets=targets, tenants=args.tenants, qps=qps,
            n_requests=args.requests, rows=args.rows,
            timeout_s=args.timeout_s, connect=args.connect,
            connections=args.connections,
        )
        rows_out.append(rep)
        if not args.quiet:
            print(
                f"  offered {rep['offered_qps_total']:g} req/s "
                f"({args.tenants} tenants): achieved "
                f"{rep['achieved_rps']} req/s "
                f"({rep['achieved_qps_rows']} rows/s), "
                f"p50 {rep['p50_ms']}ms p99 {rep['p99_ms']}ms, "
                f"rejected {rep['rejected']}, errors {rep['errors']}"
            )
    if any(r["errors"] for r in rows_out):
        print("error: load run saw serving errors (not 200/429)",
              file=sys.stderr)
        return 1
    if args.report:
        from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

        atomic_write_text(args.report, json.dumps({
            "schema": "mpi_knn_tpu_torch.frontend.loadgen/1",
            "url": probe_url,
            "targets": targets,
            "connect": args.connect,
            "health": health,
            "rows": rows_out,
        }, indent=1) + "\n")
        if not args.quiet:
            print(f"report written to {args.report}")
    return 0


# ---------------------------------------------------------------------------


def build_router_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch router",
        description="replicated serving tier: a torch-free "
        "router fronting N `serve` replicas of one index — "
        "health-gated membership, tenant-affine (rendezvous-hash) "
        "spread with least-queued spill, sequenced mutation fan-out "
        "with bounded replay, optional supervised replica spawning",
        epilog="with --spawn, arguments after `--` are passed through "
        "to every `serve` child (e.g. `router --spawn 3 --cache-dir "
        "/tmp/kc -- --data synthetic:4096x32c4 --k 10`)",
    )
    m = p.add_argument_group("fleet")
    m.add_argument("--replicas", default=None, metavar="URL1,URL2,...",
                   help="static fleet: base URLs of running replicas "
                   "(named r0, r1, ... in probe order)")
    m.add_argument("--spawn", type=int, default=None, metavar="N",
                   help="launch and supervise N `serve` children "
                   "(resilience/worker.py: crashed replicas restart and "
                   "are health-gated back in); serve flags follow `--`")
    m.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="shared kernel-library cache for spawned "
                   "replicas: a replica's start loads the libraries nvcc "
                   "built once instead of building them (warm it first, "
                   "so children never run nvcc at once)")
    m.add_argument("--workdir", default=None, metavar="DIR",
                   help="spawn mode: ready-file directory (default: a "
                   "fresh temp dir)")

    r = p.add_argument_group("membership / routing")
    r.add_argument("--probe-interval-ms", type=float, default=500.0,
                   help="health-poll period (the router's own clock)")
    r.add_argument("--evict-after", type=int, default=3,
                   help="consecutive probe failures before eviction")
    r.add_argument("--rejoin-after", type=int, default=2,
                   help="consecutive ready probes before (re)join")
    r.add_argument("--spill-queue-rows", type=int, default=4096,
                   help="/healthz queue depth beyond which the affine "
                   "replica spills to the least-queued one")
    r.add_argument("--replay-buffer", type=int, default=4096,
                   help="bounded mutation replay buffer (entries); a "
                   "replica whose gap falls off it is quarantined until "
                   "cold-reloaded")

    n = p.add_argument_group("network / output")
    n.add_argument("--host", default="127.0.0.1")
    n.add_argument("--port", type=int, default=8090,
                   help="0 = ephemeral (printed, and written to "
                   "--ready-file)")
    n.add_argument("--request-timeout-s", type=float, default=30.0)
    n.add_argument("--ready-file", default=None, metavar="PATH",
                   help="write the router URL here once listening")
    n.add_argument("--flight-record", default=None, metavar="JSONL",
                   help="span flight record (membership transitions, "
                   "replica exits)")
    n.add_argument("--metrics-out", default=None, metavar="JSON",
                   help="write the metrics-registry snapshot at shutdown")
    n.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("serve_args", nargs=argparse.REMAINDER,
                   help="after `--`: flags for every spawned `serve` "
                   "child")
    return p


def router_main(argv=None) -> int:
    args = build_router_parser().parse_args(argv)
    if (args.replicas is None) == (args.spawn is None):
        print("error: exactly one of --replicas / --spawn is required",
              file=sys.stderr)
        return 2
    if args.spawn is not None and args.spawn < 1:
        print("error: --spawn must be >= 1", file=sys.stderr)
        return 2
    if args.replicas is not None and (args.cache_dir or args.workdir):
        print("error: --cache-dir/--workdir only apply to --spawn "
              "(a static fleet owns its own caches)", file=sys.stderr)
        return 2
    serve_args = list(args.serve_args)
    if serve_args and serve_args[0] == "--":
        serve_args = serve_args[1:]
    if serve_args and args.spawn is None:
        print("error: serve pass-through args require --spawn",
              file=sys.stderr)
        return 2

    if args.flight_record:
        from mpi_knn_tpu_torch.obs.spans import FlightRecorder, set_recorder

        set_recorder(FlightRecorder(args.flight_record, fresh=True))

    from mpi_knn_tpu_torch.frontend.router import (
        ReplicaSupervisor,
        Router,
        RouterHTTPServer,
        RouterPolicy,
    )

    try:
        policy = RouterPolicy(
            probe_interval_s=args.probe_interval_ms / 1e3,
            evict_after=args.evict_after,
            rejoin_after=args.rejoin_after,
            spill_queue_rows=args.spill_queue_rows,
            replay_buffer=args.replay_buffer,
            request_timeout_s=args.request_timeout_s,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    supervisor = None
    replicas = None
    if args.spawn is not None:
        if args.cache_dir:
            serve_args += ["--cache-dir", args.cache_dir]
        workdir = args.workdir
        if workdir is None:
            import tempfile

            workdir = tempfile.mkdtemp(prefix="tknn-router-")
        supervisor = ReplicaSupervisor(
            args.spawn, serve_args, workdir=workdir
        ).start()
    else:
        urls = [u.strip() for u in args.replicas.split(",") if u.strip()]
        if not urls:
            print(f"error: bad --replicas {args.replicas!r}",
                  file=sys.stderr)
            return 2
        replicas = {f"r{i}": u for i, u in enumerate(urls)}

    router = Router(
        replicas, policy=policy, supervisor=supervisor
    ).start()
    server = RouterHTTPServer(
        router, host=args.host, port=args.port, quiet=args.quiet
    ).start()
    if not args.quiet:
        fleet = (
            f"{args.spawn} spawned replicas" if supervisor is not None
            else f"{len(replicas)} static replicas"
        )
        print(f"[mpi_knn_tpu_torch router] fronting {fleet}; "
              f"listening on {server.url}", flush=True)
    if args.ready_file:
        from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

        atomic_write_text(args.ready_file, server.url + "\n")

    stop = threading.Event()

    def _sig(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        server.stop()
        router.stop()
        if supervisor is not None:
            supervisor.stop()
        if args.metrics_out:
            from mpi_knn_tpu_torch.obs.metrics import get_registry
            from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

            atomic_write_text(
                args.metrics_out,
                json.dumps(get_registry().snapshot(), indent=1) + "\n",
            )
        if not args.quiet:
            st = router.stats()
            print(
                f"[mpi_knn_tpu_torch router] shutdown: seq={st['seq']} "
                f"rotation={st['rotation']}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
