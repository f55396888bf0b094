"""Command-line run path of the port: the JAX package's run CLI
(``mpi_knn_tpu/cli.py``) on one host, with ``--device`` in place of
``--platform``.

    python -m mpi_knn_tpu_torch --data mnist_train.mat --svd 64 --k 10 --loo
    python -m mpi_knn_tpu_torch --data digits --k 5 --loo --device cpu
    python -m mpi_knn_tpu_torch --data synthetic:512x32c4 --k 5 --loo \\
        --device cpu --topk-method approx-rerank --recall-vs-serial
    python -m mpi_knn_tpu_torch --data sift.fvecs --queries q.fvecs --k 10 \\
        --backend pallas --save-neighbors nn.npz
    python -m mpi_knn_tpu_torch --data mnist --k 10 --loo --devices 4 \\
        --backend ring-overlap --ring-fusion fused --checkpoint-dir ckpt
    python -m mpi_knn_tpu_torch query --data synthetic:512x32c4 \\
        --synthetic 100 --backend pallas --device cpu     # serve/cli.py
    python -m mpi_knn_tpu_torch build-index --data sift:100000 \\
        --partitions 256 --out sift.ivf.npz               # ivf/cli.py
    python -m mpi_knn_tpu_torch query --data sift:100000 \\
        --index-load sift.ivf.npz --synthetic 10000 --batch 512
    python -m mpi_knn_tpu_torch mutate --index sift.ivf.npz \\
        --delete 17,42 --compact                          # serve/mutate_cli.py
    python -m mpi_knn_tpu_torch metrics m.json --check    # obs/cli.py
    python -m mpi_knn_tpu_torch serve --data mnist --k 10 --backend pallas \\
        --port 0 --ready-file s.url                       # frontend/cli.py
    python -m mpi_knn_tpu_torch loadgen --url "$(cat s.url)" --tenants 8
    python -m mpi_knn_tpu_torch router --spawn 2 --cache-dir kc -- \\
        --data mnist --k 10 --backend pallas
    python -m mpi_knn_tpu_torch doctor                    # resilience/doctor.py

Flags. Data: ``--data`` (``mnist``, ``digits``, ``synthetic:MxDcC``,
``sift:M``, a ``.fvecs`` / ``.bvecs`` file, or a ``.mat`` file in the C
reference's ``train_X`` / ``train_labels`` layout), ``--limit``, ``--svd``.
kNN: ``--k``, ``--metric``, ``--backend``, ``--num-classes``,
``--tie-break``, ``--devices``, ``--query-tile``, ``--corpus-tile``,
``--dtype``, ``--precision-policy``, ``--topk-method``, ``--topk-block``,
``--merge-schedule``, the ring's ``--ring-schedule``, ``--ring-fusion``,
``--ring-fused-rotation``, ``--ring-transfer-dtype``, ``--pallas-variant``,
``--include-zero-dist``, ``--include-self``. Output: ``--loo``,
``--queries`` (``.npy`` / ``.mat`` / ``.fvecs`` / ``.bvecs``; query mode),
``--report``, ``--save-neighbors``, ``--one-based-ids``, ``--profile``
(a torch.profiler Chrome trace), ``--checkpoint-dir``, ``--save-every``,
``-q``, ``-v``, ``--recall-sample``, ``--recall-vs-serial``, ``--device``.

``--dp G`` runs the ring backends on a (G × devices/G) mesh: queries
shard over every device, each of the G groups rings the corpus
(``parallel/mesh.make_mesh2d``).

More than one process (``parallel/distributed.py``): every process runs
the same command with ``--coordinator host:port --num-processes P
--process-id i`` (or the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
/ ``JAX_PROCESS_ID`` variables), and joins the process group before the
load phase. The ring then spans every process's ranks (``--devices``
counts a process's ranks: logical ranks on the CPU; on CUDA the cards of
the pod's card rule, ``parallel/distributed.py``); each process reads the
whole corpus and gets the whole result, and, as in the reference, each
prints it and writes ``--report`` and ``--save-neighbors`` where it is
told. ``--dp G`` there builds the grid over every process's ranks (G must
divide processes × devices, the JAX CLI's check over the global device
count). The report's ``notes["distributed"]`` holds the start-up info,
and its phase ``gather`` the seconds of the result's gather inside
``knn``.

Not yet ported (exit 2, naming what was asked): the subcommands ``lint``
and ``plan``.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np
import torch

from mpi_knn_tpu_torch.config import (
    BACKENDS,
    MERGE_SCHEDULES,
    METRICS,
    PALLAS_VARIANTS,
    PRECISION_POLICIES,
    RING_FUSED_ROTATIONS,
    RING_FUSIONS,
    RING_SCHEDULES,
    RING_TRANSFER_DTYPES,
    TIE_BREAKS,
    TOPK_METHODS,
    KNNConfig,
)
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE

UNPORTED_SUBCOMMANDS = ("lint", "plan")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch",
        description="brute-force kNN search + classification (PyTorch/CUDA)",
    )
    d = p.add_argument_group("data")
    d.add_argument("--data", default="mnist",
                   help="'mnist' (a .mat or IDX files if found, else "
                   "synthetic), 'digits' (real handwritten digits, 1797x64, "
                   "needs scikit-learn), 'synthetic:MxDcC' (e.g. "
                   "synthetic:4096x128c10), 'sift:M' (SIFT1M-shaped "
                   "surrogate), a .fvecs/.bvecs file, or a .mat file with "
                   "train_X/train_labels in the C reference's layout")
    d.add_argument("--limit", type=int, default=None,
                   help="use the first N rows only")
    d.add_argument("--svd", type=int, default=None, metavar="DIM",
                   help="reduce the corpus to DIM principal components on "
                   "the device first (the mnist_train_svd configuration)")

    k = p.add_argument_group("kNN")
    k.add_argument("--k", type=int, default=30)
    k.add_argument("--metric", choices=METRICS, default="l2")
    k.add_argument("--backend", choices=BACKENDS, default="auto")
    k.add_argument("--num-classes", type=int, default=10)
    k.add_argument("--tie-break", choices=TIE_BREAKS, default="nearest")
    k.add_argument("--devices", type=int, default=None,
                   help="ring size for the ring backends (default: the "
                   "visible cards; on the CPU, logical ranks); with more "
                   "than one process, each process's ranks")
    k.add_argument("--dp", type=int, default=1,
                   help="2-D mesh: data-parallel groups; devices/dp form the "
                   "corpus ring inside each group (queries shard over all "
                   "devices, corpus memory scales with the ring size)")
    k.add_argument("--query-tile", type=int, default=1024)
    k.add_argument("--corpus-tile", type=int, default=2048)
    k.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "float64"])
    k.add_argument("--precision-policy", choices=PRECISION_POLICIES,
                   default="exact",
                   help="exact (one full-f32 pass) or mixed (bf16 compress "
                   "pass overfetching 4k candidates, exact rerank)")
    k.add_argument("--topk-method", choices=TOPK_METHODS, default="exact",
                   help="exact sort; block (exact, narrow sorts); bf16 "
                   "(half-width-key preselect of 4k, exact finish); approx "
                   "(the partial reduction, a bin minimum on the card) or "
                   "approx-rerank (its 4k preselect, exact finish)")
    k.add_argument("--topk-block", type=int, default=128,
                   help="first-level sort width for --topk-method block")
    k.add_argument("--merge-schedule", choices=MERGE_SCHEDULES,
                   default="twolevel",
                   help="serial tile merge: stream (carry per tile) or "
                   "twolevel (k survivors per tile, one exact cascade)")
    k.add_argument("--ring-schedule", choices=RING_SCHEDULES, default="uni",
                   help="uni (P rounds) or bidir (both directions, "
                   "floor(P/2)+1 rounds)")
    k.add_argument("--ring-fusion", choices=RING_FUSIONS, default="xla",
                   help="per-round merge: xla (the serial tile loop) or "
                   "fused (the block-merge kernels; needs ring-overlap)")
    k.add_argument("--ring-fused-rotation",
                   choices=list(RING_FUSED_ROTATIONS), default="round",
                   help="fused-form launch granularity on cards: round (one "
                   "K4 launch per card per ring round, the block copied to "
                   "the next rank inside it) or grid (the whole rotation as "
                   "one K5 launch per card; uni/exact, float wires)")
    k.add_argument("--ring-transfer-dtype",
                   choices=[t for t in RING_TRANSFER_DTYPES if t],
                   default=None,
                   help="wire type of the rotating block (int8 needs "
                   "--precision-policy mixed)")
    k.add_argument("--pallas-variant", choices=PALLAS_VARIANTS,
                   default="tiles",
                   help="fused backend: tiles (k per corpus tile, merged "
                   "outside) or sweep (the whole corpus in one kernel)")
    k.add_argument("--include-zero-dist", action="store_true",
                   help="keep zero-distance (duplicate) neighbors; the C "
                   "reference excludes them")
    k.add_argument("--include-self", action="store_true",
                   help="keep each point as its own neighbor in all-pairs mode")

    o = p.add_argument_group("output")
    o.add_argument("--loo", action="store_true",
                   help="leave-one-out classification (the reference's "
                   "workload); the default when no --queries")
    o.add_argument("--queries", default=None,
                   help=".npy/.mat/.fvecs/.bvecs file of query points "
                   "(query mode)")
    o.add_argument("--report", default=None, help="write a JSON report here")
    o.add_argument("--save-neighbors", default=None, metavar="PATH.npz",
                   help="write dists, 0-based ids (and predictions when "
                   "voting ran) as NPZ")
    o.add_argument("--one-based-ids", action="store_true",
                   help="print 1-based neighbor ids (reference parity)")
    o.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the kNN "
                   "phase into DIR")
    o.add_argument("--checkpoint-dir", default=None,
                   help="round-granular checkpoint/resume state directory; "
                   "ring backends checkpoint the carry per ring round, the "
                   "others per corpus-tile round (serial math)")
    o.add_argument("--save-every", type=int, default=None,
                   help="checkpoint cadence: corpus tiles for the serial "
                   "path (default 8), ring rounds for ring backends "
                   "(default 1 — a ring has only as many rounds as ranks)")
    o.add_argument("-q", "--quiet", action="store_true")
    o.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: INFO (checkpoint resumes), -vv: DEBUG")
    o.add_argument("--recall-sample", type=int, default=256, metavar="N",
                   help="query sample size for --recall-vs-serial (0 = all "
                   "queries; default 256)")
    o.add_argument("--recall-vs-serial", action="store_true",
                   help="also run the exact serial backend on a sample and "
                   "report recall@k of the selected backend against it")
    o.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")

    m = p.add_argument_group("more than one process (torch.distributed)")
    m.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's address; every process meets there")
    m.add_argument("--num-processes", type=int, default=None)
    m.add_argument("--process-id", type=int, default=None)
    return p


def load_corpus(spec: str, limit=None):
    """(X, labels or None, source) for a ``--data`` spec: 'mnist',
    'digits', 'synthetic:MxDcC', 'sift:M', a .fvecs/.bvecs file, or a .mat
    file. The run CLI and the ``query`` subcommand share it."""
    m = re.fullmatch(r"synthetic:(\d+)x(\d+)(?:c(\d+))?", spec)
    if m:
        from mpi_knn_tpu_torch.data.synthetic import make_blobs

        X, y = make_blobs(int(m[1]), int(m[2]), num_classes=int(m[3] or 10),
                          seed=0)
        return X, y, spec
    m = re.fullmatch(r"sift:(\d+)", spec)
    if m:
        from mpi_knn_tpu_torch.data.synthetic import make_sift_like

        return make_sift_like(m=int(m[1])), None, spec
    if spec == "mnist":
        from mpi_knn_tpu_torch.data.mnist import load_mnist

        X, y, src = load_mnist(m=limit or 60000)
        return X, y, f"mnist({src})"
    if spec == "digits":
        from mpi_knn_tpu_torch.data.digits import load_digits

        X, y = load_digits()
        if limit:
            X, y = X[:limit], y[:limit]
        return X, y, "digits(real)"
    if spec.endswith((".fvecs", ".bvecs")):
        from mpi_knn_tpu_torch.data.vecs import read_vecs

        try:
            return read_vecs(spec, limit=limit), None, spec
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"error: {e}")
    from mpi_knn_tpu_torch.data.matfile import load_corpus_mat

    try:
        X, y = load_corpus_mat(spec, limit=limit)
    except FileNotFoundError:
        raise SystemExit(
            f"error: --data {spec!r} is not a file, 'mnist', 'digits', a "
            "synthetic:MxDcC spec, or a sift:M spec"
        )
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    return X, y, spec


def load_queries(path: str) -> np.ndarray:
    """Query rows from a .npy, .fvecs/.bvecs or .mat file (its ``queries``
    or ``train_X`` variable)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith((".fvecs", ".bvecs")):
        from mpi_knn_tpu_torch.data.vecs import read_vecs

        try:
            return read_vecs(path)
        except (FileNotFoundError, ValueError) as e:
            raise SystemExit(f"error: {e}")
    from mpi_knn_tpu_torch.data.matfile import read_mat

    try:
        data = read_mat(path)
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"error: {e}")
    for name in ("queries", "train_X"):
        if name in data:
            return data[name].astype(np.float32)
    raise SystemExit(f"{path}: no queries/train_X variable")


def config_from_args(args) -> KNNConfig:
    """The run's KNNConfig from the parsed flags."""
    return KNNConfig(
        k=args.k,
        metric=args.metric,
        backend=args.backend,
        num_classes=args.num_classes,
        tie_break=args.tie_break,
        query_tile=args.query_tile,
        corpus_tile=args.corpus_tile,
        dtype=args.dtype,
        precision_policy=args.precision_policy,
        topk_method=args.topk_method,
        topk_block=args.topk_block,
        merge_schedule=args.merge_schedule,
        ring_schedule=args.ring_schedule,
        ring_fusion=args.ring_fusion,
        ring_fused_rotation=args.ring_fused_rotation,
        ring_transfer_dtype=args.ring_transfer_dtype,
        pallas_variant=args.pallas_variant,
        exclude_zero=not args.include_zero_dist,
        exclude_self=not args.include_self,
        num_devices=args.devices,
    )


def _host(t) -> np.ndarray:
    from mpi_knn_tpu_torch.parallel.distributed import fetch_global

    return fetch_global(t)


def _rows(X, sample: np.ndarray):
    """X's rows at ``sample`` (a tensor stays on its device)."""
    if isinstance(X, torch.Tensor):
        return X[torch.from_numpy(sample).to(X.device)]
    return np.asarray(X)[sample]


def _start_processes(args) -> dict | None:
    """Join the process group when the flags or the launch environment ask
    for more than one process (the JAX CLI's rule and its refusal of a
    lone ``--process-id``); returns the start-up info, else None."""
    import os

    from mpi_knn_tpu_torch.parallel import distributed

    if args.process_id is not None and not (
        args.coordinator or args.num_processes
        or os.environ.get(distributed.ENV_COORDINATOR)
        or os.environ.get(distributed.ENV_NUM_PROCESSES)
    ):
        raise SystemExit(
            "error: --process-id requires --coordinator/--num-processes "
            "(or the JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES env vars); "
            "refusing to silently run single-host"
        )
    if not distributed.wants_multihost(args.coordinator, args.num_processes):
        return None
    return distributed.init_multihost(
        coordinator_address=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, device=args.device,
        local_devices=args.devices or 1)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "query":
        # the serving subcommand (serve/cli.py), routed before the run
        # parser so the two flag sets stay apart
        from mpi_knn_tpu_torch.serve.cli import main as query_main

        return query_main(argv[1:])
    if argv and argv[0] == "build-index":
        # the clustered index's offline build (ivf/cli.py)
        from mpi_knn_tpu_torch.ivf.cli import main as build_index_main

        return build_index_main(argv[1:])
    if argv and argv[0] == "mutate":
        # live mutation of a saved index (serve/mutate_cli.py)
        from mpi_knn_tpu_torch.serve.mutate_cli import main as mutate_main

        return mutate_main(argv[1:])
    if argv and argv[0] in ("serve", "loadgen", "router"):
        # the serving front end and its load generator and router
        # (frontend/cli.py)
        from mpi_knn_tpu_torch.frontend import cli as frontend_cli

        return getattr(frontend_cli, f"{argv[0]}_main")(argv[1:])
    if argv and argv[0] == "metrics":
        # metrics snapshots and flight records (obs/cli.py)
        from mpi_knn_tpu_torch.obs.cli import main as metrics_main

        return metrics_main(argv[1:])
    if argv and argv[0] == "doctor":
        # the supervised preflight probe (resilience/doctor.py)
        from mpi_knn_tpu_torch.resilience.doctor import main as doctor_main

        return doctor_main(argv[1:])
    if argv and argv[0] in UNPORTED_SUBCOMMANDS:
        print(f"error: subcommand {argv[0]!r}: not yet ported to "
              "mpi_knn_tpu_torch (see ROADMAP.md)", file=sys.stderr)
        return 2
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.save_every is not None and args.save_every <= 0:
        parser.error("--save-every must be a positive round count")
    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.utils.logs import setup_logging

    setup_logging(args.verbose, quiet=args.quiet)
    dist_info = _start_processes(args)
    try:
        return _run(args, dist_info)
    finally:
        distributed.shutdown()


def _run(args, dist_info) -> int:
    from mpi_knn_tpu_torch.api import all_knn, knn_classify, resolve_backend
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.parallel import distributed
    from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text
    from mpi_knn_tpu_torch.utils.report import RunReport, recall_at_k
    from mpi_knn_tpu_torch.utils.timing import PhaseTimer, profile_trace

    device = resolve_device(args.device)
    timer = PhaseTimer()
    with timer.phase("load"):
        X, labels, source = load_corpus(args.data, limit=args.limit)
        if args.limit:
            X = X[: args.limit]
            labels = labels[: args.limit] if labels is not None else None
    cfg = config_from_args(args)
    queries = load_queries(args.queries) if args.queries else None

    if args.svd:
        from mpi_knn_tpu_torch.data.svd import svd_reduce

        with timer.phase("svd"):
            X, comps, mu = svd_reduce(X, args.svd, device=device)
            if queries is not None:
                # the queries go into the same principal subspace
                q = torch.as_tensor(queries, dtype=torch.float32).to(device)
                queries = torch.matmul(q - mu, comps)
            timer.block_on(X)

    mesh = None
    if args.dp and args.dp > 1:
        mesh = _mesh2d(args, device, dist_info)
    report = RunReport(
        config=vars(args), data_source=source, shape=tuple(X.shape),
        backend=resolve_backend(cfg, mesh, device=device),
        num_devices=cfg.num_devices or 1,
    )
    if dist_info is not None:
        report.notes["distributed"] = dist_info
    if any(str(p).endswith(".mat") for p in (args.data, args.queries)):
        from mpi_knn_tpu_torch.data.matfile import reader_name

        report.notes["mat_reader"] = reader_name()

    with profile_trace(args.profile, device):
        with timer.phase("knn"):
            if args.checkpoint_dir:
                result = _resumable_knn(X, queries, cfg, args, device, mesh)
            else:
                result = all_knn(X, queries=queries, config=cfg, mesh=mesh,
                                 device=device)
            timer.block_on(result.dists)
        cls = None
        if labels is not None and (args.loo or queries is None):
            with timer.phase("vote"):
                cls = knn_classify(result, labels, num_classes=cfg.num_classes,
                                   tie_break=cfg.tie_break)
                preds = _host(cls.predictions)
            if queries is None:
                report.matches = int((preds == np.asarray(labels)[: len(preds)]).sum())
                report.total = int(len(labels))
                report.accuracy = report.matches / report.total
            else:  # query mode: the predictions are the output
                report.notes["predictions"] = preds.tolist()

    if args.recall_vs_serial:
        _recall_vs_serial(args, cfg, report, result, X, queries, timer,
                          device, all_knn, recall_at_k)

    report.phase_seconds = dict(timer.seconds)
    if dist_info is not None and distributed.pod().gather_seconds:
        # the result's gather across processes, inside the knn phase
        report.phase_seconds["gather"] = distributed.pod().gather_seconds
    if not args.quiet:
        # the C reference's lines (knn-serial.c:98,130), then a summary
        print(f"Clock time = {timer.seconds['knn']:.6f}")
        if report.matches is not None:
            print(f"Matches: {report.matches}")
        if cls is not None and queries is not None:
            print(f"predictions ({len(preds)} queries): {preds[:20].tolist()}"
                  + (" ..." if len(preds) > 20 else ""))
        print(f"[mpi_knn_tpu_torch] backend={report.backend} device={device} "
              f"shape={tuple(X.shape)} k={cfg.k} metric={cfg.metric} "
              + (f"accuracy={report.accuracy:.4f} "
                 if report.accuracy is not None else "")
              + (f"recall-vs-serial={report.recall_vs_baseline:.4f} "
                 if report.recall_vs_baseline is not None else "")
              + f"knn={timer.seconds['knn']:.3f}s")
        if args.one_based_ids:
            print("neighbor ids (1-based, first 5 queries):")
            print(_host(result.one_based())[:5])

    if args.save_neighbors:
        out = {"dists": _host(result.dists), "ids": _host(result.ids)}
        if cls is not None:
            out["predictions"] = _host(cls.predictions)
        # np.savez appends .npz when absent: name the file that exists
        nn_path = args.save_neighbors
        if not nn_path.endswith(".npz"):
            nn_path += ".npz"
        np.savez(nn_path, **out)
        if not args.quiet:
            print(f"neighbors written to {nn_path}")

    if args.report:
        # the JAX package's report fields, then the port's own beside them
        doc = {
            **report.finalize(),
            "pallas_variant": cfg.pallas_variant,
            "precision_policy": cfg.precision_policy,
            "ring_schedule": cfg.ring_schedule,
            "ring_fusion": cfg.ring_fusion,
            "ring_fused_rotation": cfg.ring_fused_rotation,
            "checkpoint_dir": args.checkpoint_dir,
            "ring_transfer_dtype": cfg.ring_transfer_dtype,
            "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "k": cfg.k,
            "metric": cfg.metric,
        }
        # whole: with more than one process each writes where it is told
        atomic_write_text(args.report, json.dumps(doc, indent=2, default=str))
        if not args.quiet:
            print(f"report written to {args.report}")
    return 0


def _recall_vs_serial(args, cfg, report, result, X, queries, timer, device,
                      all_knn, recall_at_k):
    """recall@k of the run against the exact serial backend on a
    ``linspace`` sample of the queries (all of them with
    ``--recall-sample 0``). Unlike the JAX CLI, a serial run with an
    approximate top-k method is measured: only exact serial math (which
    the non-ring resumable path runs too) is the baseline itself."""
    exact_serial = report.backend == "serial" and cfg.topk_method in ("exact", "block")
    if exact_serial or (
            args.checkpoint_dir and report.backend not in ("ring", "ring-overlap")
            and cfg.topk_method in ("exact", "block")):
        # serial math against itself says nothing: say so rather than
        # report a hollow 1.0
        report.recall_vs_baseline = 1.0
        if not args.quiet:
            why = ("resumable runs serial math" if args.checkpoint_dir
                   else "selected backend IS serial")
            print(f"recall-vs-serial: {why} (trivially 1.0); pick "
                  "--backend ring/ring-overlap/pallas to compare")
        return
    nq = int(result.ids.shape[0])
    ns = args.recall_sample
    full = ns <= 0 or ns >= nq
    sample = (np.arange(nq, dtype=np.int64) if full
              else np.linspace(0, nq - 1, num=ns, dtype=np.int64))
    with timer.phase("recall_baseline"):
        # exact ground truth: an approximate topk_method shared by both
        # sides would cancel and overstate the recall
        base_cfg = cfg.replace(backend="serial", topk_method="exact")
        if queries is None and full:
            base = all_knn(X, config=base_cfg, device=device)
        elif queries is None:
            # sampled corpus rows keep their identity, so self-exclusion
            # matches the full run
            base = all_knn(X, queries=_rows(X, sample), query_ids=sample,
                           config=base_cfg, device=device)
        else:
            base = all_knn(X, queries=_rows(queries, sample), config=base_cfg,
                           device=device)
        timer.block_on(base.dists)
    got = _host(result.ids)[sample]
    report.recall_vs_baseline = recall_at_k(got, _host(base.ids))
    report.notes["recall_sample"] = int(len(sample))


def _mesh2d(args, device, dist_info=None):
    """The ``--dp`` mesh, with the JAX CLI's checks: a ring backend, not the
    blocking one, and dp dividing the device count (in a pod, every
    process's: processes × devices)."""
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    if args.backend not in ("ring", "ring-overlap", "auto"):
        raise SystemExit(
            f"error: --dp requires a ring backend (got --backend "
            f"{args.backend}; serial/pallas ignore the mesh)")
    if args.backend == "ring":
        # the blocking barrier cannot be expressed on a dp×ring mesh: the
        # run would silently use the overlap schedule
        raise SystemExit(
            "error: --dp with --backend ring (the blocking schedule) is "
            "undefined: the compute-then-send barrier cannot be expressed "
            "on a dp×ring mesh, so the run would silently use the overlap "
            "schedule. The 1-D ring is the only defined blocking A/B "
            "object — use --backend ring-overlap with --dp, or drop --dp.")
    if dist_info is not None:
        total = dist_info["devices"]
    else:
        total = args.devices or (torch.cuda.device_count()
                                 if device.type == "cuda" else 1)
    if total % args.dp:
        raise SystemExit(
            f"error: --dp {args.dp} must divide the device count {total}")
    try:
        return make_mesh2d(args.dp, total // args.dp, device=device)
    except ValueError as e:
        raise SystemExit(f"error: {e}")


def _resumable_knn(X, queries, cfg, args, device, mesh=None):
    """The --checkpoint-dir run: ring backends checkpoint per ring round,
    the others per corpus-tile round, as the JAX CLI routes them."""
    from mpi_knn_tpu_torch.api import resolve_backend
    from mpi_knn_tpu_torch.types import KNNResult

    X = _host(X)
    if queries is None:
        q_arr, ids = X, np.arange(len(X), dtype=np.int32)
    else:
        q_arr = _host(queries)
        ids = np.full(len(q_arr), -1, dtype=np.int32)
    backend = resolve_backend(cfg, mesh, device=device)
    if backend in ("ring", "ring-overlap"):
        from mpi_knn_tpu_torch.backends.ring_resumable import (
            all_knn_ring_resumable,
        )

        d, i = all_knn_ring_resumable(
            X, q_arr, ids, cfg, mesh=mesh, overlap=backend == "ring-overlap",
            checkpoint_dir=args.checkpoint_dir,
            save_every=1 if args.save_every is None else args.save_every,
            device=device)
    else:
        from mpi_knn_tpu_torch.backends.resumable import all_knn_resumable

        d, i = all_knn_resumable(
            X, q_arr, ids, cfg, checkpoint_dir=args.checkpoint_dir,
            save_every=8 if args.save_every is None else args.save_every,
            device=device)
    return KNNResult(dists=d, ids=i)


if __name__ == "__main__":
    sys.exit(main())
