"""Command-line run path of the port.

    python -m mpi_knn_tpu_torch --data mnist --k 10 --backend pallas --loo
    python -m mpi_knn_tpu_torch --data synthetic:512x32c4 --k 5 --loo \\
        --device cpu --report r.json
    python -m mpi_knn_tpu_torch --data synthetic:512x32c4 --k 5 --loo \\
        --device cpu --devices 4 --backend ring-overlap --ring-fusion fused
    python -m mpi_knn_tpu_torch --data mnist --k 10 --loo --devices 4 \\
        --backend ring-overlap --ring-fusion fused --checkpoint-dir ckpt
    python -m mpi_knn_tpu_torch query --data synthetic:512x32c4 \\
        --synthetic 100 --backend pallas --device cpu     # serve/cli.py

Only the flags below exist; the JAX CLI's other flags are not ported.
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
    METRICS,
    PALLAS_VARIANTS,
    PRECISION_POLICIES,
    RING_FUSED_ROTATIONS,
    RING_FUSIONS,
    RING_SCHEDULES,
    RING_TRANSFER_DTYPES,
    TIE_BREAKS,
    KNNConfig,
)
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch",
        description="brute-force kNN search + classification (PyTorch/CUDA)",
    )
    p.add_argument("--data", default="mnist",
                   help="'mnist' (IDX files if found, else synthetic) or "
                   "'synthetic:MxDcC' (e.g. synthetic:4096x128c10)")
    p.add_argument("--k", type=int, default=30)
    p.add_argument("--metric", choices=METRICS, default="l2")
    p.add_argument("--backend", choices=BACKENDS, default="auto")
    p.add_argument("--pallas-variant", choices=PALLAS_VARIANTS,
                   default="tiles")
    p.add_argument("--tie-break", choices=TIE_BREAKS, default="nearest")
    p.add_argument("--devices", type=int, default=None,
                   help="ring size for the ring backends (default: the "
                   "visible cards; on the CPU, logical ranks)")
    p.add_argument("--precision-policy", choices=PRECISION_POLICIES,
                   default="exact",
                   help="exact (one full-f32 pass) or mixed (bf16 compress "
                   "pass overfetching 4k candidates, exact rerank)")
    p.add_argument("--ring-schedule", choices=RING_SCHEDULES, default="uni",
                   help="uni (P rounds) or bidir (both directions, "
                   "floor(P/2)+1 rounds)")
    p.add_argument("--ring-fusion", choices=RING_FUSIONS, default="xla",
                   help="per-round merge: xla (the serial tile loop) or "
                   "fused (the block-merge kernels; needs ring-overlap)")
    p.add_argument("--ring-fused-rotation",
                   choices=list(RING_FUSED_ROTATIONS), default="round",
                   help="fused-form launch granularity on cards: round (one "
                   "K4 launch per card per ring round, the block copied to "
                   "the next rank inside it) or grid (the whole rotation as "
                   "one K5 launch per card; uni/exact, float wires)")
    p.add_argument("--ring-transfer-dtype",
                   choices=[d for d in RING_TRANSFER_DTYPES if d],
                   default=None,
                   help="wire type of the rotating block (int8 needs "
                   "--precision-policy mixed)")
    p.add_argument("--query-tile", type=int, default=1024)
    p.add_argument("--corpus-tile", type=int, default=2048)
    p.add_argument("--loo", action="store_true",
                   help="leave-one-out classification (the reference's "
                   "workload; the only mode, as --queries is not ported)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' runs the plain "
                   "versions of the kernels)")
    p.add_argument("--report", default=None, help="write a JSON report here")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="log INFO events (checkpoint resumes) to stderr")
    p.add_argument("--checkpoint-dir", default=None,
                   help="round-granular checkpoint/resume state directory; "
                   "ring backends checkpoint the carry per ring round, the "
                   "others per corpus-tile round (serial math)")
    p.add_argument("--save-every", type=int, default=None,
                   help="checkpoint cadence: corpus tiles for the serial "
                   "path (default 8), ring rounds for ring backends "
                   "(default 1 — a ring has only as many rounds as ranks)")
    return p


def load_corpus(spec: str):
    """(X, labels, source) for 'mnist' or 'synthetic:MxDcC'."""
    m = re.fullmatch(r"synthetic:(\d+)x(\d+)(?:c(\d+))?", spec)
    if m:
        from mpi_knn_tpu_torch.data.synthetic import make_blobs

        X, y = make_blobs(int(m[1]), int(m[2]), num_classes=int(m[3] or 10),
                          seed=0)
        return X, y, spec
    if spec == "mnist":
        from mpi_knn_tpu_torch.data.mnist import load_mnist

        X, y, src = load_mnist()
        return X, y, f"mnist({src})"
    raise SystemExit(f"error: --data {spec!r}: expected mnist or synthetic:MxDcC")


def config_from_args(args) -> KNNConfig:
    """The run's KNNConfig from the parsed flags."""
    return KNNConfig(
        k=args.k,
        metric=args.metric,
        backend=args.backend,
        pallas_variant=args.pallas_variant,
        tie_break=args.tie_break,
        query_tile=args.query_tile,
        corpus_tile=args.corpus_tile,
        num_devices=args.devices,
        precision_policy=args.precision_policy,
        ring_schedule=args.ring_schedule,
        ring_fusion=args.ring_fusion,
        ring_fused_rotation=args.ring_fused_rotation,
        ring_transfer_dtype=args.ring_transfer_dtype,
    )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "query":
        # the serving subcommand (serve/cli.py), routed before the run
        # parser so the two flag sets stay apart
        from mpi_knn_tpu_torch.serve.cli import main as query_main

        return query_main(argv[1:])
    args = build_parser().parse_args(argv)
    from mpi_knn_tpu_torch.api import all_knn, knn_classify, resolve_backend
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.utils.logs import setup_logging
    from mpi_knn_tpu_torch.utils.report import RunReport
    from mpi_knn_tpu_torch.utils.timing import PhaseTimer

    setup_logging(int(args.verbose))
    device = resolve_device(args.device)
    timer = PhaseTimer()
    with timer.phase("load"):
        X, labels, source = load_corpus(args.data)
    cfg = config_from_args(args)
    with timer.phase("knn"):
        if args.checkpoint_dir:
            result = _resumable_knn(X, cfg, args, device)
        else:
            result = all_knn(X, config=cfg, device=device)
        timer.block_on(result.dists)
    with timer.phase("vote"):
        cls = knn_classify(result, labels, num_classes=cfg.num_classes,
                           tie_break=cfg.tie_break)
        matches = int(cls.matches(labels))
    report = RunReport(
        config=vars(args), data_source=source, shape=tuple(X.shape),
        phase_seconds=dict(timer.seconds), matches=matches,
        total=int(len(labels)), accuracy=matches / len(labels),
        backend=resolve_backend(cfg, device=device),
        num_devices=cfg.num_devices or 1,
    )
    # the run's own keys beside the JAX package's report fields
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
    print(f"Clock time = {timer.seconds['knn']:.6f}")
    print(f"Matches: {matches}")
    print(f"[mpi_knn_tpu_torch] backend={report.backend} "
          f"device={device} shape={tuple(X.shape)} k={cfg.k} "
          f"accuracy={report.accuracy:.4f} knn={timer.seconds['knn']:.3f}s")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(doc, f, indent=2, default=str)
    return 0


def _resumable_knn(X, cfg, args, device):
    """The --checkpoint-dir run: ring backends checkpoint per ring round,
    the others per corpus-tile round, as the JAX CLI routes them."""
    from mpi_knn_tpu_torch.api import resolve_backend
    from mpi_knn_tpu_torch.types import KNNResult

    ids = np.arange(len(X), dtype=np.int32)
    backend = resolve_backend(cfg, device=device)
    if backend in ("ring", "ring-overlap"):
        from mpi_knn_tpu_torch.backends.ring_resumable import (
            all_knn_ring_resumable,
        )

        d, i = all_knn_ring_resumable(
            X, X, ids, cfg, overlap=backend == "ring-overlap",
            checkpoint_dir=args.checkpoint_dir,
            save_every=1 if args.save_every is None else args.save_every,
            device=device)
    else:
        from mpi_knn_tpu_torch.backends.resumable import all_knn_resumable

        d, i = all_knn_resumable(
            X, X, ids, cfg, checkpoint_dir=args.checkpoint_dir,
            save_every=8 if args.save_every is None else args.save_every,
            device=device)
    return KNNResult(dists=d, ids=i)


if __name__ == "__main__":
    sys.exit(main())
