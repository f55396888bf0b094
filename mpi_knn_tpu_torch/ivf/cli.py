"""``python -m mpi_knn_tpu_torch build-index``: train the k-means
partitioner and save a clustered (IVF) index to ``.npz`` (the JAX
package's ``ivf/cli.py``, with ``--device`` in place of ``--platform``).

The offline half of clustered serving: cluster once here, then ``python -m
mpi_knn_tpu_torch query --index-load corpus.ivf.npz`` serves the saved
partitions. The ``.npz`` is the JAX package's format, so either package's
``build-index`` output serves in the other.

Flag combinations the clustered path cannot honor exit 2 with the reason:
a pallas backend (the fused kernels scan the full corpus), a non-L2 metric
(k-means is L2 geometry), float64, nprobe > partitions. ``--backend ring``
names the sharded deployment: the training and the saved file are the
same (the shard layout is derived when the file is served), so the build
runs the unsharded path and says how to serve it sharded.

Examples::

    python -m mpi_knn_tpu_torch build-index --data sift:100000 \\
        --partitions 256 --out sift.ivf.npz
    python -m mpi_knn_tpu_torch build-index --data synthetic:2048x32c8 \\
        --partitions 8 --out i.npz --device cpu
    python -m mpi_knn_tpu_torch query --data sift:100000 \\
        --index-load sift.ivf.npz --synthetic 10000 --batch 512
    python -m mpi_knn_tpu_torch build-index --data sift:100000 \\
        --partitions 256 --backend ring --out sift.ivf.npz   # sharded
    python -m mpi_knn_tpu_torch query --data sift:100000 \\
        --index-load sift.ivf.npz --backend ring --devices 4 \\
        --synthetic 10000 --batch 512
"""

from __future__ import annotations

import argparse
import sys
import time

from mpi_knn_tpu_torch.config import KMEANS_INITS, KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_knn_tpu_torch build-index",
        description="train a k-means-clustered (IVF) index and save it "
        "(.npz); query it with `mpi_knn_tpu_torch query --index-load`",
    )
    d = p.add_argument_group("data")
    d.add_argument("--data", default="mnist",
                   help="corpus spec, as the run command's --data: 'mnist', "
                   "'digits', 'synthetic:MxDcC', 'sift:M', a .fvecs/.bvecs "
                   "file or a .mat file")
    d.add_argument("--limit", type=int, default=None,
                   help="use the first N corpus rows only")

    k = p.add_argument_group("index")
    k.add_argument("--partitions", type=int, required=True,
                   help="k-means partitions (probed bytes per query are "
                   "nprobe/partitions of the corpus)")
    k.add_argument("--nprobe", type=int, default=None,
                   help="partitions probed per query; default: tune the "
                   "smallest nprobe reaching --recall-target on a held-out "
                   "corpus sample against the full scan")
    k.add_argument("--recall-target", type=float, default=0.95,
                   help="recall@k target of the nprobe tuning")
    k.add_argument("--k", type=int, default=10,
                   help="neighbors the tuning measures recall@k at")
    k.add_argument("--metric", default="l2", choices=["l2", "cosine"],
                   help="l2 only; cosine is refused (k-means and the "
                   "centroid score are L2 geometry)")
    k.add_argument("--backend", default="auto",
                   help="serial/auto, or ring (the sharded deployment: "
                   "the same file, served with query --backend ring); "
                   "pallas is refused")
    k.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16", "int8", "int4"],
                   help="bucket store at rest: bfloat16 halves it; int8 / "
                   "int4 keep block-scaled codes and per-row scales "
                   "(ops/quant.py)")
    k.add_argument("--bucket-headroom", type=float, default=0.0,
                   help="spare slots per bucket for live mutation (the "
                   "serve front end's flag, baked into the saved store)")
    k.add_argument("--kmeans-iters", type=int, default=25,
                   help="fixed Lloyd iteration count")
    k.add_argument("--kmeans-init", choices=list(KMEANS_INITS),
                   default="kmeans++")
    k.add_argument("--seed", type=int, default=0,
                   help="seed of the k-means init's generator")

    o = p.add_argument_group("output")
    o.add_argument("--out", required=True, metavar="PATH.npz",
                   help="where to save the index")
    o.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device (default cuda; 'cpu' builds on the "
                   "CPU)")
    o.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # --backend ring = the sharded deployment: the training and the saved
    # file are the unsharded ones (the layout is derived at serve time)
    sharded = args.backend in ("ring", "ring-overlap")
    backend = "auto" if sharded else args.backend

    from mpi_knn_tpu_torch.cli import load_corpus
    from mpi_knn_tpu_torch.device import resolve_device
    from mpi_knn_tpu_torch.ivf import build_ivf_index, save_ivf_index

    device = resolve_device(args.device)
    X, _, source = load_corpus(args.data, limit=args.limit)
    if args.limit is not None:
        X = X[:args.limit]
    try:
        cfg = KNNConfig(
            k=args.k,
            metric=args.metric,
            backend=backend,
            dtype=args.dtype,
            recall_target=args.recall_target,
            partitions=args.partitions,
            nprobe=args.nprobe,
            bucket_headroom=args.bucket_headroom,
            kmeans_iters=args.kmeans_iters,
            kmeans_init=args.kmeans_init,
            ivf_seed=args.seed,
        )
    except ValueError as e:
        # an invalid knob combination (cosine, nprobe > partitions, ...)
        print(f"error: {e}", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    try:
        index = build_ivf_index(X, cfg, device=device)
    except ValueError as e:
        # the clustered path cannot honor it (a dense backend,
        # partitions > corpus rows, float64)
        print(f"error: {e}", file=sys.stderr)
        return 2
    build_s = time.perf_counter() - t0
    path = save_ivf_index(index, args.out)

    if not args.quiet:
        tuned = (
            f"tuned nprobe={index.nprobe} "
            f"(recall@{args.k}={index.tuned_recall:.4f} vs the full scan)"
            if index.tuned_recall is not None
            else f"nprobe={index.nprobe}"
        )
        frac = index.probe_bytes / max(index.nbytes_resident, 1)
        stages = ", ".join(f"{k} {v:.3f}s"
                           for k, v in index.build_seconds.items())
        print(
            f"[mpi_knn_tpu_torch build-index] {source} shape={X.shape} -> "
            f"{index.partitions} partitions (bucket_cap={index.bucket_cap}), "
            f"{tuned}; probes {100 * frac:.1f}% of corpus bytes/query; "
            f"build {build_s:.2f}s ({stages}); saved {path}"
        )
        if sharded:
            print("[mpi_knn_tpu_torch build-index] --backend ring: the shard "
                  "layout is derived at serve time; serve this file with "
                  "`query --index-load ... --backend ring --devices N` on "
                  "any shard count")
    return 0


if __name__ == "__main__":
    sys.exit(main())
