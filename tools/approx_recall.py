"""Recall of the approximate top-k methods on the serial backend, over
every query row, across seeds of the data; and the host cost of one
tile's top-k call by method.

For each seed, ``make_mnist_like(--rows, seed)`` (k=10, leave-one-out)
goes through ``all_knn`` on the serial backend: once with the exact
method (the baseline), then once per (schedule, method) of ``--schedules``
and ``--methods``. Each reading is recall@10 of that run's ids against the
baseline's over all rows (what ``--recall-vs-serial --recall-sample 0``
reports) and prints as one JSON line. On ``--device cpu`` the approximate
reduction is the plain bin minimum, on ``cuda`` its kernel
(``csrc/approx_topk.cu``); the two agree bit for bit on equal inputs, so at
equal rows the readings differ only where the distance tiles do.

With ``--tile-calls`` (a card only) it also times ``smallest_k`` on one
1024 x 2048 tile, the serial twolevel tile, for each method: the call as
the host sees it (synchronized wall clock) and the card's time for it (CUDA
events), means of 200 calls after a warm-up.

    python3 tools/approx_recall.py --device cuda --rows 60000 --seeds 0 1 2 3 4
    python3 tools/approx_recall.py --device cpu --rows 8192 --seeds 0 1
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_knn_tpu_torch import all_knn  # noqa: E402
from mpi_knn_tpu_torch.data.synthetic import make_mnist_like  # noqa: E402
from mpi_knn_tpu_torch.utils.report import recall_at_k  # noqa: E402

K = 10


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def readings(device, rows, seeds, schedules, methods):
    for seed in seeds:
        X, _ = make_mnist_like(rows, seed=seed)
        t0 = time.perf_counter()
        base = all_knn(X, k=K, backend="serial", device=device)
        sync(device)
        base_s = time.perf_counter() - t0
        want = base.ids.cpu().numpy()
        for schedule in schedules:
            for method in methods:
                t0 = time.perf_counter()
                got = all_knn(X, k=K, backend="serial", merge_schedule=schedule,
                              topk_method=method, device=device)
                sync(device)
                print(json.dumps({
                    "reading": "recall", "device": device.type, "rows": rows,
                    "seed": seed, "schedule": schedule, "method": method,
                    "recall_at_10": recall_at_k(got.ids.cpu().numpy(), want),
                    "run_s": time.perf_counter() - t0, "exact_run_s": base_s}),
                    flush=True)


def tile_calls(device, reps=200):
    from mpi_knn_tpu_torch.ops.topk import smallest_k

    g = torch.Generator(device="cpu").manual_seed(0)
    d = (torch.randn(1024, 2048, generator=g) ** 2).to(device)
    ids = torch.arange(2048, dtype=torch.int32, device=device)
    for method in ("exact", "bf16", "approx", "approx-rerank"):
        def call():
            return smallest_k(d, ids, K, method=method)

        for _ in range(10):
            call()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        sync(device)
        wall = 1e3 * (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):  # the host's part: enqueue without waiting
            call()
        host = 1e3 * (time.perf_counter() - t0) / reps
        sync(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        dev = []
        for _ in range(reps):
            start.record()
            call()
            end.record()
            end.synchronize()
            dev.append(start.elapsed_time(end))
        print(json.dumps({"reading": "tile_call", "method": method,
                          "shape": [1024, 2048], "wall_ms": wall,
                          "enqueue_ms": host, "events_ms": float(np.mean(dev))}),
              flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--rows", type=int, default=60000)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--schedules", nargs="+", default=["stream", "twolevel"])
    p.add_argument("--methods", nargs="+", default=["approx-rerank", "approx"])
    p.add_argument("--tile-calls", action="store_true")
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no card")
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if args.tile_calls:
        if device.type != "cuda":
            raise SystemExit("--tile-calls times the card")
        tile_calls(device)
    readings(device, args.rows, args.seeds, args.schedules, args.methods)
    return 0


if __name__ == "__main__":
    sys.exit(main())
