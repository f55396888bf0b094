"""Time one pallas main path from two checkouts of the repository, alternately.

Each run is a process of its own that imports the port from one tree,
builds its kernels there, and drives the path as ``chip_smoke.py`` does:
``make_mnist_like(60000)`` (seed 0), k=10, leave-one-out, through
``KNNClassifier(backend="pallas", pallas_variant=..., precision_policy=...)``.
After one warm-up it times the host-input form (``clf.kneighbors(None)``)
and the device-input form (``all_knn`` of the rows already on the card),
``--reps`` times each, and prints one JSON line. The runs go in the order
A B B A, ``--rounds`` times, so that drift of the card or the host falls
on both trees alike. The last line gives, for each tree and form, the
median over its runs' medians and their spread (min, max), and the
difference of the medians, B - A.

    python3 tools/ab_main_path.py --a <parent checkout> --b . --rounds 2

Needs one card; ``--variant`` and ``--policy`` pick the path (default
``sweep`` / ``mixed``: the one K2[c] runs).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

M, K = 60000, 10


def child(root: str, variant: str, policy: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import torch

    import mpi_knn_tpu_torch
    from mpi_knn_tpu_torch import KNNClassifier, all_knn
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import fused_knn

    here = os.path.dirname(os.path.abspath(mpi_knn_tpu_torch.__file__))
    if os.path.dirname(here) != os.path.abspath(root):
        raise SystemExit(f"imported the port from {here}, not from {root}")
    if not torch.cuda.is_available():
        raise SystemExit("no card")
    device = torch.device("cuda", 0)
    X, y = make_mnist_like(M)
    clf = KNNClassifier(k=K, device="cuda", backend="pallas", pallas_variant=variant,
                        precision_policy=policy).fit(X, y)
    Xd = torch.from_numpy(X).to(device)

    def timed(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    for name in fused_knn.LAUNCHES:
        fused_knn.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    clf.kneighbors(None)  # warm-up: builds the kernels at first use
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = {k: v for k, v in fused_knn.LAUNCHES.items() if v}
    host = timed(lambda: clf.kneighbors(None))
    dev = timed(lambda: all_knn(Xd, config=clf.config, device=device))
    return {"root": os.path.abspath(root), "variant": variant, "policy": policy,
            "launches_warm_up": launches, "warm_up_s": warm_s,
            "host_input_ms": host, "device_input_ms": dev,
            "host_input_ms_median": statistics.median(host),
            "device_input_ms_median": statistics.median(dev)}


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", help="the first tree (the parent)")
    ap.add_argument("--b", help="the second tree (the change)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variant", default="sweep", choices=["tiles", "sweep"])
    ap.add_argument("--policy", default="mixed", choices=["exact", "mixed"])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.variant, args.policy, args.reps)))
        return 0
    if not (args.a and args.b):
        ap.error("--a and --b are required")
    print(smi(), flush=True)
    runs = {"A": [], "B": []}
    for _ in range(args.rounds):
        for tree in "ABBA":
            root = os.path.abspath(args.a if tree == "A" else args.b)
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 "--variant", args.variant, "--policy", args.policy,
                 "--reps", str(args.reps)],
                capture_output=True, text=True, cwd=root)
            if p.returncode != 0:
                sys.stderr.write(p.stderr)
                print(f"run of tree {tree} ({root}) failed: rc {p.returncode}",
                      file=sys.stderr)
                return 1
            line = json.loads(p.stdout.strip().splitlines()[-1])
            line["tree"] = tree
            print(json.dumps(line), flush=True)
            runs[tree].append(line)
    summary = {"variant": args.variant, "policy": args.policy, "rounds": args.rounds,
               "reps": args.reps, "nvidia_smi": smi()}
    for form in ("host_input_ms_median", "device_input_ms_median"):
        for tree in "AB":
            vals = [r[form] for r in runs[tree]]
            summary[f"{tree}_{form}"] = statistics.median(vals)
            summary[f"{tree}_{form}_spread"] = [min(vals), max(vals)]
        summary[f"B_minus_A_{form}"] = (summary[f"B_{form}"] - summary[f"A_{form}"])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
