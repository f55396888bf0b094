"""The capacity planner's recall calibration, with the port's own code.

Recall of the clustered index is a property of the algorithm (k-means,
the probe, the exact finish, the at-rest quantization), not of the chip,
so the calibration runs on the CPU. The recipe is the JAX package's bench
recipe for the same rows (``scripts/bench_ops.py:640-760``), on the port:

- corpus ``make_sift_like(8192, 128, seed=0)``, k = 10, 64 partitions
  (``max(2, min(64, 8192 // 128))``), k-means from the port's seeded
  ``torch.Generator`` (``KNNConfig.ivf_seed`` 0, 25 rounds);
- the oracle: 256 corpus rows (``np.linspace`` over the corpus) against
  the whole corpus in f64, zero distances excluded (each row's own), the
  10 nearest by a stable sort;
- ``ivf_query`` rows: one float32 index searched at nprobe 1, 4 and 16
  (its zero rule drops the self-hit), recall@10 of its ids against the
  oracle's;
- ``ivf_at_rest`` rows: an index per at-rest dtype (float32, bfloat16,
  int8, int4) at nprobe 4, searched with the rows' ids (a quantized store
  reconstructs a row at a nonzero distance, so the self-hit is dropped by
  id), recall@10 against the same oracle.

The rows keep the JAX package's bench schema (``results`` of ``op``,
``variant``, ``probe_fraction``, ``recall_at_k``), which the planner reads
(``plan.load_calibration``). The committed
``mpi_knn_tpu_torch/analysis/plan_calibration.json`` was written by

    python3 tools/plan_calibration.py

on the CPU (seed 0 for the corpus and for k-means, as above); ``--out -``
prints the document instead. ``--only-nprobe4-float32`` computes just the
``p64-nprobe4`` ``ivf_query`` row (the tests regenerate it).
``tests/test_torch_plan.py`` holds the file to the JAX package's committed
rows (``measurements/bench_ops.json``) and its ``ivf_query`` sweep to the
JAX package's own recipe run on the CPU at the same seed.

The planner reads the sweep between its smallest and largest probe
fractions only (``plan._min_nprobe`` plans no nprobe below 1/64 here):
below it the log-linear model extrapolates.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from mpi_knn_tpu_torch import KNNConfig  # noqa: E402
from mpi_knn_tpu_torch.data.synthetic import make_sift_like  # noqa: E402
from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf  # noqa: E402
from mpi_knn_tpu_torch.utils.report import recall_at_k  # noqa: E402

M, D, K, SEED = 8192, 128, 10, 0
PARTITIONS = max(2, min(64, M // 128))
ORACLE_ROWS = 256
NPROBES = (1, 4, 16)
AT_REST_NPROBE = 4
STORES = ("float32", "bfloat16", "int8", "int4")
# the at-rest caps again on a denser corpus, the README deployment's
# (sift:100000 at 256 partitions), at the recipe's probe fraction (1/64):
# quantization costs more recall where the neighbours lie closer
DENSE_M, DENSE_PARTITIONS, DENSE_NPROBE = 100000, 256, 4
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "mpi_knn_tpu_torch", "analysis", "plan_calibration.json")


def corpus_and_oracle(m: int = M):
    """The corpus, the oracle's sample rows and their f64 10 nearest."""
    X = make_sift_like(m=m, d=D, seed=SEED).astype(np.float32)
    sample = np.linspace(0, m - 1, num=ORACLE_ROWS, dtype=np.int64)
    X64 = X.astype(np.float64)
    od = ((X64[sample] ** 2).sum(1)[:, None] + (X64 ** 2).sum(1)[None, :]
          - 2.0 * (X64[sample] @ X64.T))
    od[od <= 1e-9] = np.inf
    return X, sample, np.argsort(od, axis=1, kind="stable")[:, :K]


def query_row(index, X, sample, oracle, nprobe: int) -> dict:
    got = search_ivf(index, X[sample], nprobe=nprobe, device="cpu")[1]
    return {"op": "ivf_query", "variant": f"p{PARTITIONS}-nprobe{nprobe}",
            "probe_fraction": round(nprobe / PARTITIONS, 4),
            "recall_at_k": round(float(recall_at_k(got.numpy(), oracle)), 4)}


def query_index(X):
    return build_ivf_index(X, KNNConfig(k=K, partitions=PARTITIONS,
                                        nprobe=PARTITIONS, query_tile=1024,
                                        query_bucket=128), device="cpu")


def at_rest_rows(m: int, partitions: int, nprobe: int, op: str,
                 prefix: str) -> list:
    """One index a store at ``partitions`` / ``nprobe`` over the m-row
    corpus, searched with the oracle rows' ids; recall@10 a store."""
    X, sample, oracle = corpus_and_oracle(m)
    rows = []
    for store in STORES:
        idx = build_ivf_index(X, KNNConfig(k=K, partitions=partitions,
                                           nprobe=nprobe, query_tile=1024,
                                           query_bucket=128, dtype=store),
                              device="cpu")
        got = search_ivf(idx, X[sample], query_ids=sample.astype(np.int32),
                         device="cpu")[1]
        rows.append({
            "op": op, "variant": f"{prefix}nprobe{nprobe}-{store}",
            "recall_at_k": round(float(recall_at_k(got.numpy(), oracle)), 4),
            "at_rest_bytes": idx.nbytes_resident,
        })
    return rows


def calibration() -> dict:
    X, sample, oracle = corpus_and_oracle()
    index = query_index(X)
    results = [query_row(index, X, sample, oracle, n) for n in NPROBES]
    results += at_rest_rows(M, PARTITIONS, AT_REST_NPROBE, "ivf_at_rest",
                            f"p{PARTITIONS}-")
    results += at_rest_rows(DENSE_M, DENSE_PARTITIONS, DENSE_NPROBE,
                            "ivf_at_rest_dense",
                            f"m{DENSE_M}-p{DENSE_PARTITIONS}-")
    return {
        "schema": "plan-calibration/1",
        "source": "tools/plan_calibration.py (mpi_knn_tpu_torch on the CPU)",
        "shapes": {"m": M, "d": D, "k": K, "partitions": PARTITIONS,
                   "oracle_rows": ORACLE_ROWS, "seed": SEED,
                   "dense": {"m": DENSE_M, "partitions": DENSE_PARTITIONS,
                             "nprobe": DENSE_NPROBE}},
        "results": results,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT,
                   help="where to write the document ('-': stdout)")
    p.add_argument("--only-nprobe4-float32", action="store_true",
                   help="print only the p64-nprobe4 ivf_query row")
    args = p.parse_args(argv)
    if args.only_nprobe4_float32:
        X, sample, oracle = corpus_and_oracle()
        print(json.dumps(query_row(query_index(X), X, sample, oracle,
                                   AT_REST_NPROBE)))
        return 0
    text = json.dumps(calibration(), indent=1) + "\n"
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
