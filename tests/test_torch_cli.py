"""The port's CLI run path in a subprocess, held against the JAX API on the
same data."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.data.synthetic import make_blobs

REPO = Path(__file__).resolve().parent.parent


def test_cli_loo_matches_jax_api(tmp_path):
    report = tmp_path / "r.json"
    subprocess.run(
        [sys.executable, "-m", "mpi_knn_tpu_torch", "--data",
         "synthetic:512x32c4", "--k", "5", "--loo", "--device", "cpu",
         "--report", str(report)],
        cwd=REPO, check=True, capture_output=True, text=True, timeout=300,
    )
    got = json.loads(report.read_text())
    X, y = make_blobs(512, 32, num_classes=4, seed=0)
    res = jax_pkg.all_knn(X, k=5, backend="serial")
    want = int(jax_pkg.knn_classify(res, y).matches(y))
    assert got["matches"] == want
    assert got["total"] == 512 and got["backend"] == "serial"
    assert got["device"] == "cpu" and got["shape"] == [512, 32]
    assert np.isfinite(got["phase_seconds"]["knn"])


def test_cli_ring_fused_mixed_matches_jax_api(tmp_path):
    report = tmp_path / "r.json"
    subprocess.run(
        [sys.executable, "-m", "mpi_knn_tpu_torch", "--data",
         "synthetic:512x32c4", "--k", "5", "--loo", "--device", "cpu",
         "--devices", "4", "--backend", "ring-overlap", "--ring-fusion",
         "fused", "--precision-policy", "mixed", "--ring-schedule", "bidir",
         "--ring-transfer-dtype", "int8", "--corpus-tile", "64",
         "--report", str(report)],
        cwd=REPO, check=True, capture_output=True, text=True, timeout=300,
    )
    got = json.loads(report.read_text())
    X, y = make_blobs(512, 32, num_classes=4, seed=0)
    res = jax_pkg.all_knn(X, k=5, backend="ring-overlap", num_devices=4,
                          precision_policy="mixed", ring_schedule="bidir",
                          ring_transfer_dtype="int8", corpus_tile=64)
    want = int(jax_pkg.knn_classify(res, y).matches(y))
    assert got["matches"] == want
    assert got["backend"] == "ring-overlap" and got["num_devices"] == 4
    assert (got["ring_fusion"], got["ring_schedule"],
            got["ring_transfer_dtype"]) == ("fused", "bidir", "int8")
