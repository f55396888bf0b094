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


def _run_cli(argv):
    return subprocess.run(
        [sys.executable, "-m", "mpi_knn_tpu_torch", *argv], cwd=REPO,
        check=True, capture_output=True, text=True, timeout=300)


def test_cli_ring_checkpoint_kill_and_resume(tmp_path):
    """A ring run stopped after 2 of 4 rounds into --checkpoint-dir (the
    CLI's own config and data), then resumed by the CLI: it resumes at
    round 2 and matches the JAX package's uninterrupted run."""
    from mpi_knn_tpu_torch.backends.ring_resumable import (
        all_knn_ring_resumable,
    )
    from mpi_knn_tpu_torch.cli import build_parser, config_from_args, load_corpus

    argv = ["--data", "synthetic:256x16c4", "--k", "5", "--loo", "--device",
            "cpu", "--devices", "4", "--backend", "ring-overlap",
            "--ring-fusion", "fused", "--ring-fused-rotation", "round",
            "--corpus-tile", "32", "--checkpoint-dir", str(tmp_path)]
    cfg = config_from_args(build_parser().parse_args(argv))
    X, y, _ = load_corpus("synthetic:256x16c4")
    all_knn_ring_resumable(X, X, np.arange(256, dtype=np.int32), cfg,
                           checkpoint_dir=tmp_path, stop_after_rounds=2,
                           device="cpu")
    report = tmp_path / "r.json"
    out = _run_cli([*argv, "-v", "--report", str(report)])
    assert "resuming ring at round 2/4" in out.stderr
    got = json.loads(report.read_text())
    assert got["ring_fused_rotation"] == "round"
    assert got["checkpoint_dir"] == str(tmp_path)
    res = jax_pkg.all_knn(X, k=5, backend="ring-overlap", num_devices=4,
                          corpus_tile=32)
    assert got["matches"] == int(jax_pkg.knn_classify(res, y).matches(y))


def test_cli_serial_checkpoint_resumes_and_save_every(tmp_path):
    argv = ["--data", "synthetic:512x32c4", "--k", "5", "--loo", "--device",
            "cpu", "--backend", "serial", "--corpus-tile", "128",
            "--checkpoint-dir", str(tmp_path), "--save-every", "2", "-v"]
    first = _run_cli(argv)
    assert "resuming" not in first.stderr
    second = _run_cli(argv)
    assert "resuming serial stream at tile 4/4" in second.stderr
    X, y = make_blobs(512, 32, num_classes=4, seed=0)
    res = jax_pkg.all_knn(X, k=5, backend="serial")
    want = int(jax_pkg.knn_classify(res, y).matches(y))
    for out in (first, second):
        assert f"Matches: {want}" in out.stdout


def test_cli_grid_on_the_cpu_is_refused():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_knn_tpu_torch", "--data",
         "synthetic:64x8c2", "--k", "3", "--loo", "--device", "cpu",
         "--devices", "2", "--backend", "ring-overlap", "--ring-fusion",
         "fused", "--ring-fused-rotation", "grid"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "ring_fused_rotation='round' off a CUDA card" in proc.stderr
