"""The port's CLI run path in a subprocess, held against the JAX API on the
same data."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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


# ---------------------------------------------------------------------------
# the reference's own data path and every single-host flag, in process,
# against the JAX CLI on the same files

from mpi_knn_tpu import cli as jax_cli  # noqa: E402
from mpi_knn_tpu_torch import cli as port_cli  # noqa: E402
from mpi_knn_tpu_torch.data.matfile import write_mat  # noqa: E402
from mpi_knn_tpu_torch.data.vecs import write_vecs  # noqa: E402


def _small_int_mat(path, m=400, d=16, seed=0, compress=True):
    """Small integers, each row followed by its mirror image about 20, so
    every even number of leading rows has column means of 20 and centers
    to integers: every distance is exact in f32 and both packages see the
    same ties. 1-based labels, in the reference's layout."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(6, 34, (5, d))
    y = rng.integers(0, 5, m // 2)
    half = centers[y] + rng.integers(-6, 7, (m // 2, d))
    X = np.stack([half, 40 - half], 1).reshape(m, d).astype(np.float64)
    y = np.stack([y, y + 5], 1).reshape(m)
    write_mat(path, {"train_X": X, "train_labels": (y + 1).astype(np.float64)},
              compress=compress)
    return X.astype(np.float32), y


def _both(tmp_path, argv, name="run"):
    """Run both CLIs with ``argv`` plus a report and saved neighbors each;
    returns ((port report, port npz), (jax report, jax npz))."""
    out = []
    for tag, main, extra in (("port", port_cli.main, ["--device", "cpu"]),
                             ("jax", jax_cli.main, [])):
        report = tmp_path / f"{name}_{tag}.json"
        nn = tmp_path / f"{name}_{tag}"
        assert main([*argv, *extra, "-q", "--report", str(report),
                     "--save-neighbors", str(nn)]) == 0
        out.append((json.loads(report.read_text()),
                    np.load(str(nn) + ".npz")))
    return out


@pytest.mark.parametrize("extra", [
    [], ["--backend", "pallas"], ["--topk-method", "bf16"],
    ["--topk-method", "block", "--topk-block", "32"],
    ["--merge-schedule", "stream", "--corpus-tile", "128"],
    ["--include-zero-dist"], ["--include-self"], ["--limit", "150"],
    ["--num-classes", "12", "--tie-break", "lowest"],
    ["--dtype", "float64"], ["--backend", "ring-overlap", "--devices", "4"],
], ids=lambda a: " ".join(a) or "default")
def test_mat_run_gives_the_jax_cli_ids_and_matches(tmp_path, extra):
    path = tmp_path / "X.mat"
    _small_int_mat(path)
    # "auto" is the ring on the tests' 8-device JAX host mesh: name it
    backend = [] if "--backend" in extra else ["--backend", "serial"]
    argv = ["--data", str(path), "--k", "10", "--loo", *backend, *extra]
    out = []
    for tag, main, more in (("port", port_cli.main, ["--device", "cpu"]),
                            ("jax", jax_cli.main, [])):
        report, nn = tmp_path / f"{tag}.json", tmp_path / f"{tag}.npz"
        assert main([*argv, *more, "-q", "--report", str(report),
                     "--save-neighbors", str(nn)]) == 0
        out.append((json.loads(report.read_text()), np.load(nn)))
    (got, gnn), (want, wnn) = out
    assert got["matches"] == want["matches"] and got["total"] == want["total"]
    assert np.array_equal(gnn["ids"], wnn["ids"])
    assert np.array_equal(gnn["predictions"], wnn["predictions"])
    np.testing.assert_allclose(gnn["dists"], wnn["dists"], rtol=1e-5, atol=1e-3)
    assert got["notes"]["mat_reader"] in ("native", "numpy")


def test_svd_run_gives_the_jax_cli_ids(tmp_path):
    path = tmp_path / "X.mat"
    X, y = make_blobs(300, 24, num_classes=4, seed=3)
    write_mat(path, {"train_X": X, "train_labels": y + 1})
    (got, gnn), (want, wnn) = _both(
        tmp_path, ["--data", str(path), "--svd", "8", "--k", "10", "--loo",
                   "--backend", "serial"])
    assert got["shape"] == want["shape"] == [300, 8]
    assert got["matches"] == want["matches"]
    assert np.array_equal(gnn["ids"], wnn["ids"])
    assert "svd" in got["phase_seconds"]


@pytest.mark.parametrize("suffix", [".npy", ".mat", ".fvecs"])
@pytest.mark.parametrize("svd", [False, True])
def test_query_mode_from_every_file_type(tmp_path, suffix, svd):
    path = tmp_path / "X.mat"
    X, y = _small_int_mat(path)
    Q = X[:37] + 1.0
    qpath = tmp_path / f"q{suffix}"
    if suffix == ".npy":
        np.save(qpath, Q)
    elif suffix == ".mat":
        write_mat(qpath, {"queries": Q})
    else:
        write_vecs(qpath, Q)
    argv = ["--data", str(path), "--queries", str(qpath), "--k", "5", "--loo",
            "--backend", "serial"]
    if svd:
        argv += ["--svd", "6"]
    (got, gnn), (want, wnn) = _both(tmp_path, argv)
    assert got["matches"] is None and want["matches"] is None
    assert got["notes"]["predictions"] == want["notes"]["predictions"]
    if svd:
        assert gnn["ids"].shape == (37, 5)
        from tests.oracle import recall_against_oracle
        assert recall_against_oracle(gnn["ids"], wnn["dists"], wnn["ids"], 5) == 1.0
    else:
        assert np.array_equal(gnn["ids"], wnn["ids"])


def test_sift_spec_and_fvecs_corpus(tmp_path):
    from mpi_knn_tpu_torch.data.synthetic import make_sift_like

    corpus = tmp_path / "base.fvecs"
    write_vecs(corpus, make_sift_like(500, seed=2))
    np.save(tmp_path / "q.npy", make_sift_like(20, seed=9))
    for spec in (str(corpus), "sift:500"):
        (got, gnn), (want, wnn) = _both(
            tmp_path, ["--data", spec, "--queries", str(tmp_path / "q.npy"),
                       "--k", "7", "--backend", "pallas"])
        assert got["shape"] == want["shape"] == [500, 128]
        assert np.array_equal(gnn["ids"], wnn["ids"])
        assert "predictions" not in gnn.files


def test_digits_matches_the_jax_cli(tmp_path):
    (got, gnn), (want, wnn) = _both(
        tmp_path, ["--data", "digits", "--limit", "600", "--k", "5", "--loo",
                   "--backend", "serial"])
    assert got["data_source"] == want["data_source"] == "digits(real)"
    assert got["matches"] == want["matches"] and got["total"] == 600


@pytest.mark.parametrize("argv", [
    ["--data", "synthetic:300x16c4", "--k", "5", "--loo", "--backend",
     "serial"],
    ["--data", "synthetic:300x16c4", "--k", "5", "--backend", "pallas",
     "--recall-vs-serial", "--recall-sample", "50"],
    ["--data", "synthetic:300x16c4", "--k", "5", "--backend", "serial",
     "--recall-vs-serial"],
])
def test_reports_carry_the_reference_keys(tmp_path, argv):
    (got, _), (want, _) = _both(tmp_path, argv)
    assert set(want) <= set(got)
    assert set(got["notes"]) == set(want["notes"])
    host_only = {"platform", "dp", "coordinator", "num_processes", "process_id"}
    assert set(want["config"]) - host_only <= set(got["config"])
    assert got["recall_vs_baseline"] == want["recall_vs_baseline"]
    assert set(got["phase_seconds"]) == set(want["phase_seconds"])


@pytest.mark.parametrize("method", ["approx", "approx-rerank", "bf16"])
@pytest.mark.parametrize("backend", ["pallas", "serial"])
def test_approx_methods_with_recall_vs_serial(tmp_path, method, backend,
                                              capsys):
    """Measured, not a trivial 1.0, on the serial backend too: the
    baseline is exact serial, which an approximate method is not."""
    report = tmp_path / "r.json"
    assert port_cli.main(
        ["--data", "synthetic:800x16c4", "--k", "5", "--loo", "--device",
         "cpu", "--backend", backend, "--corpus-tile", "256",
         "--topk-method", method, "--recall-vs-serial", "--recall-sample",
         "0", "--report", str(report)]) == 0
    doc = json.loads(report.read_text())
    assert doc["config"]["topk_method"] == method
    assert doc["recall_vs_baseline"] >= 0.95
    assert doc["notes"]["recall_sample"] == 800
    assert "recall-vs-serial=" in capsys.readouterr().out


def test_one_based_ids_and_quiet(tmp_path, capsys):
    argv = ["--data", "synthetic:64x8c2", "--k", "3", "--device", "cpu"]
    assert port_cli.main([*argv, "--one-based-ids"]) == 0
    out = capsys.readouterr().out
    assert "neighbor ids (1-based, first 5 queries):" in out
    assert port_cli.main([*argv, "-q"]) == 0
    assert capsys.readouterr().out == ""


def test_save_neighbors_name_is_normalised(tmp_path, capsys):
    assert port_cli.main(["--data", "synthetic:64x8c2", "--k", "3",
                          "--device", "cpu", "--save-neighbors",
                          str(tmp_path / "nn")]) == 0
    assert f"neighbors written to {tmp_path / 'nn.npz'}" in capsys.readouterr().out
    saved = np.load(tmp_path / "nn.npz")
    assert set(saved.files) == {"dists", "ids", "predictions"}


def test_profile_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert port_cli.main(["--data", "synthetic:64x8c2", "--k", "3",
                          "--device", "cpu", "-q", "--profile",
                          str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_every_subcommand_is_ported():
    assert port_cli.UNPORTED_SUBCOMMANDS == ()


@pytest.mark.parametrize("sub", ["lint"])
def test_lint_runs_through_the_run_cli(sub, tmp_path, capsys):
    """``lint`` (once refused by name) runs its matrix: a filtered sweep on
    the CPU exits 0 and writes its report."""
    assert port_cli.main([sub, "--device", "cpu", "--backend", "serial",
                          "--metric", "l2", "--dtype", "float64", "--out",
                          str(tmp_path)]) == 0
    assert "0 finding(s) on cpu" in capsys.readouterr().out
    doc = json.loads((tmp_path / "report.json").read_text())
    assert doc["ok"] and [t["label"] for t in doc["targets"]] == [
        "serial/l2/float64"]


def test_process_id_alone_is_refused_in_the_reference_words(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    argv = ["--data", "synthetic:64x8c2", "--device", "cpu", "--process-id", "1"]
    with pytest.raises(SystemExit) as port:
        port_cli.main(argv)
    with pytest.raises(SystemExit) as ref:
        jax_cli.main(argv[:2] + argv[4:])
    assert str(port.value) == str(ref.value)
    assert "refusing to silently run single-host" in str(port.value)


_RUN_ARGV = ["--data", "synthetic:256x16c4", "--k", "5", "--loo",
             "--backend", "ring-overlap", "--corpus-tile", "32"]
_POD_ARGV = [*_RUN_ARGV, "--device", "cpu", "--devices", "4"]


def _cli_pod(tmp_path, extra, name):
    """The run CLI in two processes against one local coordinator, "{pid}"
    in ``extra`` naming the process; returns each process's (report, saved
    neighbors, output)."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for pid in range(2):
        argv = [*_POD_ARGV, *(a.format(pid=pid) for a in extra),
                "--coordinator", addr, "--num-processes",
                "2", "--process-id", str(pid), "--report",
                str(tmp_path / f"{name}-{pid}.json"), "--save-neighbors",
                str(tmp_path / f"{name}-{pid}.npz")]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "mpi_knn_tpu_torch", *argv], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the CLI pod hung:\n" + "\n".join(p.communicate()[0] or ""
                                                        for p in procs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return [(json.loads((tmp_path / f"{name}-{pid}.json").read_text()),
             np.load(tmp_path / f"{name}-{pid}.npz"), outs[pid])
            for pid in range(2)]


def test_two_process_run_gives_the_jax_cli_ids(tmp_path):
    """Two processes of 4 logical ranks each (an 8-rank ring) with a
    checkpoint directory each: every process's report carries the start-up
    info and its saved ids are the JAX CLI's single-process run's; only
    process 0 writes a checkpoint."""
    got = _cli_pod(tmp_path, ["--checkpoint-dir", str(tmp_path / "ck{pid}"), "-q"],
                   "a")
    ref, one = tmp_path / "ref", tmp_path / "one"
    assert jax_cli.main([*_RUN_ARGV, "--devices", "4", "--save-neighbors",
                         str(ref)]) == 0
    want = np.load(str(ref) + ".npz")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the pod's processes run
    try:
        assert port_cli.main([*_RUN_ARGV, "--device", "cpu", "--devices", "8",
                              "--save-neighbors", str(one)]) == 0
    finally:
        torch.set_num_threads(threads)
    single = np.load(str(one) + ".npz")
    for pid, (report, nn, _) in enumerate(got):
        dist = report["notes"]["distributed"]
        assert (dist["process_id"], dist["num_processes"]) == (pid, 2)
        assert dist["backend"] == "gloo" and dist["devices"] == 8
        assert dist["local_devices"] == 4
        assert report["backend"] == "ring-overlap"
        assert report["config"]["num_processes"] == 2
        assert "gather" in report["phase_seconds"]
        assert np.array_equal(nn["ids"], want["ids"])
        # bit for bit the port's single-process run over the same 8 ranks
        assert np.array_equal(nn["ids"], single["ids"])
        assert np.array_equal(nn["dists"], single["dists"])
    assert (tmp_path / "ck0" / "knn_state.npz").exists()
    assert not (tmp_path / "ck1" / "knn_state.npz").exists()


def test_two_process_run_killed_and_resumed(tmp_path):
    """The same pod stopped after 3 of 8 rounds into process 0's
    checkpoint directory (process 1's stays empty), then run again by the
    CLI: both processes resume at round 3 from process 0's broadcast and
    save the uninterrupted run's ids."""
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
    from mpi_knn_tpu_torch.cli import build_parser, config_from_args, load_corpus
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    # the pod's config (4 ranks a process) over its 8-rank ring
    cfg = config_from_args(build_parser().parse_args(_POD_ARGV))
    X, _, _ = load_corpus("synthetic:256x16c4")
    all_knn_ring_resumable(X, X, np.arange(256, dtype=np.int32), cfg,
                           mesh=make_ring_mesh(8, device="cpu"),
                           checkpoint_dir=tmp_path / "ck0",
                           stop_after_rounds=3, device="cpu")
    got = _cli_pod(tmp_path, ["--checkpoint-dir", str(tmp_path / "ck{pid}"), "-v"],
                   "b")
    whole = _cli_pod(tmp_path, ["-q"], "c")
    for (report, nn, out), (_, w, _) in zip(got, whole):
        assert "resuming ring at round 3/8" in out
        assert np.array_equal(nn["ids"], w["ids"])
        assert np.array_equal(nn["dists"], w["dists"])


@pytest.mark.parametrize("extra,single", [
    (["--devices", "2"], ["--devices", "4"]),
    (["--dp", "2"], ["--devices", "8", "--dp", "2"]),
])
def test_two_process_run_with_ranks_a_process_and_dp(tmp_path, extra, single):
    """The run CLI in two processes with ``--devices 2`` (a 4-rank ring)
    and with ``--dp 2`` (a 2 × 4 grid, each dp group inside one process):
    every process saves the port's single-process run over the same ranks,
    bit for bit, and the JAX CLI's ids; the report counts the global
    devices."""
    got = _cli_pod(tmp_path, [*extra, "-q"], "d")
    one, ref = tmp_path / "one", tmp_path / "ref"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the pod's processes run
    try:
        assert port_cli.main([*_RUN_ARGV, "--device", "cpu", *single,
                              "--save-neighbors", str(one)]) == 0
    finally:
        torch.set_num_threads(threads)
    want = np.load(str(one) + ".npz")
    assert jax_cli.main([*_RUN_ARGV, "--devices", "4", "--save-neighbors",
                         str(ref)]) == 0
    jax_ids = np.load(str(ref) + ".npz")["ids"]
    for report, nn, _ in got:
        dist = report["notes"]["distributed"]
        local = 2 if extra[0] == "--devices" else 4
        assert (dist["devices"], dist["local_devices"]) == (2 * local, local)
        assert np.array_equal(nn["ids"], want["ids"])
        assert np.array_equal(nn["dists"], want["dists"])
        assert np.array_equal(nn["ids"], jax_ids)


def test_dp_that_does_not_divide_the_pod_s_devices_is_refused():
    """The JAX CLI's check over the global device count: processes ×
    devices."""
    args = port_cli.build_parser().parse_args(
        [*_RUN_ARGV, "--device", "cpu", "--devices", "3", "--dp", "4"])
    with pytest.raises(SystemExit, match="--dp 4 must divide the device count 6"):
        port_cli._mesh2d(args, torch.device("cpu"), {"devices": 6})


def test_missing_data_file_is_named():
    with pytest.raises(SystemExit, match="is not a file"):
        port_cli.main(["--data", "absent.mat", "--device", "cpu"])


@pytest.mark.parametrize("suffix", [".mat", ".fvecs", ".bvecs"])
@pytest.mark.parametrize("method", ["exact", "approx-rerank", "bf16"])
def test_query_subcommand_reads_every_query_file(tmp_path, suffix, method):
    rng = np.random.default_rng(4)
    Q = rng.integers(0, 200, (30, 8)).astype(np.float32)
    qpath = tmp_path / f"q{suffix}"
    if suffix == ".mat":
        write_mat(qpath, {"queries": Q})
    else:
        write_vecs(qpath, Q)
    report = tmp_path / "r.json"
    assert port_cli.main(["query", "--data", "synthetic:300x8c2", "--queries",
                          str(qpath), "--batch", "8", "--bucket", "8",
                          "--k", "3", "--topk-method", method, "--device",
                          "cpu", "-q", "--report", str(report)]) == 0
    assert json.loads(report.read_text())["queries"] == 30
