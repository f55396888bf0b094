"""The port's capacity planner (``mpi_knn_tpu_torch/plan.py``) and its
analysis layer (``analysis/cost.py``, ``analysis/memory.py``, the device
profiles and the recall calibration): parity with ``mpi_knn_tpu.plan`` on
``cpu-test`` (closed forms, roofline, recall interpolation, refusals), the
calibration against the JAX package's committed bench rows, the emitted
commands run on the CPU against the predictions, the doctor's plan line,
and the planner's torch-free import.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
import shlex
import subprocess
import sys

import numpy as np
import pytest

from mpi_knn_tpu_torch import plan as port_plan
from mpi_knn_tpu_torch import shapes as port_shapes
from mpi_knn_tpu_torch.analysis import cost as port_cost
from mpi_knn_tpu_torch.analysis import memory as port_memory
from mpi_knn_tpu_torch.config import KNNConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
BENCH = REPO / "measurements" / "bench_ops.json"

# the JAX package's refusal cases (tests/test_cost_plan.py:327-353)
REFUSALS = [
    (["--corpus", "100000000", "--dim", "128", "--hbm-bytes", "1000000"],
     "hbm", "exceeds the budget"),
    (["--corpus", "4096", "--dim", "32", "--recall-target", "0.999",
      "--dtype", "int4"], "recall", "int4"),
    (["--corpus", "4096", "--dim", "32", "--qps", "1000000000000"],
     "qps", "roofline"),
]


# ---------------------------------------------------------------------------
# profiles, closed forms, roofline: parity on cpu-test


def test_profiles_cpu_test_is_the_references_and_h100_names_its_card():
    from mpi_knn_tpu.analysis import cost as ref_cost

    ours = port_cost.load_profiles()
    assert set(ours) == {"cpu-test", "h100-sxm-80gb"}  # no TPU profile
    figures = ("peak_flops", "hbm_bw", "ici_bw", "hbm_bytes")
    ref = ref_cost.get_profile("cpu-test")
    assert {k: ours["cpu-test"][k] for k in figures} == \
        {k: ref[k] for k in figures}
    h100 = ours["h100-sxm-80gb"]
    assert "H100 80GB HBM3" in h100["_doc"] and "700.00 W" in h100["_doc"]
    assert h100["peak_flops"] == pytest.approx(486.0e12 / 3)
    assert h100["hbm_bw"] == 3.35e12
    with pytest.raises(KeyError, match="unknown device profile"):
        port_cost.get_profile("tpu-v4")


@pytest.mark.parametrize("platform,name,want", [
    ("cpu", "", "cpu-test"),
    ("cuda", "NVIDIA H100 80GB HBM3", "h100-sxm-80gb"),
    ("cuda", "NVIDIA H100 PCIe", "h100-sxm-80gb"),
    ("cuda", "NVIDIA A100-SXM4-80GB", None),
    ("mps", "", None),
])
def test_profile_for_device_never_guesses(platform, name, want):
    assert port_cost.profile_for_device(platform, name) == want


def test_detected_profile_on_the_cpu():
    got = port_cost.detected_profile("cpu")
    assert got["name"] == "cpu-test"
    assert got["hbm_bytes"] == port_cost.get_profile("cpu-test")["hbm_bytes"]


def test_analytical_flops_and_roofline_equal_the_reference():
    from mpi_knn_tpu.analysis import cost as ref_cost

    facts = [{"scheme": "zero", "q": 1, "d": 1}]
    for q, c, d, sites, trips, w, rb in itertools.product(
            (1, 64, 1024), (128, 2048), (8, 128), (1, 2), (1, 4),
            (0, 40), (0, 3)):
        facts.append({"scheme": "dense", "q": q, "c": c, "d": d,
                      "sites": sites, "trips": trips, "w": w,
                      "rblocks": rb})
    for q, P, d, n, cap in itertools.product(
            (16, 512), (64, 256), (32, 128), (1, 3), (72, 1216)):
        facts.append({"scheme": "ivf", "q": q, "d": d, "partitions": P,
                      "nprobe": n, "bucket_cap": cap})
    prof = port_cost.get_profile("cpu-test")
    rprof = ref_cost.get_profile("cpu-test")
    for f in facts:
        flops = port_cost.analytical_mxu_flops(f)
        assert flops == ref_cost.analytical_mxu_flops(f), f
        for hbm, ici in ((0, 0), (10 ** 9, 0), (10 ** 6, 10 ** 9)):
            assert port_cost.roofline(flops, hbm, ici, f["q"], prof) == \
                ref_cost.roofline(flops, hbm, ici, f["q"], rprof)
    with pytest.raises(ValueError, match="unknown cost scheme"):
        port_cost.analytical_mxu_flops({"scheme": "nope", "q": 1, "d": 1})


def test_predict_recall_equals_the_reference_on_one_calibration():
    from mpi_knn_tpu import plan as ref_plan

    calib = ref_plan.load_calibration(BENCH)
    ours = port_plan.load_calibration()
    for c in (calib, ours):
        for frac in (1e-4, 0.001, 0.0156, 0.03, 0.0625, 0.2, 0.25, 0.6, 1.0):
            for dt in port_plan.PLAN_DTYPES:
                assert port_plan.predict_recall(frac, dt, c) == \
                    ref_plan.predict_recall(frac, dt, c)


@pytest.mark.parametrize("argv,constraint,needle", REFUSALS,
                         ids=[r[1] for r in REFUSALS])
def test_refusals_name_the_references_binding_constraint(capsys, argv,
                                                         constraint, needle):
    from mpi_knn_tpu import plan as ref_plan

    assert ref_plan.main(argv + ["-q"]) == 2
    ref = json.loads(capsys.readouterr().out)
    assert port_plan.main(argv + ["-q"]) == 2  # auto: the CPU's profile
    doc = json.loads(capsys.readouterr().out)
    assert doc["feasible"] is False
    assert doc["binding_constraint"] == ref["binding_constraint"] \
        == constraint
    assert needle in doc["detail"]
    assert doc["rejected"][constraint] > 0
    assert doc["closest_candidate"]["backend"] in port_plan.PLAN_BACKENDS
    assert doc["closest_candidate"]["backend"] == \
        ref["closest_candidate"]["backend"]


def test_infeasible_on_the_h100_profile_is_hbm_and_unknown_is_usage(capsys):
    argv = ["--corpus", "2000000000", "--dim", "128", "--device-profile",
            "h100-sxm-80gb", "-q"]
    assert port_plan.main(argv) == 2
    doc = json.loads(capsys.readouterr().out)
    assert doc["binding_constraint"] == "hbm"
    assert port_plan.main(["--corpus", "64", "--dim", "8",
                           "--device-profile", "tpu-v9000", "-q"]) == 2
    assert "unknown device profile" in capsys.readouterr().err


def test_readme_plan_exits_0_with_the_ports_commands(capsys):
    rc = port_plan.main(["--corpus", "100000", "--dim", "128", "--k", "10",
                         "--recall-target", "0.95", "--data", "sift:100000"])
    assert rc == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["feasible"] is True and doc["fleet"]["profile"] == "cpu-test"
    pred = doc["predicted"]
    assert pred["recall_at_k"] >= 0.95 and pred["peak_hbm_source"] == "model"
    assert pred["roofline_bound"] in ("mxu", "hbm", "ici")
    assert pred["peak_hbm_bytes"] >= pred["resident_bytes"] > 0
    cmds = doc["commands"]
    assert cmds["build_index"].startswith(
        "python -m mpi_knn_tpu_torch build-index --data sift:100000 ")
    assert cmds["serve"].startswith("python -m mpi_knn_tpu_torch serve ")
    assert "--index-load plan.ivf.npz" in cmds["serve"]


def test_package_main_routes_plan_and_imports_stay_torch_free():
    """``python -m mpi_knn_tpu_torch plan`` answers; importing the planner
    and the host lint loads neither torch nor jax."""
    probe = ("import sys, mpi_knn_tpu_torch.plan, "
             "mpi_knn_tpu_torch.analysis.host, mpi_knn_tpu_torch.analysis.cost,"
             " mpi_knn_tpu_torch.analysis.memory, mpi_knn_tpu_torch.analysis.cli;"
             " from mpi_knn_tpu_torch.analysis.host import run_host_lint;"
             " print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
    run = subprocess.run(
        [sys.executable, "-m", "mpi_knn_tpu_torch", "plan", "--corpus",
         "4096", "--dim", "32", "--device-profile", "cpu-test", "-q"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout)["feasible"] is True


# ---------------------------------------------------------------------------
# the recall calibration


def test_calibration_has_the_references_schema_and_its_recall():
    """The reference's loader reads the port's file; each point is within
    0.005 of the JAX package's committed bench row, but nprobe 1, the
    k-means init's own spread: on this recipe the JAX package's own k-means
    reads 0.9613-0.9938 at nprobe 1 over seeds 0-5 on the CPU, and 0.993 at
    seed 0 against its committed 0.9793, so nprobe 1 is held to 0.015."""
    from mpi_knn_tpu import plan as ref_plan

    ours = ref_plan.load_calibration(port_plan.DEFAULT_CALIBRATION)
    assert ours["points"] == port_plan.load_calibration()["points"]
    bench = {r["variant"]: r for r in json.loads(BENCH.read_text())["results"]
             if r.get("op") in ("ivf_query", "ivf_at_rest")}
    doc = json.loads(port_plan.DEFAULT_CALIBRATION.read_text())
    rows = {r["variant"]: r for r in doc["results"]
            if r["op"] in ("ivf_query", "ivf_at_rest")}
    assert set(rows) == set(bench)
    for variant, row in rows.items():
        assert row["op"] == bench[variant]["op"]
        tol = 0.015 if variant == "p64-nprobe1" else 0.005
        assert abs(row["recall_at_k"] - bench[variant]["recall_at_k"]) <= tol
        if row["op"] == "ivf_query":
            assert row["probe_fraction"] == bench[variant]["probe_fraction"]
    scale = ours["dtype_scale"]
    assert scale["int4"] < scale["int8"] <= scale["bfloat16"] <= 1.0
    assert port_plan.predict_recall(1.0, "int4", ours) < 0.95


def test_calibration_sweep_is_within_0005_of_the_jax_recipe_run_here():
    """Each ``ivf_query`` point of the port's file is within 0.005 of the
    JAX package's own recipe (``scripts/bench_ops.py:640-700``: the same
    corpus, oracle and index, seed 0) run here on the CPU. The committed
    bench row at nprobe 1 (0.9793) is not what that recipe reads today
    (0.993), which is why the schema test above holds nprobe 1 to 0.015
    of the committed row and this test holds it to 0.005 of the live one."""
    from mpi_knn_tpu import KNNConfig as JaxConfig
    from mpi_knn_tpu.ivf import build_ivf_index, search_ivf
    from mpi_knn_tpu.utils.report import recall_at_k

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import plan_calibration as tool
    finally:
        sys.path.pop(0)
    X, sample, oracle = tool.corpus_and_oracle()
    index = build_ivf_index(X, JaxConfig(k=tool.K, partitions=tool.PARTITIONS,
                                         nprobe=tool.PARTITIONS,
                                         query_tile=1024, query_bucket=128))
    doc = json.loads(port_plan.DEFAULT_CALIBRATION.read_text())
    ours = {r["variant"]: r["recall_at_k"] for r in doc["results"]
            if r["op"] == "ivf_query"}
    assert len(ours) == len(tool.NPROBES)
    for n in tool.NPROBES:
        got = np.asarray(search_ivf(index, X[sample], nprobe=n)[1])
        theirs = float(recall_at_k(got, oracle))
        assert abs(ours[f"p{tool.PARTITIONS}-nprobe{n}"] - theirs) <= 0.005, \
            (n, theirs)


@pytest.mark.parametrize("m,target,profile", [
    (100000, 0.95, "h100-sxm-80gb"), (100000, 0.95, "cpu-test"),
    (1000000, 0.9, "h100-sxm-80gb"), (5000000, 0.95, "h100-sxm-80gb")])
def test_plan_never_probes_below_the_calibrated_fraction(m, target, profile):
    """Below the smallest calibrated probe fraction ``predict_recall``
    extrapolates (and read high on the port's own tuner: sift:100000 at
    256 partitions, nprobe 1); the planner plans no clustered candidate
    there, and its chosen recall is an interpolation."""
    calib = port_plan.load_calibration()
    lowest = calib["points"][0][0]
    wl = port_plan.Workload(m=m, d=128, k=10, recall_target=target)
    doc = port_plan.plan(wl, port_plan.Fleet(profile=profile),
                         backends=("ivf",), calib=calib)
    cfg = doc["config"]
    assert cfg["nprobe"] / cfg["partitions"] >= lowest
    assert doc["predicted"]["recall_at_k"] >= target
    assert port_plan._min_nprobe(
        port_plan.Candidate("ivf", "float32", partitions=2048), wl, calib
    ) >= lowest * 2048


def test_dense_caps_bind_and_the_int4_row_regenerates():
    """The denser corpus's at-rest rows (``ivf_at_rest_dense``: sift:100000
    at 256 partitions) lower every quantized cap, and the planner takes
    the lower; its int4 row regenerates bit for bit."""
    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf
    from mpi_knn_tpu_torch.utils.report import recall_at_k

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import plan_calibration as tool
    finally:
        sys.path.pop(0)
    doc = json.loads(port_plan.DEFAULT_CALIBRATION.read_text())
    base = {r["variant"].rsplit("-", 1)[-1]: r["recall_at_k"]
            for r in doc["results"] if r["op"] == "ivf_at_rest"}
    dense = {r["variant"].rsplit("-", 1)[-1]: r
             for r in doc["results"] if r["op"] == "ivf_at_rest_dense"}
    assert set(dense) == set(base) == set(tool.STORES)
    scale = port_plan.load_calibration()["dtype_scale"]
    for dt in ("bfloat16", "int8", "int4"):
        d = dense[dt]["recall_at_k"] / dense["float32"]["recall_at_k"]
        assert d < base[dt] / base["float32"] and scale[dt] == d
    X, sample, oracle = tool.corpus_and_oracle(tool.DENSE_M)
    idx = build_ivf_index(X, KNNConfig(
        k=tool.K, partitions=tool.DENSE_PARTITIONS, nprobe=tool.DENSE_NPROBE,
        query_tile=1024, query_bucket=128, dtype="int4"), device="cpu")
    got = search_ivf(idx, X[sample], query_ids=sample.astype(np.int32),
                     device="cpu")[1]
    assert round(float(recall_at_k(got.numpy(), oracle)), 4) == \
        dense["int4"]["recall_at_k"]


def test_calibration_point_regenerates_bit_for_bit():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import plan_calibration as tool
    finally:
        sys.path.pop(0)
    X, sample, oracle = tool.corpus_and_oracle()
    row = tool.query_row(tool.query_index(X), X, sample, oracle, 4)
    doc = json.loads(port_plan.DEFAULT_CALIBRATION.read_text())
    assert row == next(r for r in doc["results"]
                       if r["variant"] == "p64-nprobe4")


# ---------------------------------------------------------------------------
# the model against what the port builds, on the CPU


@pytest.mark.parametrize("m,partitions", [(8192, 64), (16384, 128)])
def test_imbalance_allowance_covers_the_ports_kmeans(m, partitions):
    from mpi_knn_tpu_torch.data.synthetic import make_sift_like
    from mpi_knn_tpu_torch.ivf.kmeans import kmeans

    X = make_sift_like(m, seed=0)
    X = (X - X.astype(np.float64).mean(0)).astype(np.float32)
    counts = kmeans(X, partitions, seed=0, device="cpu").counts.numpy()
    ratio = counts.max() / (m / partitions)
    assert ratio <= port_plan.KMEANS_IMBALANCE
    assert port_plan.bucket_cap_for(m, partitions, 0.0) >= counts.max()


@pytest.mark.parametrize("m,dtype,bucket,headroom", [
    (4096, "float32", 64, 0.0), (8192, "int8", 128, 0.0),
    (16384, "float32", 256, 0.0), (8192, "bfloat16", 64, 0.0),
    (4096, "int4", 64, 0.0), (8192, "float32", 64, 0.5),
])
def test_emitted_build_index_within_the_predictions(tmp_path, m, dtype,
                                                    bucket, headroom):
    """Plan a sift-shaped corpus, run the emitted build-index command (on
    the CPU), and hold the prediction at or above what was built: the
    bucket_cap, the resident bytes, and after a warm of the bucket the
    engine's ``index_peak_hbm_bytes``."""
    from mpi_knn_tpu_torch.ivf import cli as ivf_cli
    from mpi_knn_tpu_torch.ivf import load_ivf_index
    from mpi_knn_tpu_torch.serve import ServeSession
    from mpi_knn_tpu_torch.serve.engine import _resident_bytes, index_peak_hbm_bytes

    out = tmp_path / "plan.ivf.npz"
    # int4's calibrated cap (the denser corpus's, 0.8074) is under 0.9
    wl = port_plan.Workload(m=m, d=128, k=10,
                            recall_target=0.8 if dtype == "int4" else 0.9,
                            bucket=bucket)
    doc = port_plan.plan(wl, port_plan.Fleet(), backends=("ivf",),
                         dtypes=(dtype,), bucket_headroom=headroom)
    cmds = port_plan._commands(port_plan.Candidate(**doc["config"]), wl,
                               port_plan.Fleet(), data=f"sift:{m}",
                               index_out=str(out))
    argv = shlex.split(cmds["build_index"])
    assert argv[:4] == ["python", "-m", "mpi_knn_tpu_torch", "build-index"]
    assert ivf_cli.main(argv[4:] + ["--device", "cpu", "-q"]) == 0
    index = load_ivf_index(str(out), mmap=False, device="cpu")
    assert index.cfg.bucket_headroom == headroom
    assert "--compactor-interval-s" not in cmds["serve"]
    pred = doc["predicted"]
    assert pred["bucket_cap"] >= index.bucket_cap
    assert pred["resident_bytes"] >= _resident_bytes(index)
    ServeSession(index, device="cpu").warm([bucket])
    assert pred["peak_hbm_bytes"] >= index_peak_hbm_bytes(index) > 0
    assert index.nprobe == doc["config"]["nprobe"]


def test_serve_boots_the_emitted_commands_end_to_end(tmp_path, capsys):
    """The emitted build-index, then serve (``--index-load``), on the CPU:
    the front end answers, and its /healthz names the CPU's profile and a
    peak at or under the plan's."""
    import os
    import time
    import urllib.request

    out = tmp_path / "plan.ivf.npz"
    assert port_plan.main(["--corpus", "4096", "--dim", "32", "--k", "5",
                           "--bucket", "64", "--recall-target", "0.9",
                           "--data", "synthetic:4096x32c8", "--index-out",
                           str(out), "-q"]) == 0
    doc = json.loads(capsys.readouterr().out)
    build = shlex.split(doc["commands"]["build_index"])
    serve = shlex.split(doc["commands"]["serve"])
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    py = [sys.executable] + build[1:]
    done = subprocess.run(py + ["--device", "cpu", "-q"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    ready = tmp_path / "s.url"
    proc = subprocess.Popen(
        [sys.executable] + serve[1:] + ["--platform", "cpu", "--port", "0",
                                        "--ready-file", str(ready), "-q"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        for _ in range(600):
            if ready.exists() and ready.read_text().strip():
                break
            assert proc.poll() is None, proc.stderr.read()
            time.sleep(0.1)
        url = ready.read_text().strip()
        for _ in range(600):
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                hz = json.loads(r.read())
            if hz["ready"]:
                break
            time.sleep(0.1)
        assert hz["ready"] and hz["backend"] == "ivf"
        assert hz["device_profile"]["name"] == "cpu-test"
        assert 0 < hz["peak_hbm_bytes"] <= doc["predicted"]["peak_hbm_bytes"]
        q = json.dumps({"queries": np.zeros((3, 32)).tolist()}).encode()
        req = urllib.request.Request(url + "/query", data=q, headers={
            "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert len(json.loads(r.read())["ids"]) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def test_dense_prediction_covers_the_serial_index():
    from mpi_knn_tpu_torch.config import KNNConfig
    from mpi_knn_tpu_torch.serve import ServeSession, build_index
    from mpi_knn_tpu_torch.serve.engine import index_peak_hbm_bytes

    X = np.random.default_rng(0).standard_normal((3000, 24)).astype(np.float32)
    wl = port_plan.Workload(m=3000, d=24, k=5, bucket=64)
    pred = port_plan.predict_peak_hbm(port_plan.Candidate("serial"), wl)
    index = build_index(X, KNNConfig(k=5, backend="serial", query_bucket=64),
                        device="cpu")
    ServeSession(index, device="cpu").warm([64])
    assert pred["peak_hbm_bytes"] >= index_peak_hbm_bytes(index) > 0
    assert pred["resident_bytes"] >= index.nbytes_resident


def test_ivf_tile_model_counts_the_finish_chunk():
    """The README deployment's tile (q_tile 512, nprobe 2, bucket_cap 1216,
    d 128): the finish holds the f32 rows, the f64 chunk and its square
    (``finish_rows``: 431 rows, under RERANK_CHUNK_BYTES)."""
    st = port_memory.ivf_tile_stages(512, 2, 1216, 128, 256, 10, "float32")
    s = port_shapes.finish_rows(2 * 1216, 128)
    assert s == 431 and 8 * s * 2432 * 128 <= port_shapes.RERANK_CHUNK_BYTES
    assert max(st, key=st.get) == "finish products"
    floor = 4 * 512 * 2432 * 128 + 2 * 8 * s * 2432 * 128
    assert floor < st["finish products"] < floor + 40 * 2 ** 20
    assert port_shapes.ivf_q_tile(KNNConfig(), 2, 1216, 128, 10000) == 512
    # a bfloat16 store keeps its gathered rows through the finish
    bf = port_memory.ivf_tile_stages(512, 2, 1216, 128, 256, 10, "bfloat16")
    assert bf["finish products"] - st["finish products"] == \
        port_memory.alloc(2 * 512 * 2432 * 128)


def test_predicted_qps_orders_nprobe_and_stays_above_the_cpu_baseline():
    """Within one family the roofline falls as nprobe grows; on the JAX
    package's CPU rows the port's roofline is an upper bound as theirs
    is."""
    doc = json.loads(BENCH.read_text())
    family = {r["variant"]: r for r in doc["results"]
              if r.get("op") == "ivf_query"}
    prof = port_cost.get_profile("cpu-test")
    wl = port_plan.Workload(m=8192, d=128, k=10, bucket=128)
    got = [port_plan.predict_qps(port_plan.Candidate(
        "ivf", partitions=64, nprobe=n), wl, prof)["qps"] for n in (1, 4, 16)]
    assert got == sorted(got, reverse=True)
    for n, q in zip((1, 4, 16), got):
        assert family[f"p64-nprobe{n}"]["queries_per_s"] <= q


# ---------------------------------------------------------------------------
# the doctor's plan line


def test_doctor_plan_line_has_the_references_keys():
    import jax
    import jax.numpy as jnp
    import torch

    from mpi_knn_tpu.resilience import doctor as ref_doctor
    from mpi_knn_tpu_torch.resilience import doctor as port_doctor

    compiled = jax.jit(lambda x: x @ x.T).lower(
        jnp.ones((64, 16), jnp.float32)).compile()
    ref = ref_doctor._plan_probe(compiled)
    ours = port_doctor._plan_probe(torch.device("cpu"), 512 * 32 * 4)
    assert set(ours) == set(ref)
    assert ours["ok"] is True and ours["profile"] == ref["profile"] \
        == "cpu-test"
    assert ours["predicted_peak_hbm_bytes"] >= ours["probe_measured_peak_bytes"]
    assert dataclasses.asdict(port_plan.Candidate(**ours["config"])) == \
        ours["config"]
