"""The port's lint (``mpi_knn_tpu_torch/analysis``: R1–R8 over recorded
eager runs) on the CPU, beside the JAX package's.

- the matrix: the port's cell labels are the JAX package's
  ``default_targets()`` labels;
- the closed form: for a cell of each cost scheme the port's facts give
  the FLOPs the JAX package's fact builders give for the same extents
  (bidir by its merge count, see ``test_bidir_merges_each_block_once``);
- a sample of cells run clean, one a scheme;
- one injected counterexample a rule, each caught through the production
  rule path (``engine.run_rules``);
- the CLI: a filtered sweep, ``--ledger-check`` against the committed
  ledgers and against one whose peak was shrunk by a tenth (the run then
  "grew", and the drift names the culprit), ``--cache-dir`` refused by
  name.
"""

from __future__ import annotations

import json
import pathlib
import types

import numpy as np
import pytest
import torch

from mpi_knn_tpu.analysis import lowering as jlow
from mpi_knn_tpu.analysis.cost import analytical_mxu_flops as janalytical
from mpi_knn_tpu.config import KNNConfig as JaxConfig
from mpi_knn_tpu_torch.analysis import cost, engine, lowering, rules
from mpi_knn_tpu_torch.analysis.cli import main as lint_main
from mpi_knn_tpu_torch.utils import op_trace

REPO = pathlib.Path(__file__).resolve().parent.parent
LEDGERS = REPO / "artifacts" / "lint" / "torch"


def _target(label):
    (t,) = [t for t in lowering.default_targets() if t.label == label]
    return t


def _run(label, rule, call=None, meta_update=None):
    """Run a cell's production entry, or ``call(trace_fn)`` in its place,
    and the named rule over it."""
    target = _target(label)
    trace, cfg, meta = lowering.lower_target(target, "cpu")
    if call is not None:
        _, trace = op_trace.record(call)
    meta = dict(meta, profile="cpu-test", **(meta_update or {}))
    ctx = engine.LintContext(target, cfg, meta, "cpu")
    findings, _ = engine.run_rules(trace, ctx, rules.rules_by_name([rule]))
    return findings


# ---------------------------------------------------------------- matrix


def test_labels_equal_the_jax_matrix():
    assert [t.label for t in lowering.default_targets()] == [
        t.label for t in jlow.default_targets()]
    assert len(lowering.default_targets()) == 79


def _jax_target(label):
    (t,) = [t for t in jlow.default_targets() if t.label == label]
    return t


@pytest.mark.parametrize("label", [
    "serial/l2/float32",                 # dense
    "ring-overlap/l2/float32",           # ring uni
    "serial/l2/float32/mixed",           # mixed
    "ring/l2/float32/mixed",             # mixed ring
    "pallas/l2/float32/mixed",           # one global rerank block
])
def test_dense_flops_equal_the_jax_fact_builder(label):
    _, _, meta = lowering.lower_target(_target(label), "cpu")
    f = meta["cost"]
    want = jlow._dense_cost(_jax_target(label), f["q"], f["c"],
                            meta["c_tile"], queries=f["queries"],
                            sites=f["sites"], trips=f["trips"],
                            rblocks=f.get("rblocks"))
    assert cost.analytical_mxu_flops(f) == janalytical(want)


def test_bidir_merges_each_block_once():
    """The port's bidir schedule merges P blocks a rank; the JAX fact
    builder counts its scan body's two sites on each of ⌊P/2⌋+1 trips.
    The products per block agree, so the FLOPs stand in that ratio."""
    label = "ring-overlap/l2/float32/bidir"
    _, _, meta = lowering.lower_target(_target(label), "cpu")
    f, P = meta["cost"], meta["ring_n"]
    want = jlow._dense_cost(_jax_target(label), f["q"], f["c"],
                            meta["c_tile"], queries=f["queries"], sites=2,
                            trips=P // 2 + 1)
    assert (cost.analytical_mxu_flops(f) * 2 * (P // 2 + 1)
            == janalytical(want) * P)


@pytest.mark.parametrize("label", [
    "ivf/l2/float32", "ivf/l2/float32/mixed", "ivf-sharded/l2/float32",
    "ivf-sharded/l2/float32/mixed"])
def test_ivf_flops_equal_the_jax_fact_builder(label):
    target = _target(label)
    _, cfg, meta = lowering.lower_target(target, "cpu")
    f = meta["cost"]
    index = types.SimpleNamespace(partitions=f["partitions"], dim=f["d"],
                                  bucket_cap=f["bucket_cap"])
    jcfg = JaxConfig(k=cfg.k, partitions=f["partitions"], nprobe=f["nprobe"],
                     precision_policy=cfg.precision_policy)
    want = jlow._ivf_cost(index, jcfg, f["q"], queries=f["queries"])
    assert cost.analytical_mxu_flops(f) == janalytical(want)


def test_zero_scheme_equals_the_jax_mutation_facts():
    _, _, meta = lowering.lower_target(_target("serial/l2/float32/mutate-delete"),
                                       "cpu")
    assert meta["cost"]["scheme"] == "zero"
    assert cost.analytical_mxu_flops(meta["cost"]) == janalytical(
        {"scheme": "zero", "queries": 32}) == 0


@pytest.mark.parametrize("label", [
    "serial/l2/float64", "ring/l2/float32", "ring-overlap/l2/float32/mixed/bidir",
    "ring-overlap/l2/float32/mixed/fused/xfer-int8", "pallas/cosine/float32/mixed",
    "ivf/l2/float32/mixed/int8/serve", "ivf-sharded/l2/float32/mixed/int8",
    "serial/l2/float32/serve/frontend", "ivf/l2/float32/mutate-upsert",
    "ivf/l2/float32/mutate-compact"])
def test_a_cell_of_each_kind_is_clean(label):
    res = engine.lint_target(_target(label), device="cpu")
    assert res.skipped is None and res.findings == []
    assert res.cost["mxu_flops"] == res.cost["analytical_flops"]
    assert res.memory["peak_bytes"] <= res.memory["budget_bytes"]


@pytest.mark.parametrize("label,overrides", [
    ("pallas/l2/float32", {"pallas_variant": "sweep"}),
    ("pallas/l2/float32/mixed", {"pallas_variant": "sweep"}),
    ("serial/l2/float32", {"topk_method": "approx"}),
    ("serial/l2/float64", {"topk_method": "block"})])
def test_a_cell_at_the_main_paths_other_settings_is_clean(label, overrides):
    res = engine.lint_target(_target(label), device="cpu", overrides=overrides)
    assert res.findings == [] and res.overrides == overrides
    assert res.cost["mxu_flops"] == res.cost["analytical_flops"]


@pytest.mark.parametrize("label,overrides", [
    ("pallas/l2/float32", {"k": 8}),
    ("serial/l2/float32/serve", {"topk_method": "approx"}),
    ("ivf/l2/float32", {"topk_method": "approx"})])
def test_overrides_are_refused_outside_the_variant_fields(label, overrides):
    with pytest.raises(ValueError, match="overrides"):
        lowering.lower_target(_target(label), "cpu", overrides)


# ------------------------------------------------ injected counterexamples


def _serial_inputs():
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy((rng.standard_normal((128, 32)) * 3).astype(np.float32))
    queries = torch.from_numpy((rng.standard_normal((64, 32)) * 3).astype(np.float32))
    return corpus, queries


def test_r2_catches_a_full_distance_block():
    from mpi_knn_tpu_torch.backends.serial import all_knn_serial
    from mpi_knn_tpu_torch.config import KNNConfig

    corpus, queries = _serial_inputs()
    cfg = KNNConfig(k=4, query_tile=8, corpus_tile=16)

    def run():
        all_knn_serial(corpus, queries, np.full(64, -1, np.int32), cfg, "cpu")
        return corpus @ corpus.T  # the m×m block

    (f,) = _run("serial/l2/float32", "R2-memory", run)
    assert "materializes 65536 bytes" in f.message


def test_r3_catches_an_f64_narrowing():
    x = torch.randn(64, 32, dtype=torch.float64)
    f = _run("serial/l2/float64", "R3-dtype", lambda: (x @ x.T).to(torch.float32))
    assert any("narrows an f64 value" in g.message for g in f)


def test_r1_catches_a_blocking_copy_in_an_overlap_ring(monkeypatch):
    from mpi_knn_tpu_torch.backends import ring

    real = ring.all_knn_ring
    monkeypatch.setattr(ring, "all_knn_ring",
                        lambda *a, **kw: real(*a, **{**kw, "overlap": False}))
    f = _run("ring-overlap/l2/float32", "R1-overlap")
    assert f and all("copy starts after the round's first merge" in g.message
                     for g in f)


def test_r4_catches_a_dropped_rotation(monkeypatch):
    from mpi_knn_tpu_torch.backends.ring import RingRun

    real = RingRun.schedule
    monkeypatch.setattr(RingRun, "schedule",
                        lambda self: [(b, False) if i == 2 else (b, r)
                                      for i, (b, r) in enumerate(real(self))])
    f = _run("ring/l2/float32", "R4-collective")
    assert any("6 rotating rounds, expected 7" in g.message for g in f)


def test_r4_catches_a_bidir_rotation_the_wrong_way(monkeypatch):
    from mpi_knn_tpu_torch.backends.ring import RingRun

    real = RingRun.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        self.shifts = (1, 1)  # both travelers forward

    monkeypatch.setattr(RingRun, "__init__", init)
    f = _run("ring-overlap/l2/float32/bidir", "R4-collective")
    assert any("direction -1" in g.message for g in f)


def test_r5_catches_a_fresh_result_a_batch(monkeypatch):
    from mpi_knn_tpu_torch.serve import engine as serve_engine

    real = serve_engine._dispatch

    def dispatch(index, cfg, exec_, slot, q, poison=False):
        slot.out_d, slot.out_i = slot.out_d.clone(), slot.out_i.clone()
        return real(index, cfg, exec_, slot, q, poison)

    monkeypatch.setattr(serve_engine, "_dispatch", dispatch)
    f = _run("serial/l2/float32/serve", "R5-donation")
    assert any("slot's preallocated tensors" in g.message for g in f)


def test_r5_catches_a_corpus_sized_copy(monkeypatch):
    from mpi_knn_tpu_torch.serve import engine as serve_engine

    real = serve_engine._run_locked

    def run_locked(index, *a):
        index.tiles.repeat(2, 1, 1).clone()
        return real(index, *a)

    monkeypatch.setattr(serve_engine, "_run_locked", run_locked)
    f = _run("serial/l2/float32/serve", "R5-donation")
    assert any("re-pays the corpus" in g.message for g in f)


def test_r6_catches_an_unprobed_scan(monkeypatch):
    from mpi_knn_tpu_torch.ivf import search

    real = search.score_centroids

    def score(q_x, centroids, centroid_sqs, nprobe):
        store = lowering._ivf_index(lowering._ivf_cfg(_target("ivf/l2/float32")),
                                    "cpu").buckets
        q_x @ store.reshape(-1, store.shape[-1]).T  # every stored row
        return real(q_x, centroids, centroid_sqs, nprobe)

    monkeypatch.setattr(search, "score_centroids", score)
    f = _run("ivf/l2/float32", "R6-ivf-probe")
    assert any("an un-probed scan" in g.message for g in f)


def test_r7_catches_a_peak_over_its_budget():
    from mpi_knn_tpu_torch.backends.serial import all_knn_serial
    from mpi_knn_tpu_torch.config import KNNConfig

    corpus, queries = _serial_inputs()
    cfg = KNNConfig(k=4, query_tile=8, corpus_tile=16)

    def run():
        held = torch.zeros(1 << 16)  # 256 KiB held across the search
        out = all_knn_serial(corpus, queries, np.full(64, -1, np.int32), cfg,
                             "cpu")
        return out, held

    f = _run("serial/l2/float32", "R7-peak-memory", run)
    assert any("peak live bytes" in g.message and "> budget" in g.message
               for g in f)


def test_r8_catches_an_extra_product():
    from mpi_knn_tpu_torch.backends.serial import all_knn_serial
    from mpi_knn_tpu_torch.config import KNNConfig

    corpus, queries = _serial_inputs()
    cfg = KNNConfig(k=4, query_tile=8, corpus_tile=16)

    def run():
        out = all_knn_serial(corpus, queries, np.full(64, -1, np.int32), cfg,
                             "cpu")
        queries[:8] @ corpus[:16].T  # a product the closed form does not name
        return out

    (f,) = _run("serial/l2/float32", "R8-cost", run)
    assert "does work the closed form cannot name" in f.message


def test_r1_prices_a_kernel_moved_round():
    """A K4 record without wire bytes is the unpriced-fused-DMA finding."""
    trace = op_trace.Trace()
    trace.add_kernel("fused_round_dma", {"flops": 1})
    target = _target("ring-overlap/l2/float32/fused")
    ctx = engine.LintContext(target, None, {"ring_n": 8}, "cuda")
    (f,) = rules.R1Overlap().check(ctx, trace)
    assert "unpriced fused DMA" in f.message


# ---------------------------------------------------------------- the CLI


def test_cli_filtered_sweep_writes_its_report(tmp_path):
    assert lint_main(["--device", "cpu", "--backend", "serial", "--metric", "l2",
                      "--dtype", "float32", "-q", "--out", str(tmp_path)]) == 0
    doc = json.loads((tmp_path / "report.json").read_text())
    assert doc["ok"] and doc["platform"] == "cpu"
    assert doc["summary"]["targets_checked"] == len(doc["targets"]) >= 8


def test_cli_ledger_check_and_a_grown_peak(tmp_path, capsys):
    flags = ["--device", "cpu", "--backend", "ivf", "--quant", "int4", "-q",
             "--memory", "--cost", "--ledger-check", "--out", str(tmp_path)]
    assert lint_main(flags + ["--ledger", str(LEDGERS / "memory_ledger.json"),
                              "--cost-ledger",
                              str(LEDGERS / "cost_ledger.json")]) == 0
    doc = json.loads((LEDGERS / "memory_ledger.json").read_text())
    label = "ivf/l2/float32/int4"
    cell = doc["cells"][label]
    cell["peak_bytes"] = int(cell["peak_bytes"] / 1.1)  # the run grew 10 %
    shrunk = tmp_path / "memory_ledger.json"
    shrunk.write_text(json.dumps(doc))
    capsys.readouterr()
    assert lint_main(flags[:-4] + ["--memory", "--ledger-check", "--out",
                                   str(tmp_path), "--ledger", str(shrunk)]) == 1
    out = capsys.readouterr().out
    assert f"LEDGER-DRIFT {label}: peak grew" in out
    assert "largest allocation" in out and "aten." in out


def test_cli_refuses_cache_dir_by_name(capsys):
    assert lint_main(["--device", "cpu", "--cache-dir", "/nowhere"]) == 2
    err = capsys.readouterr().err
    assert "--cache-dir" in err and "compiles no program" in err


def test_committed_ledgers_cover_the_checked_cells():
    report = json.loads((LEDGERS / "report.json").read_text())
    checked = {t["label"] for t in report["targets"] if t["skipped"] is None}
    for name in ("memory_ledger.json", "cost_ledger.json"):
        doc = json.loads((LEDGERS / name).read_text())
        assert set(doc["cells"]) == checked and doc["platform"] == "cpu"
    assert report["ok"] and report["summary"]["targets_skipped"] == 4
    assert {t["label"] for t in report["targets"]} == {
        t.label for t in lowering.default_targets()}
