"""The recorder of the port's lint (``mpi_knn_tpu_torch/utils/op_trace.py``)
on the CPU: live bytes, def-use by storage, the product FLOPs against
``FlopCounterMode``, the transport log of a ring, and the kernel side-band
records, with the kernel library stubbed so the wrappers' card branches
run here (no kernel executes: the stub returns success and writes
nothing)."""

from __future__ import annotations

import contextlib
import types

import numpy as np
import pytest
import torch

from mpi_knn_tpu_torch.ops import fused_knn, fused_ring, fused_rotation
from mpi_knn_tpu_torch.utils import op_trace


def test_live_bytes_views_and_peak():
    a, b = torch.randn(64, 32), torch.randn(128, 32)

    def run():
        d = a @ b.T  # 32 KiB
        e = d + 1.0  # 32 KiB more
        del d
        v = e[:, :8]  # a view: no bytes
        return v.sum()

    _, tr = op_trace.record(run)
    assert tr.peak_bytes == 2 * 64 * 128 * 4
    slice_op = [o for o in tr.ops if o.name.startswith("aten.slice")][0]
    assert slice_op.new_bytes == 0 and slice_op.writes == ()
    assert tr.live_bytes == 4  # the returned sum only


def test_backward_slice_follows_storages():
    x = torch.randn(8, 4)

    def run():
        y = x * 2.0
        z = torch.randn(8, 4)
        w = y + 1.0
        return w @ z.T

    _, tr = op_trace.record(run)
    mm = tr.products()[0]
    names = {tr.ops[i].name.split(".")[1] for i in tr.backward_slice(mm.index)}
    assert {"mul", "add", "randn"} <= names


def test_product_flops_equal_flop_counter():
    a, b, c = torch.randn(16, 32), torch.randn(24, 32), torch.randn(16, 5, 32)

    def run():
        torch.matmul(a, b.T)
        torch.einsum("qd,qvd->qv", a, c)
        torch.addmm(torch.zeros(16, 24), a, b.T)

    _, tr = op_trace.record(run)
    assert tr.counted_flops() == sum(o.flops for o in tr.products())
    assert tr.counted_flops() == 2 * (2 * 16 * 24 * 32) + 2 * 16 * 5 * 32


def test_record_does_not_nest():
    with pytest.raises(RuntimeError, match="nest"):
        op_trace.record(lambda: op_trace.record(lambda: None))


def test_no_trace_costs_nothing_and_records_nothing():
    counts = {"k": 0}
    op_trace.note_launch(counts, "k", lambda: pytest.fail("info read"))
    op_trace.note_transfer("send", bytes=1)
    assert counts == {"k": 1}


def test_ring_transport_log_orders_copies_and_merges():
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring
    from mpi_knn_tpu_torch.config import KNNConfig

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    cfg = KNNConfig(k=3, query_tile=8, corpus_tile=8)
    ids = np.full(16, -1, np.int32)
    for overlap in (True, False):
        _, tr = op_trace.record(lambda: all_knn_ring(
            X, X[:16], ids, cfg, mesh=["cpu"] * 4, overlap=overlap,
            device="cpu"))
        kinds = [e["kind"] for e in tr.transport]
        first = kinds[:kinds.index("round", 1)]
        if overlap:  # sends before the round's merges, the wait after
            assert first.index("send") < first.index("merge")
            assert first.index("wait") > len(first) - 1 - first[::-1].index("merge")
        else:
            assert first.index("send") > len(first) - 1 - first[::-1].index("merge")
        assert kinds.count("round") == 4 and kinds.count("merge") == 16
        sends = [e for e in tr.transport if e["kind"] == "send"]
        assert len(sends) == 3 * 4 * 2  # 3 rotations, 4 ranks, block + ids
        assert all(e["dst"] == (e["src"] + 1) % 4 for e in sends)


# ---------------------------------------------------------------- side-band


class _Lib:
    """A kernel library whose every entry point succeeds and does nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def stubbed(monkeypatch):
    """The wrappers' card branches on CPU tensors: the library stubbed,
    ``torch.cuda.device`` / ``current_stream`` made inert."""
    lib = _Lib()
    monkeypatch.setattr(fused_knn, "_lib", lambda: lib)
    monkeypatch.setattr(fused_ring, "_lib", lambda: lib)
    monkeypatch.setattr(fused_rotation, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    for mod in (fused_knn, fused_ring, fused_rotation):
        mod.reset_launch_counts()
    yield
    for mod in (fused_knn, fused_ring, fused_rotation):
        mod.reset_launch_counts()


Q, C, D, K, CT = 64, 256, 40, 4, 128


def _staged(rows, compress=False):
    if compress:
        return fused_knn.stage_bf16_rows_reference(
            rows, fused_knn.staged_width(rows.shape[1]))
    return fused_knn.stage_tf32_split_reference(
        rows, fused_knn.split_width(rows.shape[1]))


@pytest.mark.parametrize("case", ["tiles", "sweep", "tiles-default",
                                  "tiles-compress"])
def test_k1_k2_record_one_launch_with_the_closed_form_flops(stubbed, case):
    q, c = torch.randn(Q, D), torch.randn(C, D)

    def run():
        if case == "tiles-default":
            return fused_knn.launch_mma("fused_knn_tiles", q, c, (q[:, 0],),
                                        (c[:, 0],), C, K, CT, "default")
        if case == "tiles-compress":
            return fused_knn.launch_compress(
                "fused_knn_tiles", _staged(q, True), _staged(c, True), C, K, CT,
                dim=D)
        base = "fused_knn_tiles" if case == "tiles" else "fused_knn_sweep"
        return fused_knn.launch_exact(base, _staged(q), _staged(c), C, K, CT,
                                      dim=D)

    _, tr = op_trace.record(run)
    (rec,) = tr.kernels()
    want = {"tiles": ("fused_knn_tiles", "tf32x3"),
            "sweep": ("fused_knn_sweep", "tf32x3"),
            "tiles-default": ("fused_knn_tiles[default]", "bf16x1f32"),
            "tiles-compress": ("fused_knn_tiles[compress]", "bf16")}[case]
    assert (rec.name, rec.info["precision"]) == want
    assert rec.flops == 2 * Q * C * D  # the product, not TF32x3's 3 passes
    assert fused_knn.LAUNCHES[want[0]] == 1
    assert rec.info["bytes"] > 0 and rec.outputs


def test_k2c_records_its_launch(stubbed, monkeypatch):
    monkeypatch.setattr(fused_knn, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(fused_knn, "compress_sweep_plan",
                        lambda *a, **kw: {"slices": 1, "groups": 1})
    q, c = torch.randn(Q, D), torch.randn(C, D)

    def run():
        return fused_knn.launch_compress("fused_knn_sweep", _staged(q, True),
                                         _staged(c, True), C, K, CT, dim=D)

    _, tr = op_trace.record(run)
    (rec,) = tr.kernels()
    assert rec.name == "fused_knn_sweep[compress]"
    assert rec.flops == 2 * Q * C * D and rec.info["precision"] == "bf16"
    assert fused_knn.LAUNCHES["fused_knn_sweep[compress]"] == 1


def test_bin_minimum_records_its_launch(stubbed, monkeypatch):
    from mpi_knn_tpu_torch.ops import approx_topk

    lib = _Lib()
    monkeypatch.setattr(approx_topk, "_lib", lambda: lib)
    monkeypatch.setattr(approx_topk, "_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    approx_topk.reset_launch_counts()
    d = torch.randn(64, 512)
    ids = torch.arange(512, dtype=torch.int32)
    vals = torch.empty((64, K))
    out_ids = torch.empty((64, K), dtype=torch.int32)

    def run():
        approx_topk._launch(d, 512, 64, 512, 512, 128, K, vals, ids=ids,
                            out_ids=out_ids)

    _, tr = op_trace.record(run)
    (rec,) = tr.kernels()
    assert rec.name == "approx_min_k" and rec.flops == 0
    assert rec.info["bytes"] == op_trace.tensor_bytes(d, ids, vals, out_ids)
    assert approx_topk.LAUNCHES["approx_min_k"] == 1
    approx_topk.reset_launch_counts()


def test_k3b_records_its_launch(stubbed):
    q, b = torch.randn(16, D), torch.randn(C, D)
    ids = torch.arange(16, dtype=torch.int32)
    bids = torch.arange(C, dtype=torch.int32)

    def run():
        return fused_ring.block_merge_compress_staged(
            _staged(q, True), ids, _staged(b, True), bids, ov=16, c_tile=CT,
            dim=D)

    _, tr = op_trace.record(run)
    (rec,) = tr.kernels()
    assert rec.name == "fused_block_merge[compress]"
    assert rec.flops == 2 * 16 * C * D and rec.info["precision"] == "bf16"
    assert fused_ring.LAUNCHES["fused_block_merge[compress]"] == 1


def test_k4_records_a_launch_a_card_with_its_wire_bytes(stubbed):
    P, q_local, b = 4, 8, 32
    queries = [torch.randn(q_local, D) for _ in range(P)]
    qids = [torch.full((q_local,), -1, dtype=torch.int32) for _ in range(P)]
    blocks = [(torch.randn(b, D), torch.arange(b, dtype=torch.int32), None,
               torch.randn(b), None, None) for _ in range(P)]
    carries = [(torch.full((q_local, K), float("inf")),
                torch.full((q_local, K), -1, dtype=torch.int32))
               for _ in range(P)]
    outs = [(torch.empty_like(cd), torch.empty_like(ci)) for cd, ci in carries]
    ring = types.SimpleNamespace(
        cards=["cpu"], local={"cpu": list(range(P))},
        flags={"cpu": torch.zeros((1, 8), dtype=torch.int32)},
        raise_on_error=lambda name: None)
    ranks = [fused_rotation._Rank() for _ in range(P)]
    kw = dict(exclude_self=True, exclude_zero=True, zero_eps=0.0, precision=None)
    moved = [fused_rotation.tensor_bytes(bl[0], bl[1], bl[3]) for bl in blocks]

    def run():
        fused_rotation._launch_per_card(
            ring, "round_dma_launch", "fused_round_dma", ranks, queries, blocks,
            carries, kw, 1, 1.0, side=(outs, 1, moved))

    _, tr = op_trace.record(run)
    (rec,) = tr.kernels()
    assert rec.name == "fused_round_dma" and rec.info["ranks"] == P
    assert rec.flops == P * 2 * q_local * b * D
    assert rec.info["wire_bytes"] == sum(moved) > 0
    assert fused_rotation.LAUNCHES["fused_round_dma"] == 1
