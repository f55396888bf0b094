"""The 2-D (dp × ring) mesh of the port (``parallel/mesh.make_mesh2d``,
``backends/ring.py``, ``backends/ring_resumable.py``, the run CLI's
``--dp``) against the serial port and the JAX package's 2-D ring
(``tests/test_mesh2d.py``'s shapes and schedules) on the CPU: the port's
ranks are logical ranks on the one CPU device, JAX's its 8-device host
mesh. Under the overlap schedule every shape equals serial; the blocking
schedule is a hard error on any 2-axis mesh, dp = 1 included, through the
resumable driver too.
"""

import numpy as np
import pytest
import torch

from mpi_knn_tpu import KNNConfig as JaxConfig
from mpi_knn_tpu import all_knn as jax_all_knn
from mpi_knn_tpu.backends import ring as jax_ring
from mpi_knn_tpu.parallel.mesh import make_mesh2d as jax_mesh2d
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.backends.ring import all_knn_ring
from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
from mpi_knn_tpu_torch.ops.distance import center_for_l2
from mpi_knn_tpu_torch.parallel.mesh import Mesh2D, make_mesh2d
from tests.oracle import recall_against_oracle

CPU = "cpu"


def _data(seed, m=96, d=12):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


@pytest.mark.parametrize("dp,ring", [(2, 4), (4, 2), (8, 1), (1, 8)])
@pytest.mark.parametrize("schedule", ["uni", "bidir"])
def test_mesh2d_matches_serial_and_jax(dp, ring, schedule):
    X = _data(0)
    kw = dict(k=5, query_tile=4, corpus_tile=8, ring_schedule=schedule)
    cfg = KNNConfig(backend="ring-overlap", **kw)
    want = all_knn(X, config=cfg.replace(backend="serial"), device=CPU)
    got = all_knn(X, config=cfg, mesh=make_mesh2d(dp, ring, device=CPU),
                  device=CPU)
    assert torch.equal(want.ids, got.ids)
    torch.testing.assert_close(got.dists, want.dists, rtol=1e-5, atol=0)
    jax = jax_all_knn(X, config=JaxConfig(backend="ring-overlap", **kw),
                      mesh=jax_mesh2d(dp, ring))
    jd, ji = np.asarray(jax.dists), np.asarray(jax.ids)
    assert recall_against_oracle(got.ids.numpy(), jd, ji, 5) >= 0.999
    np.testing.assert_allclose(got.dists.numpy(), jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["uni", "bidir"])
def test_mesh2d_blocking_is_a_hard_error(schedule):
    X = _data(1, m=32)
    cfg = KNNConfig(k=3, backend="ring", query_tile=4, corpus_tile=8,
                    ring_schedule=schedule)
    ids = np.arange(len(X), dtype=np.int32)
    for mesh in (make_mesh2d(2, 4, device=CPU), make_mesh2d(1, 8, device=CPU)):
        want = str(jax_ring.blocking_undefined_on_mesh_error(("dp", "ring")))
        with pytest.raises(ValueError, match="1-D ring") as err:
            all_knn(X, config=cfg, mesh=mesh, device=CPU)
        assert str(err.value) == want
        with pytest.raises(ValueError, match="1-D ring"):
            all_knn_ring_resumable(X, X, ids, cfg, mesh=mesh, overlap=False,
                                   device=CPU)
        # the resident ring index refuses it in the same words
        from mpi_knn_tpu_torch.serve import build_index

        with pytest.raises(ValueError, match="1-D ring"):
            build_index(X, cfg, mesh=mesh, device=CPU)


def test_mesh2d_query_mode_and_uneven_sizes():
    X, Q = _data(2, m=64), _data(3, m=40)
    cfg = KNNConfig(k=3, backend="ring-overlap", query_tile=4, corpus_tile=8)
    mesh = make_mesh2d(2, 4, device=CPU)
    want = all_knn(X, queries=Q, config=cfg.replace(backend="serial"),
                   device=CPU)
    got = all_knn(X, queries=Q, config=cfg, mesh=mesh, device=CPU)
    assert torch.equal(want.ids, got.ids)
    X = _data(4, m=61)  # neither dp·ring | nq nor ring | m
    cfg = KNNConfig(k=4, backend="ring-overlap", query_tile=4, corpus_tile=8)
    want = all_knn(X, config=cfg.replace(backend="serial"), device=CPU)
    got = all_knn(X, config=cfg, mesh=mesh, device=CPU)
    assert torch.equal(want.ids, got.ids)
    # auto resolves to the overlap ring on a mesh of more than one device
    got = all_knn(X, config=cfg.replace(backend="auto"), mesh=mesh, device=CPU)
    assert torch.equal(want.ids, got.ids)


@pytest.mark.parametrize("form,extra", [
    ("driver", {}), ("driver", {"ring_schedule": "bidir"}), ("dma", {}),
    ("driver", {"precision_policy": "mixed", "ring_transfer_dtype": "int8"}),
], ids=["to", "bidir-K3a", "K4", "mixed-int8"])
def test_each_dp_group_is_the_1d_ring_over_its_rows(form, extra):
    """Group g's rows are bit for bit the 1-D P = 2 ring of the same
    transport over those rows: the same tiles, the same blocks."""
    X = _data(5, m=128, d=16)
    cfg = KNNConfig(k=5, backend="ring-overlap", ring_fusion="fused",
                    query_tile=8, corpus_tile=16, **extra)
    c, q = center_for_l2(X, X, True)
    ids = np.arange(len(X), dtype=np.int32)
    d2, i2 = all_knn_ring(c, q, ids, cfg, mesh=make_mesh2d(2, 2, device=CPU),
                          device=CPU, form=form)
    half = len(X) // 2
    for g in range(2):
        rows = slice(g * half, (g + 1) * half)
        d1, i1 = all_knn_ring(c, q[rows], ids[rows], cfg,
                              mesh=[torch.device(CPU)] * 2, device=CPU,
                              form=form)
        assert torch.equal(i2[rows], i1) and torch.equal(d2[rows], d1)


def test_mesh2d_resumes_bit_for_bit(tmp_path):
    X = _data(6, m=80)
    cfg = KNNConfig(k=5, backend="ring-overlap", query_tile=4, corpus_tile=8,
                    ring_schedule="bidir")
    ids = np.arange(len(X), dtype=np.int32)
    mesh = make_mesh2d(2, 4, device=CPU)
    d0, i0 = all_knn_ring_resumable(X, X, ids, cfg, mesh=mesh, device=CPU)
    all_knn_ring_resumable(X, X, ids, cfg, mesh=mesh, device=CPU,
                           checkpoint_dir=str(tmp_path), stop_after_rounds=2)
    d, i = all_knn_ring_resumable(X, X, ids, cfg, mesh=mesh, device=CPU,
                                  checkpoint_dir=str(tmp_path))
    assert torch.equal(i, i0) and torch.equal(d, d0)
    want = all_knn(X, config=cfg.replace(backend="serial"), device=CPU)
    assert torch.equal(i0, want.ids)
    # a carry of another grid never resumes: the fingerprint names it
    d8, i8 = all_knn_ring_resumable(X, X, ids, cfg, device=CPU,
                                    mesh=make_mesh2d(1, 8, device=CPU),
                                    checkpoint_dir=str(tmp_path))
    assert torch.equal(i8, want.ids)


def test_corpus_memory_scales_with_the_ring():
    """The corpus shards over the ring axis only: each device's block has
    c_pad / ring rows whatever dp is."""
    from mpi_knn_tpu_torch.backends.ring import ring_layout

    X = np.zeros((64, 8), np.float32)
    cfg = KNNConfig(k=3, corpus_tile=16, query_tile=4)
    ids = np.arange(64, dtype=np.int32)
    for dp, ring in ((2, 4), (1, 4), (4, 2)):
        mesh = make_mesh2d(dp, ring, device=CPU)
        _, _, parts = ring_layout(cfg, X, X, ids, [list(r) for r in mesh])
        blocks = {t[0].shape[0] for _, _, trav in parts for t in trav[0]}
        assert blocks == {64 // ring}
        assert sum(q.shape[0] for q_sh, _, _ in parts for q in q_sh) >= 64


def test_make_mesh2d_validates():
    with pytest.raises(ValueError, match="requested 3×4=12 devices"):
        make_mesh2d(3, 4, devices=[torch.device(CPU)] * 8)
    mesh = make_mesh2d(2, 3, device=CPU)
    assert isinstance(mesh, Mesh2D) and mesh.shape == (2, 3)
    assert mesh.axis_names == ("dp", "ring") and len(mesh.flat()) == 6
    with pytest.raises(ValueError):
        make_mesh2d(0, 4, device=CPU)


def test_run_cli_dp(tmp_path, capsys):
    import json

    from mpi_knn_tpu_torch.cli import main

    report = tmp_path / "r.json"
    base = ["--data", "synthetic:256x16c4", "--k", "5", "--loo", "--device",
            CPU, "--devices", "4", "-q"]
    assert main(base + ["--dp", "2", "--backend", "ring-overlap",
                        "--report", str(report)]) == 0
    doc = json.loads(report.read_text())
    assert doc["backend"] == "ring-overlap" and doc["accuracy"] is not None
    nn = tmp_path / "nn.npz"
    assert main(base + ["--dp", "2", "--save-neighbors", str(nn)]) == 0
    assert main(base + ["--backend", "serial", "--save-neighbors",
                        str(tmp_path / "s.npz")]) == 0
    assert np.array_equal(np.load(nn)["ids"],
                          np.load(tmp_path / "s.npz")["ids"])
    for argv, words in ((["--dp", "3"], "must divide the device count 4"),
                        (["--dp", "2", "--backend", "ring"], "1-D ring"),
                        (["--dp", "2", "--backend", "pallas"],
                         "--dp requires a ring backend")):
        with pytest.raises(SystemExit, match=words):
            main(base + argv)
