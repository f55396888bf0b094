"""The mixed precision policy of the port against the JAX package on the
CPU: the compress-and-rerank pieces (``ops/rerank.py``, ``preselect_
smallest``), the serial and fused mixed paths, planted duplicates, and the
recall gate.

Tolerances. On small-integer data (multiples of 1/4 below 2, or integer
pixels for the rerank) every product and sum is exact in f32 and every
value exact in bf16, so ids and distances must be equal bit for bit. On
Gaussian data the sums run in other orders (and the port's rerank in f64),
so distances are held at rtol 1e-5 + 1e-4·(q²+c²) and ids at tie-aware
recall 1.0 (``tests/oracle.py``). The recall gate is the JAX package's:
≥ 0.999 recall@10 against an exact f64 oracle.
"""

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.ops import rerank as jr
from mpi_knn_tpu.ops.topk import preselect_smallest as jax_preselect
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
from mpi_knn_tpu_torch.ops import rerank as pr
from mpi_knn_tpu_torch.ops.topk import preselect_smallest
from tests.oracle import recall_against_oracle

RECALL_GATE = 0.999


def _small_int(seed, m, d):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 8, (m, d)) * 0.25).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_preselect_smallest_matches_top_k_with_exhausted_slots():
    rng = np.random.default_rng(0)
    d = (rng.integers(0, 6, (20, 40)) * 0.5).astype(np.float32)  # many ties
    d[rng.random((20, 40)) < 0.6] = np.inf
    d[3] = np.inf                                   # a row with no finite key
    d[4, :] = 1.0                                   # all tied
    for n in (5, 30, 40):                           # 30/40 exhaust most rows
        want = np.asarray(jax_preselect(d, n))
        got = preselect_smallest(_t(d), n).numpy()
        np.testing.assert_array_equal(got, want)


def test_compress_tile_equals_jax():
    q, c = _small_int(1, 33, 24), _small_int(2, 70, 24)
    want = np.asarray(jr.compress_tile(q, c, None, None))
    got = pr.compress_tile(_t(q), _t(c)).numpy()
    np.testing.assert_array_equal(got, want)
    # cosine: normalised rows are not exact, so within f32 rounding
    want = np.asarray(jr.compress_tile(q + 0.25, c + 0.25, None, None,
                                       metric="cosine"))
    got = pr.compress_tile(_t(q + 0.25), _t(c + 0.25), metric="cosine").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _cands(rng, X, q_rows, v):
    """Gathered candidate rows with invalid slots and self ids."""
    ids = np.stack([rng.choice(len(X), v, replace=False)
                    for _ in q_rows]).astype(np.int32)
    ids[:, 0] = q_rows                               # self
    ids[:, 1] = np.where(np.arange(len(q_rows)) % 2, -1, ids[:, 1])
    rows = X[np.maximum(ids, 0)]
    return rows, ids


@pytest.mark.parametrize("exclude_zero", [True, False])
def test_rerank_exact_topk_equals_jax(exclude_zero):
    rng = np.random.default_rng(3)
    X = _small_int(4, 120, 16)
    X[50] = X[7]                                     # a duplicate of query 7
    q_rows = np.arange(0, 40, dtype=np.int32)
    rows, ids = _cands(rng, X, q_rows, 12)
    ids[7, 2], rows[7, 2] = 50, X[50]
    kw = dict(exclude_self=True, exclude_zero=exclude_zero)
    wd, wi = jr.rerank_exact_topk(X[q_rows], q_rows, None, rows, ids, None, 5,
                                  **kw)
    gd, gi = pr.rerank_exact_topk(_t(X[q_rows]), _t(q_rows), _t(rows),
                                  _t(ids), 5, **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert (50 in gi[7].tolist()) != exclude_zero


def test_rerank_exact_topk_close_to_jax_on_gaussian():
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((200, 32)) * 3.0).astype(np.float32)
    q_rows = np.arange(50, dtype=np.int32)
    rows, ids = _cands(rng, X, q_rows, 20)
    wd, wi = jr.rerank_exact_topk(X[q_rows], q_rows, None, rows, ids, None, 6)
    gd, gi = pr.rerank_exact_topk(_t(X[q_rows]), _t(q_rows), _t(rows),
                                  _t(ids), 6)
    wd, wi = np.asarray(wd), np.asarray(wi)
    q_sq = (X[q_rows].astype(np.float64) ** 2).sum(1)[:, None]
    c_sq = (X[np.maximum(wi, 0)].astype(np.float64) ** 2).sum(-1)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd.numpy()), fin)
    tol = 1e-5 * np.abs(wd) + 1e-4 * (q_sq + c_sq)
    assert (np.abs(gd.numpy() - wd)[fin] <= tol[fin]).all()
    assert recall_against_oracle(gi.numpy(), wd, wi, 6) == 1.0


@pytest.mark.parametrize("k", [3, 40])  # 40: 4k >= c, the degenerate tile
def test_compress_rerank_tile_equals_jax(k):
    X = _small_int(6, 160, 24)
    X[90] = X[12]
    q_x, q_ids = X[:40], np.arange(40, dtype=np.int32)
    blk, blk_ids = X[32:160], np.arange(32, 160, dtype=np.int32)
    blk_ids[-5:] = -1
    jcfg = jax_pkg.KNNConfig(k=k, precision_policy="mixed")
    pcfg = KNNConfig(k=k, precision_policy="mixed")
    wd, wi = jr.compress_rerank_tile(q_x, q_ids, None, blk, blk_ids, None,
                                     jcfg)
    gd, gi = pr.compress_rerank_tile(_t(q_x), _t(q_ids), None, _t(blk),
                                     _t(blk_ids), None, pcfg)
    assert pr.mixed_applies(k, 128) == jr.mixed_applies(k, 128) == (k == 3)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_overfetch_width_matches_jax():
    for k, c in ((4, 128), (10, 32), (4, 16), (10, 2048)):
        assert pr.overfetch_width(k, c) == jr.overfetch_width(k, c)
        assert pr.mixed_applies(k, c) == jr.mixed_applies(k, c)


MIXED_PATHS = [("serial", "tiles", "twolevel"), ("serial", "tiles", "stream"),
               ("pallas", "tiles", "twolevel"), ("pallas", "sweep", "twolevel")]


@pytest.mark.parametrize("backend,variant,schedule", MIXED_PATHS)
@pytest.mark.parametrize("k", [3, 10])
def test_mixed_paths_bitwise_equal_to_jax(backend, variant, schedule, k):
    X = _small_int(7, 300, 24)
    X[5] = X[60]
    kw = dict(k=k, backend=backend, pallas_variant=variant,
              merge_schedule=schedule, precision_policy="mixed",
              query_tile=64, corpus_tile=128, center=False)
    assert jr.mixed_applies(k, 128)
    got = all_knn(X, device="cpu", **kw)
    want = jax_pkg.all_knn(X, **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


MIXED_BACKENDS = [dict(backend="serial"),
                  dict(backend="pallas", pallas_variant="tiles"),
                  dict(backend="pallas", pallas_variant="sweep"),
                  dict(backend="ring-overlap", ring_fusion="fused",
                       num_devices=4),
                  dict(backend="ring", num_devices=3)]


@pytest.mark.parametrize("path", MIXED_BACKENDS,
                         ids=lambda p: "-".join(str(v) for v in p.values()))
def test_planted_duplicates_are_excluded_after_rerank(path):
    """An exact duplicate pair and a near-twin whose compressed key
    collapses onto it: only the exact rerank excludes the duplicate and
    keeps the near-twin first, at its exact distance."""
    rng = np.random.default_rng(0)
    X = np.rint(rng.random((128, 64)) * 255.0).astype(np.float32)
    X[7] = X[3]
    X[42] = X[11]
    X[42, 0] += 8.0
    got = all_knn(X, k=6, precision_policy="mixed", query_tile=32,
                  corpus_tile=128, device="cpu", **path)
    ids, dists = got.ids.numpy(), got.dists.numpy()
    assert 7 not in ids[3] and 3 not in ids[7]
    assert ids[11][0] == 42 and ids[42][0] == 11
    assert 1.0 < dists[11][0] < 1000.0


def _integer_oracle(X, k):
    """Exact f64 neighbours of integer data (every sum exact in f64):
    duplicates (distance 0) and self excluded, ties to the lower id."""
    Xd = X.astype(np.float64)
    sq = (Xd ** 2).sum(1)
    d = sq[:, None] + sq[None, :] - 2.0 * (Xd @ Xd.T)
    d[d <= 0.0] = np.inf
    np.fill_diagonal(d, np.inf)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, ids, 1), ids.astype(np.int32)


@pytest.mark.parametrize("path", MIXED_BACKENDS,
                         ids=lambda p: "-".join(str(v) for v in p.values()))
def test_mixed_recall_gate_mnist_like(path):
    X, _ = make_mnist_like(2048)
    got = all_knn(X, k=10, precision_policy="mixed", query_tile=256,
                  corpus_tile=512, device="cpu", **path)
    want_d, want_i = _integer_oracle(X, 12)
    rec = recall_against_oracle(got.ids.numpy(), want_d, want_i, 10)
    assert rec >= RECALL_GATE, rec
