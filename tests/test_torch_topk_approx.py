"""The approximate top-k methods of the port against the JAX package.

``reduction_width`` is held to ``lax.approx_min_k``'s own output width;
the plain bin minimum (the Hopper kernel's spec) equals JAX bit for bit
where the reduction is exact (L = n, or k = 1) on distinct values, and
elsewhere returns real (value, column) pairs that are the bins' minima, at
a recall against JAX's exact CPU output of at least the recall target.
The "bf16" method equals JAX's bit for bit. Through the backends the
methods are held against the JAX backends, tie-aware."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.ops import topk as ref_topk
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.backends import serial
from mpi_knn_tpu_torch.ops import topk
from mpi_knn_tpu_torch.ops.approx_topk import (
    MAX_KERNEL_WIDTH,
    approx_min_k,
    approx_min_k_reference,
    check_kernel_width,
    reduction_width,
)
from tests.oracle import recall_against_oracle

NS = (129, 200, 256, 300, 1000, 2048, 2058, 4096, 8202, 10000, 20480, 61440)
KS = (1, 7, 10, 40, 100, 120)
TARGETS = (0.5, 0.8, 0.9, 0.95, 0.99)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_reduction_width_is_jax_output_width(n, k):
    for rt in TARGETS:
        shape = jax.eval_shape(
            lambda x: jax.lax.approx_min_k(x, k, recall_target=rt,
                                           aggregate_to_topk=False),
            jax.ShapeDtypeStruct((2, n), jnp.float32))[0].shape
        assert reduction_width(n, k, rt) == shape[-1], (n, k, rt)


def test_reduction_width_edges():
    assert reduction_width(2048, 10, 1.0) == 2048  # no reduction at 1.0
    assert reduction_width(64, 10) == 64
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="recall_target"):
            reduction_width(256, 10, bad)


def _distinct(rows, n, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, n)).astype(np.float32)


def _jax(x, k, rt, aggregate):
    v, p = jax.lax.approx_min_k(jnp.asarray(x), k, recall_target=rt,
                                aggregate_to_topk=aggregate)
    return np.asarray(v), np.asarray(p)


@pytest.mark.parametrize("n,k,rt,aggregate", [
    (100, 5, 0.95, True), (128, 10, 0.95, False), (256, 40, 0.95, True),
    (256, 40, 0.95, False), (384, 40, 0.95, False), (2048, 10, 1.0, True),
    (2048, 1, 0.95, True), (2176, 1, 0.9, True), (61440, 1, 0.95, True),
])
def test_plain_equals_jax_where_the_reduction_is_exact(n, k, rt, aggregate):
    x = _distinct(6, n)
    assert reduction_width(n, k, rt) == n or (k == 1 and aggregate)
    gv, gp = approx_min_k_reference(torch.from_numpy(x), k, rt, aggregate)
    wv, wp = _jax(x, k, rt, aggregate)
    assert np.array_equal(gv.numpy(), wv) and np.array_equal(gp.numpy(), wp)


def _bin_minima(row, L):
    """Each bin's (value, lowest column) minimum, sorted by (value, column),
    in plain numpy."""
    wins = []
    for b in range(L):
        cols = np.arange(b, row.shape[0], L)
        vals = row[cols]
        j = int(np.flatnonzero(vals == vals.min())[0])
        wins.append((float(vals[j]), int(cols[j])))
    return sorted(wins)


@pytest.mark.parametrize("n,k,aggregate", [
    (2048, 10, True), (2048, 40, False), (2176, 10, True), (2176, 40, False),
    (384, 10, True), (1000, 7, False),
])
@pytest.mark.parametrize("data", ["distinct", "ties"])
def test_plain_returns_the_bin_minima(n, k, aggregate, data):
    rt = 0.95
    if data == "ties":
        x = np.random.default_rng(1).integers(0, 6, (5, n)).astype(np.float32)
        x[0, n // 2:] = np.inf
    else:
        x = _distinct(5, n, seed=2)
    L = reduction_width(n, k, rt)
    assert L < n
    gv, gp = approx_min_k(torch.from_numpy(x), k, rt, aggregate)
    out = k if aggregate else L
    assert gv.shape == gp.shape == (5, out) and gp.dtype == torch.int64
    for r in range(5):
        assert np.array_equal(x[r, gp[r].numpy()], gv[r].numpy())
        want = _bin_minima(x[r], L)[:out]
        assert [(float(v), int(p)) for v, p in zip(gv[r], gp[r])] == want
    if data == "distinct":
        # JAX's CPU op is exact: the approximation's recall against it
        wv, wp = _jax(x, k, rt, aggregate)
        kk = min(k, out)
        hits = sum(len(set(gp[r, :kk].tolist()) & set(wp[r, :kk].tolist()))
                   for r in range(5))
        assert hits / (5 * kk) >= rt


def test_plain_handles_zeros_nan_and_batches():
    x = torch.tensor([[np.nan, 3.0, -0.0, 0.0, np.inf, 1.0] * 60], dtype=torch.float32)
    v, p = approx_min_k(x, 3, 0.95)
    assert p.tolist() == [[2, 3, 8]] and (v == 0).all()
    batched = torch.from_numpy(_distinct(12, 512)).reshape(3, 4, 512)
    bv, bp = approx_min_k(batched, 5)
    fv, fp = approx_min_k(batched.reshape(12, 512), 5)
    assert bv.shape == (3, 4, 5)
    assert torch.equal(bv.reshape(12, 5), fv) and torch.equal(bp.reshape(12, 5), fp)


def test_the_kernel_width_bound_is_named():
    check_kernel_width(MAX_KERNEL_WIDTH)
    L = reduction_width(20480, 120, 0.99)
    assert L > MAX_KERNEL_WIDTH
    with pytest.raises(ValueError, match=f"L={L} exceeds {MAX_KERNEL_WIDTH}"):
        check_kernel_width(L)
    # the plain version has no such bound
    v, _ = approx_min_k(torch.from_numpy(_distinct(1, 20480)), 120, 0.99)
    assert v.shape == (1, 120)


def test_approx_min_k_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        approx_min_k(torch.zeros(2, 256, dtype=torch.float64), 5)
    with pytest.raises(ValueError, match="k=300 outside"):
        approx_min_k(torch.zeros(2, 256), 300)


# ------------------------------------------------------------ smallest_k


def _ids(q, c):
    return np.tile(np.arange(c, dtype=np.int32) * 3 + 7, (q, 1))


@pytest.mark.parametrize("c,k", [(300, 10), (2048, 10), (100, 20), (50, 5)])
@pytest.mark.parametrize("data", ["ties", "wide_ties", "distinct"])
def test_bf16_method_is_bitwise_the_jax_method(c, k, data):
    rng = np.random.default_rng(3)
    if data == "ties":
        d = rng.integers(0, 9, (16, c)).astype(np.float32)
    elif data == "wide_ties":  # many values round to one bf16 value
        d = (1000.0 + rng.random((16, c)) * 4.0).astype(np.float32)
        d[:, ::7] = np.inf
    else:
        d = rng.random((16, c)).astype(np.float32) * 50
    ids = _ids(16, c)
    gv, gi = topk.smallest_k(torch.from_numpy(d), torch.from_numpy(ids), k,
                             method="bf16")
    wv, wi = ref_topk.smallest_k(jnp.asarray(d), jnp.asarray(ids), k,
                                 method="bf16")
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("method", ["approx", "approx-rerank"])
@pytest.mark.parametrize("c,k", [(300, 10), (2058, 10), (100, 5), (8, 10)])
def test_approx_methods_in_smallest_k(method, c, k):
    d = _distinct(8, c, seed=4) ** 2
    d[:, ::5] = np.inf
    ids = _ids(8, c)
    gv, gi = topk.smallest_k(torch.from_numpy(d), torch.from_numpy(ids), k,
                             method=method)
    wv, wi = ref_topk.smallest_k(jnp.asarray(d), jnp.asarray(ids), k,
                                 method=method)
    assert gv.shape == gi.shape == (8, k)
    gv, gi = gv.numpy(), gi.numpy()
    assert (gv[:, 1:] >= gv[:, :-1]).all()
    assert ((gi == -1) == np.isinf(gv)).all()
    # each returned id names its own column's distance
    col = np.where(gi >= 0, (gi - 7) // 3, 0)
    assert np.array_equal(np.where(gi >= 0, np.take_along_axis(d, col, 1), np.inf), gv)
    exact = method == "approx-rerank" and reduction_width(
        -(-c // 128) * 128, 4 * k) == -(-c // 128) * 128
    if exact or c <= k or (method == "approx" and c <= 128):
        assert np.array_equal(gv, np.asarray(wv)) and np.array_equal(gi, np.asarray(wi))
    else:
        assert recall_against_oracle(gi, np.asarray(wv), np.asarray(wi), k) >= 0.95


# ------------------------------------------------------------ backends

def _blobs(m=1024, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, d)) * 3.0
    y = rng.integers(0, 6, m)
    return (centers[y] + rng.standard_normal((m, d))).astype(np.float32)


PATHS = [
    dict(backend="serial", merge_schedule="twolevel"),
    dict(backend="serial", merge_schedule="stream"),
    dict(backend="pallas", pallas_variant="tiles"),
    dict(backend="ring-overlap", num_devices=4, ring_fusion="xla"),
]
# recall against the JAX backends (whose CPU op is exact): the bin minimum
# at recall_target 0.95 per reduction, "approx-rerank" reranking 4k winners
GATES = {"approx": 0.95, "approx-rerank": 0.99, "bf16": 1.0}


@pytest.mark.parametrize("path", PATHS, ids=lambda p: "-".join(map(str, p.values())))
@pytest.mark.parametrize("method", ["approx", "approx-rerank", "bf16"])
@pytest.mark.parametrize("mode", ["all_pairs", "queries"])
def test_methods_through_the_backends_match_jax(path, method, mode):
    X = _blobs()
    Q = None if mode == "all_pairs" else _blobs(200, seed=5)
    kw = dict(k=5, topk_method=method, query_tile=128, corpus_tile=512, **path)
    got = all_knn(X, queries=Q, device="cpu", **kw)
    want = jax_pkg.all_knn(X, queries=Q, **kw)
    gi, wd, wi = got.ids.numpy(), np.asarray(want.dists), np.asarray(want.ids)
    rec = recall_against_oracle(gi, wd, wi, 5)
    assert rec >= GATES[method], rec
    gd = got.dists.numpy()
    assert (gd[:, 1:] >= gd[:, :-1]).all() and (gi >= 0).all()


@pytest.mark.parametrize("method,expect", [
    ("approx", "exact"), ("approx-rerank", "exact"), ("bf16", "exact"),
    ("block", "block"), ("exact", "exact"),
])
def test_twolevel_cascade_runs_exactly(method, expect, monkeypatch):
    """Survivors of survivors merge exactly, as the JAX package rules."""
    seen = []
    real = serial.cascade_smallest_k

    def spy(*a, **kw):
        seen.append(kw["method"])
        return real(*a, **kw)

    monkeypatch.setattr(serial, "cascade_smallest_k", spy)
    X = _blobs(600)
    all_knn(X, k=5, backend="serial", topk_method=method, corpus_tile=256,
            query_tile=128, device="cpu")
    assert seen and set(seen) == {expect}
    assert serial.cascade_method(method) == expect


@pytest.mark.parametrize("method", ["approx", "approx-rerank", "bf16"])
def test_methods_are_accepted_and_fused_ring_refuses_them(method):
    KNNConfig(topk_method=method, recall_target=0.9)
    with pytest.raises(ValueError, match="topk_method='exact'"):
        KNNConfig(topk_method=method, ring_fusion="fused")


@pytest.mark.parametrize("rt", [0.5, 0.8, 0.99])
def test_recall_target_reaches_the_reduction(rt, monkeypatch):
    from mpi_knn_tpu_torch.ops import topk as port_topk

    seen = []
    real = port_topk.approx_min_k

    def spy(d, k, recall_target, aggregate_to_topk=True):
        seen.append(recall_target)
        return real(d, k, recall_target, aggregate_to_topk)

    monkeypatch.setattr(port_topk, "approx_min_k", spy)
    X = _blobs(600)
    for path in PATHS[:3]:
        all_knn(X, k=5, topk_method="approx", recall_target=rt,
                corpus_tile=256, query_tile=128, device="cpu", **path)
    assert seen and set(seen) == {rt}
    assert math.isclose(KNNConfig(recall_target=rt).recall_target, rt)
