"""The approximate top-k methods on float64 distances (the reference's f64
debugging mode), against the JAX package on the CPU.

The bin minimum keys an f64 value by its 64 bits in a signed order (-0.0
as +0.0, NaN above +inf) beside its column, and the plain version compares
(value key, column) pairs. JAX's CPU ``approx_min_k`` is exact, so the two
agree bit for bit where the port's reduction is exact too (L = n, or
k = 1); ``reduction_width`` is held to JAX's output width on f64 rows.
Through the backends, corpus tiles of at most 128 columns make every
tile's reduction exact, and the port equals the JAX package there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.ops import topk as ref_topk
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.convert import config_from_reference
from mpi_knn_tpu_torch.ops import topk
from mpi_knn_tpu_torch.ops.approx_topk import (
    approx_min_k,
    approx_min_k_reference,
    approx_smallest_k_reference,
    launch_plan,
    reduction_width,
)
from tests.oracle import recall_against_oracle


def _rows(rows, n, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, n))


@pytest.mark.parametrize("n", [129, 256, 300, 2048, 10000, 61440])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_reduction_width_is_jax_output_width_on_f64_rows(n, k):
    for rt in (0.9, 0.95, 0.99):
        shape = jax.eval_shape(
            lambda x: jax.lax.approx_min_k(x, k, recall_target=rt,
                                           aggregate_to_topk=False),
            jax.ShapeDtypeStruct((2, n), jnp.float64))[0].shape
        assert reduction_width(n, k, rt) == shape[-1], (n, k, rt)


@pytest.mark.parametrize("n,k,rt,aggregate", [
    (100, 5, 0.95, True), (128, 10, 0.95, False), (256, 40, 0.95, True),
    (384, 40, 0.95, False), (2048, 10, 1.0, True), (2048, 1, 0.95, True),
    (61440, 1, 0.95, True),
])
def test_plain_f64_equals_jax_where_the_reduction_is_exact(n, k, rt, aggregate):
    x = _rows(6, n)
    x[:, ::7] += 1e-13  # values no f32 holds
    assert reduction_width(n, k, rt) == n or (k == 1 and aggregate)
    gv, gp = approx_min_k_reference(torch.from_numpy(x), k, rt, aggregate)
    wv, wp = jax.lax.approx_min_k(jnp.asarray(x), k, recall_target=rt,
                                  aggregate_to_topk=aggregate)
    assert gv.dtype == torch.float64
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gp.numpy(), np.asarray(wp))


def _bin_minima64(row, L):
    n = len(row)
    best = {}
    for c in range(n):
        b = c % L
        key = (np.inf if np.isnan(row[c]) else row[c] + 0.0, np.isnan(row[c]), c)
        if b not in best or (key[1], key[0], key[2]) < (best[b][1], best[b][0], best[b][2]):
            best[b] = key
    out = sorted(best.values(), key=lambda t: (t[1], t[0], t[2]))
    return [t[2] for t in out]


@pytest.mark.parametrize("n,k,aggregate", [(2048, 10, True), (2176, 40, False),
                                           (20480, 120, True), (1155, 40, False)])
@pytest.mark.parametrize("data", ["distinct", "ties", "zeros_nan"])
def test_plain_f64_is_the_bin_minimum(n, k, aggregate, data):
    """Each bin's smallest value, ties to its lowest column, NaN above
    +inf, -0.0 as +0.0; the winners sorted by (value, column)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, n))
    if data == "ties":
        x = rng.integers(0, 4, (3, n)).astype(np.float64)
    elif data == "zeros_nan":
        x[0, ::3] = -0.0
        x[1, ::5] = np.nan
        x[2, 1::2] = 0.0
    rt = 0.99 if n > 8192 else 0.95
    L = reduction_width(n, k, rt)
    _, gp = approx_min_k_reference(torch.from_numpy(x), k, rt, aggregate)
    out = k if aggregate else L
    for r in range(3):
        assert gp[r].tolist() == _bin_minima64(x[r], L)[:out]


def test_plan_keys_take_16_bytes():
    for L in (256, 4096, 20480):
        p32 = launch_plan(64, max(L, 2048), L, 10)
        p64 = launch_plan(64, max(L, 2048), L, 10, torch.float64)
        assert p64["key_bytes"] == 16 and p32["key_bytes"] == 8
        assert p64["shared_bytes"] == 2 * p32["shared_bytes"] <= 227 * 1024
        assert {k: v for k, v in p64.items() if k not in ("shared_bytes", "key_bytes")} \
            == {k: v for k, v in p32.items() if k not in ("shared_bytes", "key_bytes")}


@pytest.mark.parametrize("method", ["approx", "approx-rerank"])
@pytest.mark.parametrize("c,k", [(100, 5), (300, 10), (2058, 10)])
def test_smallest_k_f64_matches_jax(method, c, k):
    d = _rows(8, c, seed=4) ** 2
    d[:, ::5] = np.inf
    ids = np.tile(np.arange(c, dtype=np.int32) * 3 + 7, (8, 1))
    gv, gi = topk.smallest_k(torch.from_numpy(d), torch.from_numpy(ids), k, method=method)
    wv, wi = ref_topk.smallest_k(jnp.asarray(d), jnp.asarray(ids), k, method=method)
    assert gv.dtype == torch.float64 and (gv[:, 1:] >= gv[:, :-1]).all()
    fv, fi = approx_smallest_k_reference(torch.from_numpy(d), torch.from_numpy(ids), k,
                                         method)
    assert torch.equal(gv, fv) and torch.equal(gi, fi)
    n_pad = -(-c // 128) * 128
    exact = (c <= 128 or (method == "approx-rerank"
                          and reduction_width(n_pad, 4 * k) == n_pad))
    if exact:
        assert np.array_equal(gv.numpy(), np.asarray(wv))
        assert np.array_equal(gi.numpy(), np.asarray(wi))
    else:
        assert recall_against_oracle(gi.numpy(), np.asarray(wv), np.asarray(wi), k) >= 0.95


# the stream step reduces carry ‖ tile: k + 123 = 128 columns, one lane group
PATHS = {"serial_twolevel": dict(backend="serial", merge_schedule="twolevel",
                                 corpus_tile=128),
         "serial_stream": dict(backend="serial", merge_schedule="stream",
                               corpus_tile=123)}


@pytest.mark.parametrize("method", ["approx", "approx-rerank"])
@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("mode", ["all_pairs", "queries"])
def test_f64_approx_through_the_backends_equals_jax(path, method, mode):
    """Reductions of at most 128 columns (tiles of 128 columns, or the
    stream step's k + 123): every one is exact (L = n), so the port's f64
    run equals the JAX package's, ids and distances."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((400, 16))
    Q = None if mode == "all_pairs" else rng.standard_normal((50, 16))
    kw = dict(k=5, dtype="float64", topk_method=method, query_tile=64,
              **PATHS[path])
    got = all_knn(X, queries=Q, device="cpu", **kw)
    want = jax_pkg.all_knn(X, queries=Q, **kw)
    assert got.dists.dtype == torch.float64
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["approx", "approx-rerank"])
def test_f64_approx_on_wide_tiles_holds_recall_against_jax(method):
    """Tiles of 2048 columns reduce for real: recall against JAX's exact
    CPU op at least the recall target."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((3000, 16))
    kw = dict(k=10, dtype="float64", topk_method=method, backend="serial",
              query_tile=256, corpus_tile=2048)
    got = all_knn(X, device="cpu", **kw)
    want = jax_pkg.all_knn(X, **kw)
    rec = recall_against_oracle(got.ids.numpy(), np.asarray(want.dists),
                                np.asarray(want.ids), 10)
    assert rec >= {"approx": 0.95, "approx-rerank": 0.99}[method], rec


@pytest.mark.parametrize("method", ["approx", "approx-rerank"])
def test_f64_approx_config_as_the_reference(method):
    cfg = KNNConfig(topk_method=method, dtype="float64")
    ref = jax_pkg.KNNConfig(topk_method=method, dtype="float64")
    assert config_from_reference(dataclasses.asdict(ref)) == cfg


@pytest.mark.parametrize("method", ["approx", "approx-rerank"])
def test_pallas_refuses_f64_as_the_reference(method):
    X = _rows(64, 8)
    kw = dict(k=3, dtype="float64", topk_method=method, backend="pallas")
    with pytest.raises(ValueError, match="float32"):
        all_knn(X, device="cpu", **kw)
    with pytest.raises(ValueError, match="float32"):
        jax_pkg.all_knn(X, **kw)


def test_approx_min_k_keeps_f64_values():
    x = torch.from_numpy(_rows(2, 300))
    v, p = approx_min_k(x, 10)
    assert v.dtype == torch.float64
    assert torch.equal(v, torch.gather(x, 1, p))
