"""The plain PyTorch versions of the port's two kernels (what the wrappers
run for CPU tensors) against the JAX package's Pallas kernels, run in
interpret mode on the CPU as its own tests run them.

Small-integer data (multiples of 0.25 below 2) makes every product and sum
exact in f32 and every value exact in bf16, so ids AND distances must be
equal, in exact and in compress mode: that pins the tie rule. On Gaussian
data the sum orders differ between XLA and torch, so distances are held at
rtol 1e-5 + 1e-4·(q²+c²) and ids at tie-aware recall 1.0.
"""

import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops.pallas_knn import fused_knn_sweep as jax_sweep
from mpi_knn_tpu.ops.pallas_knn import fused_knn_tiles as jax_tiles
from mpi_knn_tpu_torch.ops import fused_knn
from tests.oracle import recall_against_oracle

KERNELS = {
    "tiles": (jax_tiles, fused_knn.fused_knn_tiles),
    "sweep": (jax_sweep, fused_knn.fused_knn_sweep),
}


def _small_int(seed, m, d):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 8, (m, d)) * 0.25).astype(np.float32)


def _gauss(seed, m, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)) * 3.0).astype(np.float32)


def _pad(x, multiple):
    rows = -(-len(x) // multiple) * multiple
    return np.concatenate([x, np.zeros((rows - len(x), x.shape[1]), x.dtype)])


def _both(variant, q, c, m, k, q_tile, c_tile, **kw):
    jax_fn, port_fn = KERNELS[variant]
    qp, cp = _pad(q, q_tile), _pad(c, c_tile)
    wd, wi = jax_fn(qp, cp, m, k, q_tile, c_tile, **kw)
    gd, gi = port_fn(torch.from_numpy(qp), torch.from_numpy(cp), m, k, q_tile,
                     c_tile, **kw)
    return (np.asarray(wd), np.asarray(wi)), (gd.numpy(), gi.numpy()), qp, cp


# (name, data, queries-or-None, m, k, q_tile, c_tile, kwargs)
def _exact_cases():
    X = _small_int(0, 200, 16)
    dup = X.copy()
    dup[5] = dup[60]
    dup[7] = dup[60]
    Q = _small_int(1, 37, 16)
    nanq = Q.copy()
    nanq[4] = np.nan
    return [
        ("all_pairs", X, None, 5, 64, 128, {}),
        ("non_divisible", X[:157], None, 6, 32, 64, {}),
        ("query_mode", X, Q, 4, 16, 128, dict(all_pairs=False)),
        ("duplicates", dup, None, 5, 64, 128, {}),
        ("abs_zero_eps", X, None, 5, 64, 128, dict(zero_eps=0.75)),
        ("no_self_no_zero", dup, None, 5, 64, 128,
         dict(exclude_self=False, exclude_zero=False)),
        ("k_equals_c_tile", X[:96], None, 32, 32, 32, {}),
        ("nan_query_row", X, nanq, 4, 16, 128, dict(all_pairs=False)),
        # widths off the exact tile's 16-float k-block (planes padded to 16, 112)
        ("width_8", _small_int(2, 150, 8), None, 7, 32, 64, {}),
        ("width_97", _small_int(3, 150, 97), None, 10, 32, 64, {}),
    ]


EXACT = {c[0]: c[1:] for c in _exact_cases()}


@pytest.mark.parametrize("variant", ["tiles", "sweep"])
@pytest.mark.parametrize("case", list(EXACT))
def test_plain_kernel_equals_pallas_on_small_integers(variant, case):
    X, Q, k, q_tile, c_tile, kw = EXACT[case]
    queries = X if Q is None else Q
    (wd, wi), (gd, gi), _, _ = _both(variant, queries, X, len(X), k, q_tile,
                                     c_tile, **kw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)  # NaN == NaN here
    if case == "nan_query_row":
        assert (gi[4] == -1).all() and np.isnan(gd[4]).all()
    if case == "duplicates":
        assert 60 not in gi[5] and 5 not in gi[60]


@pytest.mark.parametrize("variant", ["tiles", "sweep"])
@pytest.mark.parametrize("case", ["all_pairs", "non_divisible", "query_mode",
                                  "duplicates", "nan_query_row"])
def test_plain_compress_equals_pallas_on_small_integers(variant, case):
    """compress=True: bf16-rounded dot, no zero mask, clamp at 0, k as the
    overfetch width."""
    X, Q, k, q_tile, c_tile, kw = EXACT[case]
    queries = X if Q is None else Q
    ov = min(4 * k, c_tile)
    (wd, wi), (gd, gi), _, _ = _both(variant, queries, X, len(X), ov, q_tile,
                                     c_tile, compress=True, **kw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)
    if case == "duplicates":  # zero distances are kept in compress mode
        assert 60 in gi[5]


GAUSS = {
    "all_pairs": (_gauss(2, 300, 32), None, 8, 64, 128, {}),
    "query_mode": (_gauss(3, 250, 24), _gauss(4, 50, 24), 6, 32, 128,
                   dict(all_pairs=False)),
}


@pytest.mark.parametrize("variant", ["tiles", "sweep"])
@pytest.mark.parametrize("case", list(GAUSS))
def test_plain_kernel_matches_pallas_on_gaussian(variant, case):
    X, Q, k, q_tile, c_tile, kw = GAUSS[case]
    queries = X if Q is None else Q
    (wd, wi), (gd, gi), qp, cp = _both(variant, queries, X, len(X), k, q_tile,
                                       c_tile, **kw)
    n = len(queries)
    # one sorted list of k per query (sweep) or per (query, corpus tile)
    lists = gd.shape[1] // k
    wd, wi, gd, gi = (a[:n].reshape(-1, k) for a in (wd, wi, gd, gi))
    q_sq = np.repeat((qp[:n].astype(np.float64) ** 2).sum(1), lists)
    c_sq = (cp.astype(np.float64) ** 2).sum(1)
    tol = 1e-5 * np.abs(wd) + 1e-4 * (q_sq[:, None] + c_sq[np.maximum(wi, 0)])
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    assert (np.abs(gd - wd)[fin] <= tol[fin]).all()
    assert recall_against_oracle(gi, wd, wi, k) == 1.0


@pytest.mark.parametrize("variant", ["tiles", "sweep"])
def test_wrappers_refuse_bad_inputs(variant):
    fn = KERNELS[variant][1]
    x = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="pad"):
        fn(x[:60], x, 64, 4, 32, 64)
    with pytest.raises(ValueError, match="corpus_tile"):
        fn(x, x, 64, 65, 32, 64)
    with pytest.raises(TypeError, match="float32"):
        fn(x.double(), x.double(), 64, 4, 32, 64)


def test_launch_counts_untouched_by_plain_versions():
    fused_knn.reset_launch_counts()
    x = torch.from_numpy(_small_int(5, 64, 8))
    fused_knn.fused_knn_tiles(x, x, 64, 4, 32, 64)
    fused_knn.fused_knn_sweep(x, x, 64, 4, 32, 64)
    fused_knn.fused_knn_tiles(x, x, 64, 4, 32, 64, compress=True)
    fused_knn.fused_knn_sweep(x, x, 64, 4, 32, 64, compress=True)
    assert fused_knn.LAUNCHES == {
        "fused_knn_tiles": 0, "fused_knn_sweep": 0,
        "fused_knn_tiles[compress]": 0, "fused_knn_sweep[compress]": 0,
        "stage_tf32_split": 0, "stage_bf16": 0}
