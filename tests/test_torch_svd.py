"""The port's SVD reduction against the JAX package's ``svd_reduce``.

The data have a spread spectrum: singular values decaying geometrically,
so every kept direction is well separated from the next (on
``make_mnist_like`` the noise floor is degenerate beyond 9 directions, and
a direction there is not defined)."""

import numpy as np
import pytest
import torch

from mpi_knn_tpu.data.svd import svd_reduce as ref_svd_reduce
from mpi_knn_tpu_torch.data.svd import gram_eigh, svd_reduce


def _spread(m=300, d=24, seed=0):
    rng = np.random.default_rng(seed)
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    scales = 40.0 * 0.7 ** np.arange(d)
    X = rng.standard_normal((m, d)) * scales @ basis.T + 5.0
    return X.astype(np.float32)


def _pairwise(a):
    a = np.asarray(a, np.float64)
    return ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("out_dim", [1, 4, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_svd_reduce_matches_the_reference(out_dim, seed):
    X = _spread(seed=seed)
    red, comps, mu = svd_reduce(X, out_dim, device="cpu")
    wred, wcomps, wmu = (np.asarray(a) for a in ref_svd_reduce(X, out_dim))
    assert red.shape == (300, out_dim) and comps.shape == (24, out_dim)
    assert red.dtype == comps.dtype == mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), wmu, rtol=1e-6, atol=1e-5)
    # each component equal up to its sign
    sign = np.sign((comps.numpy() * wcomps).sum(0))
    np.testing.assert_allclose(comps.numpy() * sign, wcomps, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(red.numpy() * sign, wred, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_pairwise(red), _pairwise(wred), rtol=1e-4,
                               atol=1e-2)


def test_eigenvalues_match_an_f64_decomposition():
    X = _spread(m=500, d=32, seed=2)
    vals, vecs, mu = gram_eigh(torch.from_numpy(X))
    Xc = X.astype(np.float64) - X.astype(np.float64).mean(0)
    want = np.linalg.eigvalsh(Xc.T @ Xc)[::-1]
    # f32 products: the error scales with the largest eigenvalue
    np.testing.assert_allclose(vals.numpy(), want, rtol=1e-5,
                               atol=1e-6 * want[0])
    assert vecs.shape == (32, 32) and mu.shape == (32,)


def test_queries_project_into_the_same_subspace():
    X = _spread()
    red, comps, mu = svd_reduce(X, 6, device="cpu")
    again = torch.matmul(torch.from_numpy(X) - mu, comps)
    assert torch.equal(again, red)


@pytest.mark.parametrize("out_dim", [0, 25, -1])
def test_out_dim_is_checked_as_the_reference_checks_it(out_dim):
    X = _spread()
    with pytest.raises(ValueError, match="out_dim must be in"):
        svd_reduce(X, out_dim, device="cpu")
    with pytest.raises(ValueError, match="out_dim must be in"):
        ref_svd_reduce(X, out_dim)


def test_svd_reduce_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        svd_reduce(_spread(), 2)
