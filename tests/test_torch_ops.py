"""Parity of the port's core ops (mpi_knn_tpu_torch.ops) with the JAX
package's, on the same numpy inputs made from a seed. Distances at rtol
1e-5 (the two frameworks sum in different orders); masks, selection and
votes exactly."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops import distance as jd
from mpi_knn_tpu.ops import topk as jt
from mpi_knn_tpu_torch.ops import distance as td
from mpi_knn_tpu_torch.ops import topk as tt
from mpi_knn_tpu_torch.ops import vote as tv

# the JAX package's ops/__init__ re-exports a function named ``vote``
jv = importlib.import_module("mpi_knn_tpu.ops.vote")
TIE_BREAKS = ["nearest", "lowest", "quirk-serial", "quirk-mpi"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gauss(seed, shape, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32
    )


def test_center_for_l2_host_branch_is_bitwise():
    X = _gauss(0, (64, 16)) + 100.0
    Q = _gauss(1, (8, 16))
    jc, jq = jd.center_for_l2(X, Q, all_pairs=False)
    tc, tq = td.center_for_l2(X, Q, all_pairs=False)
    np.testing.assert_array_equal(np.asarray(jc).astype(np.float32),
                                  tc.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jq).astype(np.float32),
                                  tq.astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_pairwise_matches_jax(metric):
    x, y = _gauss(2, (48, 24)), _gauss(3, (40, 24))
    want = np.asarray(jd.pairwise_dist(jnp.asarray(x), jnp.asarray(y), metric))
    got = _np(td.pairwise_dist(torch.from_numpy(x), torch.from_numpy(y), metric))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "exclude_self,exclude_zero,zero_eps,with_scale",
    [(True, True, 0.0, True), (True, True, 0.0, False), (False, True, 2.0, True),
     (True, False, 0.0, True), (False, False, 0.0, False)],
)
def test_mask_tile_matches_jax(exclude_self, exclude_zero, zero_eps, with_scale):
    rng = np.random.default_rng(4)
    d = rng.integers(0, 6, (16, 24)).astype(np.float32)
    cand = np.arange(24, dtype=np.int32)
    cand[-3:] = -1
    qids = rng.integers(-1, 24, 16).astype(np.int32)
    scale = rng.random((16, 24)).astype(np.float32) * 1e6 if with_scale else None
    want = jt.mask_tile(jnp.asarray(d), jnp.asarray(cand), jnp.asarray(qids),
                        exclude_self, exclude_zero, zero_eps,
                        None if scale is None else jnp.asarray(scale))
    got = tt.mask_tile(torch.from_numpy(d), torch.from_numpy(cand),
                       torch.from_numpy(qids), exclude_self, exclude_zero,
                       zero_eps, None if scale is None else torch.from_numpy(scale))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def _tied_candidates(seed, q=12, c=300):
    """Small-integer distances (many exact ties), some +inf slots."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 20, (q, c)).astype(np.float32)
    d[rng.random((q, c)) < 0.1] = np.inf
    ids = rng.permutation(c).astype(np.int32)
    return d, ids


@pytest.mark.parametrize("method", ["exact", "block"])
@pytest.mark.parametrize("k", [1, 7, 40, 400])
def test_smallest_k_matches_jax(method, k):
    d, ids = _tied_candidates(5)
    wd, wi = jt.smallest_k(jnp.asarray(d), jnp.asarray(ids), k, method=method,
                           block=32)
    gd, gi = tt.smallest_k(torch.from_numpy(d), torch.from_numpy(ids), k,
                           method=method, block=32)
    np.testing.assert_array_equal(_np(gd), np.asarray(wd))
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))


@pytest.mark.parametrize("method", ["exact", "block"])
def test_cascade_smallest_k_matches_jax(method):
    d, ids = _tied_candidates(6, c=1000)
    ids2 = np.broadcast_to(ids, d.shape).copy()
    wd, wi = jt.cascade_smallest_k(jnp.asarray(d), jnp.asarray(ids2), 9,
                                   method=method, block=64, max_width=100)
    gd, gi = tt.cascade_smallest_k(torch.from_numpy(d), torch.from_numpy(ids2),
                                   9, method=method, block=64, max_width=100)
    np.testing.assert_array_equal(_np(gd), np.asarray(wd))
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))


def test_merge_topk_matches_jax():
    d, ids = _tied_candidates(7, c=40)
    ids2 = np.broadcast_to(ids, d.shape).copy()
    a = (d[:, :20], ids2[:, :20])
    b = (d[:, 20:], ids2[:, 20:])
    wd, wi = jt.merge_topk(*(jnp.asarray(x) for x in (*a, *b)))
    gd, gi = tt.merge_topk(*(torch.from_numpy(x) for x in (*a, *b)))
    np.testing.assert_array_equal(_np(gd), np.asarray(wd))
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))


def _vote_inputs(seed, q=64, k=6, C=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, 50).astype(np.int32)
    ids = rng.integers(0, 50, (q, k)).astype(np.int32)
    ids[rng.random((q, k)) < 0.2] = -1
    ids[:3] = -1  # rows with no valid neighbor: the -1 sentinel
    return ids, labels, C


@pytest.mark.parametrize("tie_break", TIE_BREAKS)
def test_vote_matches_jax(tie_break):
    ids, labels, C = _vote_inputs(8)
    valid = ids >= 0
    neigh = labels[np.where(valid, ids, 0)]
    want = jv.vote(jnp.asarray(neigh), jnp.asarray(valid), C, tie_break)
    got = tv.vote(torch.from_numpy(neigh), torch.from_numpy(valid), C, tie_break)
    np.testing.assert_array_equal(_np(got.counts), np.asarray(want.counts))
    np.testing.assert_array_equal(_np(got.predictions),
                                  np.asarray(want.predictions))


@pytest.mark.parametrize("tie_break", TIE_BREAKS)
def test_classify_from_labels_matches_jax(tie_break):
    ids, labels, C = _vote_inputs(9)
    want = jv.classify_from_labels(jnp.asarray(ids), jnp.asarray(labels), C,
                                   tie_break)
    got = tv.classify_from_labels(torch.from_numpy(ids),
                                  torch.from_numpy(labels), C, tie_break)
    preds = _np(got.predictions)
    np.testing.assert_array_equal(preds, np.asarray(want.predictions))
    assert (preds[:3] == -1).all()
