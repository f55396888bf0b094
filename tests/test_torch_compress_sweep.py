"""K2[c], the compress sweep (``fused_knn_sweep(compress=True)``), on the CPU:
its work split (``compress_sweep_plan``), a plain model of the kernel's
split-then-merge against the plain version, and the plain version against
the JAX package's Pallas kernel run in interpret mode.

The card kernel cuts the corpus into S slices and merges the slices' lists
by (distance, column); the output must not depend on S. On small-integer
data (multiples of 0.25 below 2: every product and sum exact in f32, every
value exact in bf16) the model of the split must equal the plain version
bit for bit, ties included. On Gaussian data the plain version is held to
the JAX kernel at rtol 1e-5 + 1e-4·(q²+c²) and tie-aware recall 1.0, as in
``tests/test_torch_fused_knn.py``.
"""

import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops.pallas_knn import fused_knn_sweep as jax_sweep
from mpi_knn_tpu_torch.ops import fused_knn
from tests.oracle import recall_against_oracle

SMS = 132  # an H100's SMs


def _small_int(seed, m, d):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 8, (m, d)) * 0.25).astype(np.float32)


def _pad(x, multiple):
    rows = -(-len(x) // multiple) * multiple
    return np.concatenate([x, np.zeros((rows - len(x), x.shape[1]), x.dtype)])


# ---------------------------------------------------------------- the plan

PLAN_SHAPES = [(1024, 60000), (2048, 60000), (60416, 60000), (300, 1000),
               (4096, 8192), (128, 300), (16896, 60000)]


@pytest.mark.parametrize("Q,c_end", PLAN_SHAPES)
def test_plan_items_cover_every_group_and_column_once(Q, c_end):
    plan = fused_knn.compress_sweep_plan(Q, c_end, SMS)
    items = fused_knn.compress_sweep_items(plan, c_end)
    assert len(items) == plan["items"] == plan["groups"] * plan["slices"]
    assert plan["span"] % plan["cols"] == 0
    for g in range(plan["groups"]):
        spans = sorted((c0, c1) for gg, c0, c1 in items if gg == g)
        assert len(spans) == plan["slices"]
        assert spans[0][0] == 0 and spans[-1][1] == c_end
        for (_, end), (begin, _) in zip(spans, spans[1:]):
            assert end == begin  # no column twice, none left out
        assert all(c1 > c0 for c0, c1 in spans)  # no empty slice
    assert plan["grid"] == min(plan["items"], SMS)


@pytest.mark.parametrize("groups", [132, 264, 660])
def test_plan_keeps_one_slice_when_the_groups_fill_the_card(groups):
    plan = fused_knn.compress_sweep_plan(groups * 128, 60000, SMS)
    assert plan["slices"] == 1
    assert plan["waves"] == groups / SMS


def test_plan_splits_the_corpus_at_serving_buckets():
    b1024 = fused_knn.compress_sweep_plan(1024, 60000, SMS)
    b2048 = fused_knn.compress_sweep_plan(2048, 60000, SMS)
    assert b1024["slices"] >= 16 and b2048["slices"] > 1
    for plan in (b1024, b2048):  # one full wave, no second
        assert plan["items"] <= SMS and plan["waves"] == 1.0


def test_plan_at_the_main_shape_wastes_no_more_than_one_slice():
    plan = fused_knn.compress_sweep_plan(60416, 60000, SMS)

    def cost(s):
        return fused_knn.compress_sweep_plan(60416, 60000, SMS, slices=s)

    def modelled(p):
        return -(-p["items"] // SMS) * (p["span"] // p["cols"]
                                        + fused_knn.ITEM_OVERHEAD_CHUNKS)

    assert all(modelled(plan) <= modelled(cost(s)) for s in range(1, 65))


def test_plan_takes_a_forced_split_and_refuses_zero():
    assert fused_knn.compress_sweep_plan(1024, 60000, SMS, slices=5)["slices"] == 5
    with pytest.raises(ValueError, match="slices"):
        fused_knn.compress_sweep_plan(1024, 60000, SMS, slices=0)


# --------------------------------------------- the split against the plain


def _split_cases():
    X = _small_int(0, 200, 24)
    X[5] = X[60]  # an exact duplicate pair: kept, the zero mask is off
    for a, b in ((63, 64), (95, 96), (127, 128), (191, 192)):
        X[b] = X[a]  # equal distances on both sides of a slice border
    Q = _small_int(1, 40, 24)
    Q[7] = np.nan
    Q[9] = X[96]
    return {
        # m_corpus 200 of 256 rows: padded corpus rows masked
        "all_pairs": (X, X, 200, dict()),
        "query_mode_nan_row": (Q, X, 200, dict(all_pairs=False)),
        "no_self_mask": (X, X, 190, dict(exclude_self=False)),
    }


SPLIT = _split_cases()


@pytest.mark.parametrize("slices", [1, 2, 3, 5])
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("case", list(SPLIT))
def test_split_then_merge_equals_the_plain_version_bitwise(case, k, slices):
    q, c, m, kw = SPLIT[case]
    qp = torch.from_numpy(_pad(q, 64))
    cp = torch.from_numpy(_pad(c, 128))
    want = fused_knn.fused_knn_sweep_reference(qp, cp, m, k, 64, 128,
                                               compress=True, **kw)
    got = fused_knn.fused_knn_sweep_split_reference(qp, cp, m, k, 64, 128,
                                                    slices=slices, cols=32, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.nan_to_num(got[0], posinf=-1.0),
                       torch.nan_to_num(want[0], posinf=-1.0))
    ids = got[1].numpy()
    assert (ids < m).all()
    if case == "all_pairs":
        assert 60 in ids[5] and 5 in ids[60]  # the duplicate pair kept
        assert 5 not in ids[5]  # self masked
    if case == "no_self_mask":
        assert ids[5][0] in (5, 60) and ids[5][1] in (5, 60)
    if case == "query_mode_nan_row":
        assert np.isnan(got[0][7].numpy()).all() and (ids[7] == -1).all()
        # query 9 equals rows 95 and 96 (one on each side of a border at
        # cols 32, S = 3): the leftmost id first
        assert list(ids[9][:2]) == [95, 96]


def test_split_default_width_matches_the_kernels_chunk():
    q, c, m, kw = SPLIT["all_pairs"]
    qp, cp = torch.from_numpy(_pad(q, 64)), torch.from_numpy(_pad(c, 128))
    want = fused_knn.fused_knn_sweep_reference(qp, cp, m, 8, 64, 128, compress=True)
    got = fused_knn.fused_knn_sweep_split_reference(qp, cp, m, 8, 64, 128, slices=1)
    assert torch.equal(got[1], want[1])


# ------------------------------------------------ the plain against Pallas


@pytest.mark.parametrize("case", list(SPLIT))
def test_split_model_equals_pallas_on_small_integers(case):
    q, c, m, kw = SPLIT[case]
    qp, cp = _pad(q, 64), _pad(c, 128)
    wd, wi = jax_sweep(qp, cp, m, 8, 64, 128, compress=True, interpret=True, **kw)
    gd, gi = fused_knn.fused_knn_sweep_split_reference(
        torch.from_numpy(qp), torch.from_numpy(cp), m, 8, 64, 128, slices=3,
        cols=32, **kw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("all_pairs", [True, False])
def test_plain_compress_sweep_matches_pallas_on_gaussian(all_pairs):
    rng = np.random.default_rng(7)
    c = (rng.standard_normal((300, 40)) * 3.0).astype(np.float32)
    q = c if all_pairs else (rng.standard_normal((70, 40)) * 3.0).astype(np.float32)
    qp, cp = _pad(q, 64), _pad(c, 128)
    ov = 24
    wd, wi = jax_sweep(qp, cp, len(c), ov, 64, 128, compress=True,
                       all_pairs=all_pairs, interpret=True)
    gd, gi = fused_knn.fused_knn_sweep(torch.from_numpy(qp), torch.from_numpy(cp),
                                       len(c), ov, 64, 128, compress=True,
                                       all_pairs=all_pairs)
    n = len(q)
    wd, wi = np.asarray(wd)[:n], np.asarray(wi)[:n]
    gd, gi = gd.numpy()[:n], gi.numpy()[:n]
    q_sq = (qp[:n].astype(np.float64) ** 2).sum(1)
    c_sq = (cp.astype(np.float64) ** 2).sum(1)
    tol = 1e-5 * np.abs(wd) + 1e-4 * (q_sq[:, None] + c_sq[np.maximum(wi, 0)])
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    assert (np.abs(gd - wd)[fin] <= tol[fin]).all()
    assert recall_against_oracle(gi, wd, wi, ov) == 1.0

