"""K1 and K2 at ``matmul_precision`` "default" / "high" on the staged bf16
planes, on the CPU: the prologue's plain version (``stage_planes``) against
the JAX package's bf16 rounding, and a plain model of K2's corpus split
(``fused_knn_sweep_split_reference`` at a precision) against the unsplit
plain version, bit for bit.

The card prologue writes hi = bf16(x) (round to nearest even) and, at
"high", lo = bf16(x − hi), zero-padded to a multiple of 32, beside the
f32 norms of the unrounded rows; the card kernel cuts the corpus into S
slices and merges the slices' lists by (distance, column), so its output
must not depend on S.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_knn_tpu_torch.ops import fused_knn
from mpi_knn_tpu_torch.ops.distance import sq_norms

PRECISIONS = ["default", "high"]


def _rows(seed=0, m=70, d=45):
    """Random normal rows with a zero row and a duplicate pair."""
    x = np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32) * 3.0
    x[4] = 0.0
    x[11] = x[30]
    return x


def _jax_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("d", [45, 64, 100])
def test_planes_are_jax_bf16_rounding_zero_padded(precision, d):
    x = _rows(1, d=d)
    width = fused_knn.staged_width(d)
    hi, lo, norms = fused_knn.stage_planes(torch.from_numpy(x), precision)
    assert hi.dtype == torch.bfloat16 and hi.shape == (len(x), width)
    want_hi = _jax_bf16(x)
    np.testing.assert_array_equal(hi[:, :d].float().numpy(), want_hi)
    assert not hi[:, d:].float().any()
    if precision == "default":
        assert lo is None
    else:
        want_lo = _jax_bf16(x - want_hi)
        assert lo.dtype == torch.bfloat16 and lo.shape == hi.shape
        np.testing.assert_array_equal(lo[:, :d].float().numpy(), want_lo)
        assert not lo[:, d:].float().any()
        assert lo[:, :d].float().abs().sum() > 0  # the values needed a lo
    assert torch.equal(norms, sq_norms(torch.from_numpy(x)))
    assert not hi[4].float().any() and torch.equal(hi[11], hi[30])


@pytest.mark.parametrize("precision", PRECISIONS)
def test_planes_width_is_the_tiles_k_block(precision):
    """The staged width is d rounded up to the tile's 32-deep k-block, the
    same as the compress copy's."""
    for d in (1, 31, 32, 33, 784):
        x = torch.ones((3, d))
        hi, lo, _ = fused_knn.stage_planes_reference(
            x, precision, fused_knn.staged_width(d))
        assert hi.shape[1] == fused_knn.staged_width(d) == -(-d // 32) * 32
        assert (lo is None) == (precision == "default")


def _pad(x, multiple):
    rows = -(-len(x) // multiple) * multiple
    return np.concatenate([x, np.zeros((rows - len(x), x.shape[1]), x.dtype)])


def _split_cases():
    X = _rows(2, m=250, d=40)
    X[60] = X[5]
    Q = _rows(3, m=40, d=40)
    Q[7] = np.nan
    Q[9] = X[96]
    return {
        # m_corpus 230 of 256 rows: padded corpus rows masked
        "all_pairs": (X, X, 230, dict()),
        "query_mode_nan_row": (Q, X, 237, dict(all_pairs=False)),
        "no_self_mask": (X, X, 201, dict(exclude_self=False)),
        "zero_eps": (X, X, 250, dict(zero_eps=0.5)),
    }


SPLIT = _split_cases()


@pytest.mark.parametrize("slices", [1, 2, 5])
@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", list(SPLIT))
def test_precision_split_then_merge_equals_the_plain_version_bitwise(
        case, precision, k, slices):
    q, c, m, kw = SPLIT[case]
    qp = torch.from_numpy(_pad(q, 64))
    cp = torch.from_numpy(_pad(c, 128))
    want = fused_knn.fused_knn_sweep_reference(qp, cp, m, k, 64, 128,
                                               precision=precision, **kw)
    got = fused_knn.fused_knn_sweep_split_reference(
        qp, cp, m, k, 64, 128, slices=slices, cols=32, precision=precision, **kw)
    assert torch.equal(got[1], want[1])
    assert torch.equal(torch.nan_to_num(got[0], posinf=-1.0),
                       torch.nan_to_num(want[0], posinf=-1.0))
    ids = got[1].numpy()
    assert (ids < m).all()
    if case == "query_mode_nan_row":
        assert np.isnan(got[0][7].numpy()).all() and (ids[7] == -1).all()
    if case == "all_pairs":
        assert 5 not in ids[5]  # self masked


def test_precision_split_default_width_matches_the_kernels_chunk():
    q, c, m, kw = SPLIT["all_pairs"]
    qp, cp = torch.from_numpy(_pad(q, 64)), torch.from_numpy(_pad(c, 128))
    for precision in PRECISIONS:
        want = fused_knn.fused_knn_sweep_reference(qp, cp, m, 8, 64, 128,
                                                   precision=precision)
        got = fused_knn.fused_knn_sweep_split_reference(qp, cp, m, 8, 64, 128,
                                                        slices=1, precision=precision)
        assert torch.equal(got[1], want[1])


def test_a_high_staging_serves_default_from_its_hi_plane():
    """A corpus staged at "high" holds "default"'s planes: its hi plane and
    norms, without a second copy."""
    x = torch.from_numpy(_rows(4))
    high = fused_knn.stage_planes(x, "high")
    staged = fused_knn.StagedCorpus(high=high)
    hi, lo, norms = staged.part("default")
    assert hi is high[0] and lo is None and norms is high[2]
    assert staged.part("exact") is None
    assert staged.nbytes == sum(t.numel() * t.element_size() for t in high)
    assert fused_knn.staged_part(False, "high") == "high"
    assert fused_knn.staged_part(False, "default") == "default"
    assert fused_knn.staged_part(False, None) == "exact"
    assert fused_knn.staged_part(True) == "compress"
