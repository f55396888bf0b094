"""The port's ring block merge (``ops/fused_ring.fused_block_merge``, its
plain versions on the CPU) against the JAX package's Pallas
``fused_block_merge`` in interpret mode, on the same operands.

The rows are integers in [−127, 127] over 16, each with one entry at
±127/16: every product and sum is exact in f32, every value exact in bf16,
and int8 quantization is lossless (scale 1/16). So every branch and wire
must agree bit for bit, ids and distances, NaN rows included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.ops.pallas_ring import fused_block_merge as jax_merge
from mpi_knn_tpu.ops.quant import quantize_rows as jax_quantize
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch.ops import fused_ring

Q_LOCAL, B, DIM, Q_TILE, C_TILE = 32, 64, 12, 8, 16


def _rows(rng, n):
    x = rng.integers(-127, 128, (n, DIM)).astype(np.float32)
    x[np.arange(n), rng.integers(0, DIM, n)] = 127.0
    return x / 16


def _operands(seed, k, nan_row=False):
    """Permuted block ids with −1 padding, a query whose own id is in the
    block, a duplicate of a query row, and a carry whose distances tie
    block entries under lower ids."""
    rng = np.random.default_rng(seed)
    q, blk = _rows(rng, Q_LOCAL), _rows(rng, B)
    blk[21] = q[2]
    bids = (rng.permutation(1000)[:B] + 100).astype(np.int32)
    bids[-6:] = -1
    qids = np.arange(Q_LOCAL, dtype=np.int32) + 2000
    qids[5] = bids[40]
    d = ((q[:, None].astype(np.float64) - blk[None]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    cd = np.take_along_axis(d, order[:, 1:1 + k], 1).astype(np.float32)
    ci = rng.integers(0, 100, (Q_LOCAL, k)).astype(np.int32)
    if nan_row:
        q[6] = np.nan
    return q, qids, blk, bids, cd, ci


def _wire(blk, wire):
    """(jax block, jax scale, port block, port scale) at the wire type."""
    if wire == "int8":
        codes, scale = jax_quantize(blk, "int8")
        codes, scale = np.array(codes), np.array(scale)
        return codes, scale, torch.from_numpy(codes), torch.from_numpy(scale)
    if wire == "bfloat16":
        return (jnp.asarray(blk, jnp.bfloat16), None,
                torch.from_numpy(blk).to(torch.bfloat16), None)
    return blk, None, torch.from_numpy(blk), None


CASES = {
    # name: (policy, wire, k) -> the branch it takes at c_tile 16
    "exact_f32": ("exact", None, 5),             # K3a
    "exact_bf16": ("exact", "bfloat16", 5),      # K3a, bf16 wire
    "compress_f32": ("mixed", None, 3),          # K3b: 4k=12 < 16
    "compress_bf16": ("mixed", "bfloat16", 3),
    "compress_int8": ("mixed", "int8", 3),
    "degenerate_f32": ("mixed", None, 5),        # 4k=20 >= 16: K3a
    "degenerate_int8": ("mixed", "int8", 4),     # K3a on an int8 wire
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_block_merge_bitwise_equal_to_jax(case, seed):
    policy, wire, k = CASES[case]
    q, qids, blk, bids, cd, ci = _operands(seed, k)
    jblk, jscl, pblk, pscl = _wire(blk, wire)
    jcfg = jax_pkg.KNNConfig(k=k, precision_policy=policy,
                             ring_transfer_dtype=wire)
    pcfg = KNNConfig(k=k, precision_policy=policy, ring_transfer_dtype=wire)
    wd, wi = jax_merge(q, qids, jblk, bids, jscl, cd, ci, cfg=jcfg,
                       q_tile=Q_TILE, c_tile=C_TILE)
    gd, gi = fused_ring.fused_block_merge(
        torch.from_numpy(q), torch.from_numpy(qids), pblk,
        torch.from_numpy(bids), pscl, torch.from_numpy(cd),
        torch.from_numpy(ci), cfg=pcfg, q_tile=Q_TILE, c_tile=C_TILE)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    # the planted cases really were exercised
    got = gi.numpy()
    assert bids[40] not in got[5]                     # self by id
    assert (got[:, :1] < 100).any()                   # the carry won ties
    assert not np.isin(got, [-1]).all(axis=1).any()


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_nan_query_row_poisons_exactly_that_row(wire):
    q, qids, blk, bids, cd, ci = _operands(2, 5, nan_row=True)
    jblk, _, pblk, _ = _wire(blk, wire)
    jcfg = jax_pkg.KNNConfig(k=5, ring_transfer_dtype=wire)
    wd, wi = jax_merge(q, qids, jblk, bids, None, cd, ci, cfg=jcfg,
                       q_tile=Q_TILE, c_tile=C_TILE)
    gd, gi = fused_ring.fused_block_merge(
        torch.from_numpy(q), torch.from_numpy(qids), pblk,
        torch.from_numpy(bids), None, torch.from_numpy(cd),
        torch.from_numpy(ci), cfg=KNNConfig(k=5, ring_transfer_dtype=wire),
        q_tile=Q_TILE, c_tile=C_TILE)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert np.isnan(gd[6].numpy()).all() and (gi[6].numpy() == -1).all()
    assert np.isfinite(gd[7].numpy()).all()


def test_compress_positions_hand_out_untaken_columns_in_order():
    """A tile with fewer finite keys than ov: the finite ones ascending,
    then the masked columns in index order."""
    rng = np.random.default_rng(3)
    q, blk = _rows(rng, 8), _rows(rng, 16)
    bids = np.full(16, -1, np.int32)
    bids[[3, 9, 12]] = [7, 8, 9]
    pos = fused_ring.block_merge_compress(
        torch.from_numpy(q), torch.full((8,), -1, dtype=torch.int32),
        torch.from_numpy(blk), torch.from_numpy(bids), None, ov=8,
        c_tile=16)
    assert pos.shape == (1, 8, 8)
    for row in pos[0].numpy():
        assert sorted(row[:3].tolist()) == [3, 9, 12]
        assert row[3:].tolist() == [0, 1, 2, 4, 5]


def test_wrappers_refuse_bad_operands():
    q, qids, blk, bids, cd, ci = _operands(0, 5)
    t = torch.from_numpy
    cfg = KNNConfig(k=5)
    with pytest.raises(ValueError, match="tile"):
        fused_ring.fused_block_merge(t(q), t(qids), t(blk), t(bids), None,
                                     t(cd), t(ci), cfg=cfg, q_tile=5,
                                     c_tile=C_TILE)
    codes = t(blk).to(torch.int8)  # an int8 block without its scales
    with pytest.raises(ValueError, match="int8"):
        fused_ring.block_merge_exact(t(q), t(qids), codes, t(bids), None,
                                     t(cd), t(ci), c_tile=C_TILE)
    with pytest.raises(TypeError, match="int32"):
        fused_ring.block_merge_exact(t(q), t(qids).long(), t(blk), t(bids),
                                     None, t(cd), t(ci), c_tile=C_TILE)


def test_launch_counts_untouched_by_plain_versions():
    fused_ring.reset_launch_counts()
    for case in ("exact_f32", "compress_f32"):
        policy, wire, k = CASES[case]
        q, qids, blk, bids, cd, ci = _operands(0, k)
        fused_ring.fused_block_merge(
            torch.from_numpy(q), torch.from_numpy(qids), torch.from_numpy(blk),
            torch.from_numpy(bids), None, torch.from_numpy(cd),
            torch.from_numpy(ci), cfg=KNNConfig(k=k, precision_policy=policy),
            q_tile=Q_TILE, c_tile=C_TILE)
    assert fused_ring.LAUNCHES == {"fused_block_merge[exact]": 0,
                                   "fused_block_merge[compress]": 0,
                                   "fused_block_merge[default]": 0,
                                   "fused_block_merge[high]": 0,
                                   "stage_tf32[wire]": 0,
                                   "stage_bf16[wire]": 0}
