"""The exact tile's prologue and operand split, on the CPU.

- The plain form of the exact prologues (``fused_knn.stage_tf32_split``,
  K1/K2's, and ``fused_ring.stage_wire_norms``, the ring's, on CPU
  tensors) decodes each wire as the JAX package's ``_load_wire_tile``
  (``dequantize_rows`` on the int8 wire) does and returns its squared
  norms ``jnp.sum(x * x, -1)`` within rtol 1e-6 (the sum orders differ).
- ``stage_tf32_split``'s planes: hi + lo = x within 2^-22 |x|, lo = 0 for
  small integers, NaN stays NaN, zeros past d, a pitch of d rounded up to
  the tile's 16-float k-block.
- ``fused_knn.tf32_split``, the plain model of the tile's operand split
  x = hi + lo: hi and lo are TF32 values, hi + lo is x within 2^-22 |x|,
  and a value with at most 11 significant bits splits with lo = 0 (so the
  card's small-integer cases stay exact).
- The three-pass product (lo.hi + hi.lo + hi.hi, the split terms summed in
  f64) keeps centered MNIST-like squared distances within 5e-7 (q^2 + c^2)
  of f64, the card's error gate; one pass (hi.hi) does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops.pallas_ring import _load_wire_tile
from mpi_knn_tpu.ops.quant import quantize_rows as jax_quantize
from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
from mpi_knn_tpu_torch.ops import fused_knn, fused_ring

DIM = 50
GATE = 5e-7


def _rows(seed, n=40):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, DIM)) * 3.0).astype(np.float32)
    x[5] = 0.0  # a zero row
    return x


def _wire(x, wire):
    """(jax block, jax (b, 1) scales or None, port block, port scales)."""
    if wire == "int8":
        codes, scale = jax_quantize(x, "int8")
        codes, scale = np.array(codes), np.array(scale)
        return (codes, scale[:, None], torch.from_numpy(codes),
                torch.from_numpy(scale))
    if wire == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16), None,
                torch.from_numpy(x).to(torch.bfloat16), None)
    return x, None, torch.from_numpy(x), None


@pytest.mark.parametrize("wire", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_wire_norms_equal_jax(wire, seed):
    x = _rows(seed)
    jblk, jscl, blk, scale = _wire(x, wire)
    rows = _load_wire_tile(jblk, jscl, wire, DIM)
    want = np.asarray(jnp.sum(rows * rows, -1))
    got = fused_ring.stage_wire_norms(blk, scale)
    assert got.dtype == torch.float32 and got.shape == (len(x),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert got[5] == 0.0
    if wire is None:
        np.testing.assert_allclose(fused_knn.stage_tf32_split(blk)[2].numpy(),
                                   want, rtol=1e-6)


def test_plain_prologue_counts_no_launch():
    fused_knn.reset_launch_counts()
    fused_ring.reset_launch_counts()
    x = torch.from_numpy(_rows(3))
    fused_knn.stage_tf32_split(x)
    fused_ring.stage_wire_norms(x, None)
    assert fused_knn.LAUNCHES["stage_tf32_split"] == 0
    assert fused_ring.LAUNCHES["stage_tf32[wire]"] == 0


def test_prologue_refuses_non_f32_rows():
    with pytest.raises(TypeError, match="float32"):
        fused_knn.stage_tf32_split(torch.zeros(4, 8, dtype=torch.float64))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 255.0, 3e5])
def test_split_reconstructs_within_2_pow_minus_22(scale):
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal(20000) * scale).astype(np.float32))
    hi, lo = fused_knn.tf32_split(x)
    for t in (hi, lo):  # both are TF32 values: 13 low mantissa bits clear
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -11 * x.double().abs()).all())


@pytest.mark.parametrize("values", [
    np.arange(-2047, 2048),                      # 11-bit integers
    np.arange(-127, 128) / 16.0,                 # the ring cases' rows
    np.arange(0, 8) * 0.25,                      # the fused cases' rows
    np.arange(0, 256) * 2.0 ** 20,               # scaled pixels
])
def test_values_of_11_bits_split_with_zero_lo(values):
    x = torch.tensor(values, dtype=torch.float32)
    hi, lo = fused_knn.tf32_split(x)
    assert torch.equal(hi, x)
    assert not bool(lo.any())


def test_non_finite_values_poison_their_products():
    x = torch.tensor([float("nan"), float("inf"), -float("inf")])
    hi, lo = fused_knn.tf32_split(x)
    assert bool(torch.isnan(hi[0])) and torch.equal(hi[1:], x[1:])
    assert bool(torch.isnan(lo).all())


@pytest.mark.parametrize("d,pitch", [(8, 16), (16, 16), (97, 112), (784, 784),
                                     (785, 800)])
def test_split_planes_pitch_and_zero_padding(d, pitch):
    x = torch.from_numpy(_rows(8, n=20)[:, :1].repeat(d, 1) * 0.37)
    hi, lo, norms = fused_knn.stage_tf32_split(x)
    assert fused_knn.split_width(d) == pitch
    assert hi.shape == lo.shape == (20, pitch) and norms.shape == (20,)
    assert hi.dtype == lo.dtype == torch.float32
    assert not bool(hi[:, d:].any()) and not bool(lo[:, d:].any())
    assert pitch % 16 == 0 and (pitch * 4) % 16 == 0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 3e5])
def test_split_planes_rebuild_the_rows(scale):
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.standard_normal((50, 97)) * scale).astype(np.float32))
    hi, lo, norms = fused_knn.stage_tf32_split(x)
    hi, lo = hi[:, :97], lo[:, :97]
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    np.testing.assert_allclose(norms.numpy(), (x.double() ** 2).sum(1).numpy(),
                               rtol=1e-6)


def test_split_planes_of_small_integers_have_zero_lo():
    x = torch.from_numpy(_rows(9)).round().clamp(-2047, 2047)
    hi, lo, _ = fused_knn.stage_tf32_split(x)
    assert torch.equal(hi[:, :DIM], x)
    assert not bool(lo.any())


def test_split_planes_keep_nan_rows_nan():
    x = torch.from_numpy(_rows(10))
    x[2, 7] = float("nan")
    x[4] = float("nan")
    hi, lo, norms = fused_knn.stage_tf32_split(x)
    assert bool(torch.isnan(hi[2, 7])) and bool(torch.isnan(lo[2, 7]))
    assert bool(torch.isnan(hi[4, :DIM]).all()) and bool(torch.isnan(norms[[2, 4]]).all())
    assert bool(torch.isfinite(norms[[0, 1, 3]]).all())


def test_all_pairs_stages_the_corpus_once():
    """Queries that are the corpus' first rows take the corpus' staged
    planes and norms (one prologue); other queries are staged apart."""
    x = torch.from_numpy(_rows(12, n=64))
    (qh, ql, qn), (ch, cl, cn) = fused_knn._stage_exact(x[:40], x)
    assert qh.data_ptr() == ch.data_ptr() and torch.equal(qn, cn[:40])
    other = torch.from_numpy(_rows(13, n=40))
    (qh, _, qn), (ch, _, _) = fused_knn._stage_exact(other, x)
    assert qh.data_ptr() != ch.data_ptr()
    assert torch.equal(qn, fused_knn.stage_tf32_split(other)[2])


def _split64(x):
    hi, lo = fused_knn.tf32_split(torch.from_numpy(x))
    return hi.double().numpy(), lo.double().numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_pass_product_meets_the_error_gate(seed):
    X, _ = make_mnist_like(600, seed=seed)
    Xc = (X - X.astype(np.float64).mean(0)).astype(np.float32)  # host centering
    q, c = Xc[:100], Xc
    (qh, ql), (ch, cl) = _split64(q), _split64(c)

    def three(ah, al, bh, bl):
        return al @ bh.T + ah @ bl.T + ah @ bh.T

    dot = three(qh, ql, ch, cl)
    qn = np.einsum("ij,ij->i", qh, ql) * 2 + np.einsum("ij,ij->i", qh, qh)
    cn = np.einsum("ij,ij->i", ch, cl) * 2 + np.einsum("ij,ij->i", ch, ch)
    d = qn[:, None] - 2.0 * dot + cn[None, :]
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    q2, c2 = (q64 ** 2).sum(1), (c64 ** 2).sum(1)
    d64 = q2[:, None] - 2.0 * (q64 @ c64.T) + c2[None, :]
    scale = q2[:, None] + c2[None, :]
    assert (np.abs(d - d64) / scale).max() <= GATE
    # one pass (hi.hi alone, TF32 as is) misses the gate by orders
    d1 = ((qh ** 2).sum(1)[:, None] - 2.0 * (qh @ ch.T) + (ch ** 2).sum(1)[None, :])
    assert (np.abs(d1 - d64) / scale).max() > 100 * GATE


def _ring_run(cfg_kw, P=2, wire=None):
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.backends import ring
    from mpi_knn_tpu_torch.ops.topk import init_topk

    X = _rows(4, n=64)
    cfg = KNNConfig(k=3, backend="ring-overlap", query_tile=8, corpus_tile=16,
                    ring_transfer_dtype=wire, **cfg_kw)
    devices = [torch.device("cpu")] * P
    q_tile, c_tile, q_sh, qid_sh, travelers = ring.ring_shards(
        cfg, X, X, np.arange(64, dtype=np.int32), devices)
    carries = [init_topk(q.shape[0], 3) for q in q_sh]
    return ring.RingRun(cfg, devices, True, "dma", q_sh, qid_sh, travelers,
                        carries, q_tile, c_tile)


@pytest.mark.parametrize("cfg_kw,wire,exact", [
    (dict(ring_fusion="fused"), None, True),
    (dict(ring_fusion="fused"), "bfloat16", True),
    (dict(ring_fusion="fused", precision_policy="mixed"), "int8", False),
    (dict(ring_fusion="xla"), None, False),
])
def test_ring_stages_norms_once_where_the_merge_is_exact(cfg_kw, wire, exact):
    """The ring's travelers carry the exact prologue's norms of their
    decoded block (and the queries theirs) only where the merge runs K3a's
    exact tile; elsewhere the fourth part is None."""
    run = _ring_run(cfg_kw, wire=wire)
    for (blk, ids, scl, norms, *_), q, qn in zip(run.travelers[0], run.q_sh,
                                                 run.q_norms):
        assert len(run.travelers[0][0]) == 6
        if not exact:
            assert norms is None and qn is None
            continue
        assert torch.equal(norms, fused_ring.stage_wire_norms_reference(blk, scl))
        assert torch.equal(qn, fused_ring.stage_wire_norms_reference(q, None))


def test_bidir_backward_traveler_shares_the_forward_norms():
    run = _ring_run(dict(ring_fusion="fused", ring_schedule="bidir"), P=4)
    assert run.travelers[1] is run.travelers[0]


def test_round_moves_norms_with_the_block():
    """K4's plain version lands each rank's norms in its successor's
    landing buffer with the block, its ids and scales."""
    from mpi_knn_tpu_torch.ops import fused_rotation

    run = _ring_run(dict(ring_fusion="fused"), P=3)
    blocks = run.travelers[0]
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
            for b in blocks]
    fused_rotation.fused_round_dma(
        fused_rotation.ring_transport(["cpu"] * 3), run.q_sh, run.qid_sh,
        blocks, run.carries, land, c_tile=run.c_tile)
    for r in range(3):
        assert torch.equal(land[(r + 1) % 3][3], blocks[r][3])
        assert torch.equal(land[(r + 1) % 3][0], blocks[r][0])


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_traveler_pads_to_four_parts(parts):
    from mpi_knn_tpu_torch.ops import fused_rotation

    t = tuple(torch.zeros(2) for _ in range(parts))
    got = fused_rotation.traveler(t)
    assert len(got) == 6 and got[:parts] == t
    assert all(x is None for x in got[parts:])
