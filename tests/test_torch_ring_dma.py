"""K4, the ring round that moves its own block (``ops/fused_rotation.
fused_round_dma``), on the CPU through its plain version, against the JAX
package.

- The merged carry equals the JAX package's Pallas ``fused_block_merge``
  (interpret mode) on the same operands, on f32, bf16 and int8 wires, and
  the landing buffers hold the predecessor's block, ids and scales.
- The ring's ``"dma"`` form over P = 1–4 logical ranks equals the JAX
  ring (``ring_fusion="xla"`` on its virtual CPU mesh) bit for bit.

The rows are integers in [−127, 127] over 16, each with one entry at
±127/16: every product and sum is exact in f32, every value exact in bf16,
and int8 quantization is lossless, so every comparison is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.ops.pallas_ring import fused_block_merge as jax_merge
from mpi_knn_tpu.ops.quant import quantize_rows as jax_quantize
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch.backends import ring
from mpi_knn_tpu_torch.ops import fused_rotation

Q_LOCAL, B, DIM, Q_TILE, C_TILE = 32, 64, 12, 8, 16
# wire -> (policy, k) of a JAX config whose merge is K3a's exact body
# (int8 needs the mixed policy, at a k whose overfetch fills the tile)
WIRES = {None: ("exact", 5), "bfloat16": ("exact", 5), "int8": ("mixed", 4)}


def _rows(rng, n):
    x = rng.integers(-127, 128, (n, DIM)).astype(np.float32)
    x[np.arange(n), rng.integers(0, DIM, n)] = 127.0
    return x / 16


def _rank(rng, k, rank):
    """One rank's operands: permuted block ids with −1 padding, a query
    whose own id is in the block, a duplicate of a query row, and a carry
    whose distances tie block entries under lower ids."""
    q, blk = _rows(rng, Q_LOCAL), _rows(rng, B)
    blk[21] = q[2]
    bids = (rng.permutation(1000)[:B] + 100 + 1000 * rank).astype(np.int32)
    bids[-6:] = -1
    qids = np.arange(Q_LOCAL, dtype=np.int32) + 5000 + 100 * rank
    qids[5] = bids[40]
    d = ((q[:, None].astype(np.float64) - blk[None]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    cd = np.take_along_axis(d, order[:, 1:1 + k], 1).astype(np.float32)
    ci = rng.integers(0, 100, (Q_LOCAL, k)).astype(np.int32)
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


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("P", [1, 2, 3])
def test_round_reference_merges_as_jax_and_lands_the_predecessor(wire, P):
    policy, k = WIRES[wire]
    rng = np.random.default_rng(P)
    jcfg = jax_pkg.KNNConfig(k=k, precision_policy=policy,
                             ring_transfer_dtype=wire)
    t = torch.from_numpy
    ranks, want = [], []
    for r in range(P):
        q, qids, blk, bids, cd, ci = _rank(rng, k, r)
        jblk, jscl, pblk, pscl = _wire(blk, wire)
        want.append(jax_merge(q, qids, jblk, bids, jscl, cd, ci, cfg=jcfg,
                              q_tile=Q_TILE, c_tile=C_TILE))
        ranks.append((t(q), t(qids), (pblk, t(bids), pscl), (t(cd), t(ci))))
    blocks = [rk[2] for rk in ranks]
    landing = [fused_rotation.slot(fused_rotation.landing_slots(*b), 1)
               for b in blocks]
    got = fused_rotation.fused_round_dma(
        fused_rotation.ring_transport(["cpu"] * P), [rk[0] for rk in ranks],
        [rk[1] for rk in ranks], blocks, [rk[3] for rk in ranks], landing,
        c_tile=C_TILE)
    for r in range(P):
        np.testing.assert_array_equal(got[r][1].numpy(), np.asarray(want[r][1]))
        np.testing.assert_array_equal(got[r][0].numpy(), np.asarray(want[r][0]))
        for have, sent in zip(landing[(r + 1) % P], blocks[r]):
            assert (have is None) == (sent is None)
            if sent is not None:
                assert torch.equal(have, sent)
    # the planted cases really were exercised
    ids0 = got[0][1].numpy()
    assert blocks[0][1][40].item() not in ids0[5]      # self by id
    assert (ids0[:, :1] < 100).any()                   # the carry won ties


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_dma_form_ring_equals_jax(P, wire):
    rng = np.random.default_rng(3)
    X = rng.integers(-127, 128, (96, DIM)).astype(np.float32)
    X[np.arange(96), np.arange(96) % DIM] = 127.0
    X /= 16
    X[16] = X[48]
    kw = dict(k=3 if P % 2 == 0 else 5, num_devices=P, query_tile=8,
              corpus_tile=16, center=False, ring_transfer_dtype=wire)
    want = jax_pkg.all_knn(X, backend="ring-overlap", ring_fusion="xla", **kw)
    cfg = KNNConfig(backend="ring-overlap", ring_fusion="fused", **kw)
    fused_rotation.reset_launch_counts()
    d, i = ring.all_knn_ring(X, X, np.arange(96, dtype=np.int32), cfg,
                             device="cpu", form="dma")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want.dists))
    assert fused_rotation.LAUNCHES == {"fused_round_dma": 0,
                                       "fused_rotation_grid": 0,
                                       "fused_round_dma[default]": 0,
                                       "fused_rotation_grid[default]": 0,
                                       "fused_round_dma[high]": 0,
                                       "fused_rotation_grid[high]": 0,
                                       "stage_tf32_split[ring]": 0}


CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("cfg_kw,devices,form", [
    (dict(ring_fusion="fused"), [CARD] * 4, "dma"),
    (dict(ring_fusion="fused", ring_transfer_dtype="bfloat16"), [CARD] * 2,
     "dma"),
    (dict(ring_fusion="fused", ring_fused_rotation="grid"), [CARD] * 4, "grid"),
    (dict(ring_fusion="fused"), ["cpu"] * 4, "driver"),
    (dict(ring_fusion="fused", ring_schedule="bidir"), [CARD] * 4, "driver"),
    (dict(ring_fusion="fused", precision_policy="mixed"), [CARD] * 4, "driver"),
    (dict(ring_fusion="xla"), [CARD] * 4, "driver"),
])
def test_ring_form_follows_the_reference_rule(cfg_kw, devices, form):
    """The JAX package's fused_dma rule (backends/ring.py:211-217, 429),
    with "every rank on a CUDA card" for "on a TPU"."""
    assert ring.ring_form(KNNConfig(**cfg_kw), devices) == form


def test_transport_maps_ranks_to_cards():
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    t = fused_rotation.RingTransport([c0, c0, c1, c1])
    assert t.cards == [c0, c1] and t.local == {c0: [0, 1], c1: [2, 3]}
    assert t.succ_remote == [False, True, False, True]
    assert t.pred_remote == [True, False, True, False]
    one = fused_rotation.RingTransport([c0] * 4)
    assert one.cards == [c0] and not any(one.succ_remote + one.pred_remote)
    forced = fused_rotation.RingTransport([c0] * 2, cross_card=[True, True])
    assert forced.succ_remote == forced.pred_remote == [True, True]
    assert fused_rotation.ring_transport([c0] * 4) is \
        fused_rotation.ring_transport([c0] * 4)


def test_round_refuses_bad_landing_buffers():
    rng = np.random.default_rng(0)
    q, qids, blk, bids, cd, ci = _rank(rng, 5, 0)
    t = torch.from_numpy
    block = (t(blk), t(bids), None)
    bad = (t(blk).to(torch.bfloat16), t(bids), None)
    with pytest.raises(ValueError, match="landing"):
        fused_rotation.fused_round_dma(
            fused_rotation.ring_transport(["cpu"]), [t(q)], [t(qids)], [block],
            [(t(cd), t(ci))], [bad], c_tile=C_TILE)


@pytest.mark.parametrize("P", [1, 3])
def test_round_reference_ignores_the_planes_and_lands_them(P):
    """A traveler carrying K4's prologue planes and norms (f32 wire) goes
    through the plain round, which reads neither: the merged carry is the
    JAX package's Pallas merge, and the landing slots hold the block, ids,
    norms and planes of the predecessor."""
    k = 5
    rng = np.random.default_rng(10 + P)
    jcfg = jax_pkg.KNNConfig(k=k)
    t = torch.from_numpy
    ranks, want = [], []
    for r in range(P):
        q, qids, blk, bids, cd, ci = _rank(rng, k, r)
        want.append(jax_merge(q, qids, blk, bids, None, cd, ci, cfg=jcfg,
                              q_tile=Q_TILE, c_tile=C_TILE))
        hi, lo, norms = fused_rotation.stage_round_planes(t(blk))
        ranks.append((t(q), t(qids), (t(blk), t(bids), None, norms, hi, lo),
                      (t(cd), t(ci))))
    blocks = [rk[2] for rk in ranks]
    landing = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
               for b in blocks]
    got = fused_rotation.fused_round_dma(
        fused_rotation.ring_transport(["cpu"] * P), [rk[0] for rk in ranks],
        [rk[1] for rk in ranks], blocks, [rk[3] for rk in ranks], landing,
        c_tile=C_TILE)
    for r in range(P):
        np.testing.assert_array_equal(got[r][1].numpy(), np.asarray(want[r][1]))
        np.testing.assert_array_equal(got[r][0].numpy(), np.asarray(want[r][0]))
        have, sent = landing[(r + 1) % P], blocks[r]
        assert have[2] is None
        for part in (0, 1, 3, 4, 5):
            assert torch.equal(have[part], sent[part])


def test_round_planes_are_the_plain_split():
    """K4's prologue on the CPU is the plain split: planes at pitch
    split_width(d), zero past d, hi + lo = x up to the dropped bits of lo
    (2^-21 of x), and the f32 norms."""
    from mpi_knn_tpu_torch.ops import fused_knn

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((40, 20)).astype(np.float32))
    hi, lo, norms = fused_rotation.stage_round_planes(x)
    want = fused_knn.stage_tf32_split_reference(x, fused_knn.split_width(20))
    assert hi.shape == lo.shape == (40, 32)
    for g, w in zip((hi, lo, norms), want):
        assert torch.equal(g, w)
    assert bool(((hi[:, :20] + lo[:, :20] - x).abs() <= 2.0 ** -21 * x.abs()).all())
    assert not hi[:, 20:].any() and not lo[:, 20:].any()
    with pytest.raises(TypeError):
        fused_rotation.stage_round_planes(x.to(torch.bfloat16))


@pytest.mark.parametrize("precision", ["default", "high"])
def test_staged_parts_carry_bf16_planes_at_default_and_high(precision):
    """At "default" / "high" the dma form on the f32 wire reads K4's planes
    beside the norms (the bf16 wgmma tile), the grid form and the bf16 wire
    the norms alone; the travelers then carry the bf16 planes of the plain
    prologue, zero past d, with no lo plane at "default"."""
    from mpi_knn_tpu_torch.ops import fused_knn

    cfg = KNNConfig(k=5, ring_fusion="fused", matmul_precision=precision)
    assert ring.staged_parts(cfg, "dma", C_TILE, torch.float32) == ("norms", "planes")
    assert ring.staged_parts(cfg, "grid", C_TILE, torch.float32) == ("norms",)
    assert ring.staged_parts(cfg, "dma", C_TILE, torch.bfloat16) == ("norms",)
    rng = np.random.default_rng(7)
    t = torch.from_numpy
    ts = []
    for r in range(2):
        _, _, blk, bids, _, _ = _rank(rng, 5, r)
        ts.append((t(blk), t(bids), None))
    for (blk, bids, _), trav in zip(ts, ring.stage_travelers(("norms", "planes"), ts,
                                                             precision)):
        hi, lo, norms = fused_knn.stage_planes_reference(
            blk, precision, fused_knn.staged_width(DIM))
        assert trav[0] is blk and trav[1] is bids and trav[2] is None
        assert trav[4].dtype == torch.bfloat16 and trav[4].shape == (B, 32)
        assert torch.equal(trav[4], hi) and torch.equal(trav[3], norms)
        assert (trav[5] is None) == (precision == "default")
        if lo is not None:
            assert torch.equal(trav[5], lo)
        assert not trav[4][:, DIM:].any()


@pytest.mark.parametrize("precision", ["default", "high"])
@pytest.mark.parametrize("P", [1, 3])
def test_round_reference_ignores_the_bf16_planes_and_lands_them(precision, P):
    """A traveler carrying the "default" / "high" prologue's bf16 planes
    and norms goes through the plain round, which reads neither: the merged
    carry is the JAX package's Pallas merge at that precision, and the
    landing slots hold the predecessor's block, ids, norms and planes (no
    lo slot at "default")."""
    k = 5
    rng = np.random.default_rng(20 + P)
    jcfg = jax_pkg.KNNConfig(k=k, matmul_precision=precision)
    t = torch.from_numpy
    ranks, want = [], []
    for r in range(P):
        q, qids, blk, bids, cd, ci = _rank(rng, k, r)
        want.append(jax_merge(q, qids, blk, bids, None, cd, ci, cfg=jcfg,
                              q_tile=Q_TILE, c_tile=C_TILE))
        hi, lo, norms = fused_rotation.stage_ring_planes(t(blk), precision)
        ranks.append((t(q), t(qids), (t(blk), t(bids), None, norms, hi, lo),
                      (t(cd), t(ci))))
    blocks = [rk[2] for rk in ranks]
    landing = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
               for b in blocks]
    got = fused_rotation.fused_round_dma(
        fused_rotation.ring_transport(["cpu"] * P), [rk[0] for rk in ranks],
        [rk[1] for rk in ranks], blocks, [rk[3] for rk in ranks], landing,
        c_tile=C_TILE, precision=precision)
    for r in range(P):
        np.testing.assert_array_equal(got[r][1].numpy(), np.asarray(want[r][1]))
        np.testing.assert_array_equal(got[r][0].numpy(), np.asarray(want[r][0]))
        have, sent = landing[(r + 1) % P], blocks[r]
        assert have[2] is None and (have[5] is None) == (precision == "default")
        for part in (0, 1, 3, 4, 5):
            if sent[part] is not None:
                assert torch.equal(have[part], sent[part])


@pytest.mark.parametrize("precision", ["default", "high"])
def test_a_staged_ring_stages_its_queries_alone(monkeypatch, precision):
    """Travelers staged once (as a resident ring index stages its shards)
    are taken as they are: a dma ring over them runs K4's prologue on its
    query shards only, and equals the driver-transport ring bit for bit."""
    from mpi_knn_tpu_torch.ops.topk import init_topk

    rng = np.random.default_rng(9)
    X = np.concatenate([_rows(rng, 48), _rows(rng, 40)])
    ids = np.arange(X.shape[0], dtype=np.int32)
    devices = [torch.device("cpu")] * 4
    cfg = KNNConfig(k=5, backend="ring-overlap", ring_fusion="fused",
                    query_tile=8, corpus_tile=16, center=False,
                    matmul_precision=precision)
    q_tile, c_tile, q_sh, qid_sh, travelers = ring.ring_shards(cfg, X, X, ids, devices)
    parts = ring.staged_parts(cfg, "dma", c_tile, torch.float32)
    shards = ring.stage_travelers(parts, travelers[0], precision)
    staged = []
    real = ring.stage_ring_planes
    monkeypatch.setattr(ring, "stage_ring_planes",
                        lambda rows, p=None: staged.append(rows) or real(rows, p))
    carries = [init_topk(q.shape[0], cfg.k, device="cpu") for q in q_sh]
    run = ring.RingRun(cfg, devices, True, "dma", q_sh, qid_sh, [shards], carries,
                       q_tile, c_tile, staged=True)
    run.rotate()
    assert [r.data_ptr() for r in staged] == [q.data_ptr() for q in q_sh]
    want = ring.all_knn_ring(X, X, ids, cfg, mesh=devices, device="cpu", form="driver")
    n = X.shape[0]
    assert torch.equal(torch.cat([c[1] for c in run.carries])[:n], want[1])
    assert torch.equal(torch.cat([c[0] for c in run.carries])[:n], want[0])
