"""The CUDA kernels against their plain versions on the card. These need a
CUDA device and nvcc; they skip elsewhere. On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

The data are multiples of 1/16 or 1/4 small enough that every product and
sum is exact in f32 and every value is exact in bf16, and rows whose
largest magnitude is 127/16 quantize to int8 without loss: kernel and plain
version must then agree bit for bit, ids, positions and distances.
"""

import numpy as np
import pytest
import torch

from mpi_knn_tpu_torch.ops import fused_knn, fused_ring, fused_rotation
from mpi_knn_tpu_torch.ops.quant import quantize_rows


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _same(got, want):
    assert torch.equal(torch.nan_to_num(got, posinf=-1.0),
                       torch.nan_to_num(want, posinf=-1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("k", [10, 150])  # 150: lists kept in the output
@pytest.mark.parametrize("compress", [False, True])
def test_kernel_equals_plain_on_small_integers(cuda_device, name, all_pairs,
                                               k, compress):
    rng = np.random.default_rng(0)
    X = torch.from_numpy((rng.integers(0, 8, (512, 32)) * 0.25).astype(np.float32))
    X[5] = X[60]
    Q = X if all_pairs else X[:128] + 0.25
    Q, X = Q.to(cuda_device), X.to(cuda_device)
    kern = getattr(fused_knn, name)
    plain = getattr(fused_knn, name + "_reference")
    key = name + ("[compress]" if compress else "")
    before = fused_knn.LAUNCHES[key]
    gd, gi = kern(Q, X, 500, k, 128, 256, all_pairs=all_pairs,
                  compress=compress)
    torch.cuda.synchronize()
    wd, wi = plain(Q, X, 500, k, 128, 256, all_pairs=all_pairs,
                   compress=compress)
    assert fused_knn.LAUNCHES[key] == before + 1
    assert torch.equal(gi, wi)
    _same(gd, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("dim", [24, 33, 100])
@pytest.mark.parametrize("ov", [10, 40, 150])  # 150: lists kept in the output
def test_compress_kernels_equal_plain_on_ragged_shapes(cuda_device, name,
                                                       all_pairs, dim, ov):
    """The bf16 tensor-core tile at shapes off its 128 x 128 CTA tile and
    its 32-deep slices: 450 corpus rows (10 of them padding), 450 or 200
    query rows, widths padded to 32, 64 and 128; in query mode a NaN query
    row, which the kernel must poison as the plain version does."""
    rng = np.random.default_rng(3)
    X = np.zeros((450, dim), np.float32)
    X[:440] = rng.integers(0, 8, (440, dim)) * 0.25
    X[5] = X[60]
    Q = X if all_pairs else X[:200] + 0.25
    if not all_pairs:
        Q[9] = np.nan
    Q = torch.from_numpy(np.ascontiguousarray(Q)).to(cuda_device)
    X = torch.from_numpy(X).to(cuda_device)
    args = (Q, X, 440, ov, 9 if all_pairs else 8, 150)
    gd, gi = getattr(fused_knn, name)(*args, all_pairs=all_pairs, compress=True)
    torch.cuda.synchronize()
    wd, wi = getattr(fused_knn, name + "_reference")(*args, all_pairs=all_pairs,
                                                   compress=True)
    assert torch.equal(gi, wi)
    _same(gd, wd)
    if not all_pairs:
        assert bool(torch.isnan(gd[9]).all()) and bool((gi[9] == -1).all())
        assert bool(torch.isfinite(gd[10, :ov]).all())


@pytest.mark.cuda
def test_compress_wrappers_count_stage_launches(cuda_device):
    """Each compress call stages its two row sets once (two prologue
    launches) and launches its kernel once."""
    fused_knn.reset_launch_counts()
    fused_ring.reset_launch_counts()
    X = torch.from_numpy((np.random.default_rng(4).integers(0, 8, (256, 40))
                          * 0.25).astype(np.float32)).to(cuda_device)
    fused_knn.fused_knn_tiles(X, X, 256, 8, 128, 128, compress=True)
    fused_knn.fused_knn_sweep(X, X, 256, 8, 128, 128, compress=True)
    q, qids, blk, bids, scale = _ring_operands(cuda_device, "int8")
    fused_ring.block_merge_compress(q, qids, blk, bids, scale, ov=12,
                                    c_tile=128)
    torch.cuda.synchronize()
    assert fused_knn.LAUNCHES == {
        "fused_knn_tiles": 0, "fused_knn_sweep": 0,
        "fused_knn_tiles[compress]": 1, "fused_knn_sweep[compress]": 1,
        "stage_bf16": 4}
    assert fused_ring.LAUNCHES == {"fused_block_merge[exact]": 0,
                                   "fused_block_merge[compress]": 1,
                                   "stage_bf16[wire]": 2}


def _ring_operands(device, wire, q_local=96, b=256, dim=24, seed=0):
    """Queries, ids, a wire block with permuted ids and -1 padding, a
    duplicate of a query, a query whose id is in the block, and a carry
    whose distances tie block entries."""
    rng = np.random.default_rng(seed)

    def rows(n):
        x = rng.integers(-127, 128, (n, dim)).astype(np.float32)
        x[np.arange(n), rng.integers(0, dim, n)] = 127.0
        return x / 16

    q, blk = rows(q_local), rows(b)
    blk[17] = q[4]                     # a duplicate row
    bids = rng.permutation(10 * b)[:b].astype(np.int32)
    bids[-9:] = -1                     # padding
    qids = np.arange(q_local, dtype=np.int32) + 5000
    qids[7] = bids[30]                 # self by id
    qt = torch.from_numpy(q).to(device)
    bt = torch.from_numpy(blk).to(device)
    scale = None
    if wire == "int8":
        bt, scale = quantize_rows(bt)
    elif wire == "bfloat16":
        bt = bt.to(torch.bfloat16)
    return (qt, torch.from_numpy(qids).to(device), bt,
            torch.from_numpy(bids).to(device), scale)


def _carry(q, blk, bids, k):
    """A carry of real block distances under other ids, so ties with the
    block's own entries happen."""
    d = ((q.double()[:, None] - blk.double()[None]) ** 2).sum(-1).float()
    cd, pos = torch.sort(d, dim=1, stable=True)
    cd = cd[:, 3:3 + k].contiguous()
    ci = (bids[pos[:, 3:3 + k]] + 20000).to(torch.int32).contiguous()
    return cd, ci


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [10, 150])
def test_block_merge_exact_equals_plain(cuda_device, wire, k):
    q, qids, blk, bids, scale = _ring_operands(cuda_device, wire)
    q[9] = float("nan")
    rows = blk.float() if scale is None else blk.float() * scale[:, None]
    cd, ci = _carry(q, rows, bids, k)
    before = fused_ring.LAUNCHES["fused_block_merge[exact]"]
    got = fused_ring.block_merge_exact(q, qids, blk, bids, scale, cd, ci,
                                       c_tile=64)
    torch.cuda.synchronize()
    want = fused_ring.block_merge_exact_reference(q, qids, blk, bids, scale,
                                                  cd, ci, c_tile=64)
    assert fused_ring.LAUNCHES["fused_block_merge[exact]"] == before + 1
    assert torch.equal(got[1], want[1])
    _same(got[0], want[0])
    assert bool(torch.isnan(got[0][9]).all()) and bool((got[1][9] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("backend,fusion,schedule,policy,wire", [
    ("ring-overlap", "fused", "uni", "exact", None),
    ("ring-overlap", "fused", "bidir", "mixed", "int8"),
    ("ring-overlap", "xla", "bidir", "exact", "bfloat16"),
    ("ring", "xla", "uni", "mixed", None),
])
def test_ring_across_cards_equals_one_shared_card(cuda_device, backend, fusion,
                                                  schedule, policy, wire):
    """The blocks really move between cards (side streams under overlap):
    the result must equal, bit for bit, the same ring on one card named
    once per rank, where no bytes move."""
    from mpi_knn_tpu_torch import all_knn
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs at least two cards")
    rng = np.random.default_rng(1)
    X = (rng.standard_normal((3000, 64)) * 3.0).astype(np.float32)
    kw = dict(k=10, backend=backend, ring_fusion=fusion,
              ring_schedule=schedule, precision_policy=policy,
              ring_transfer_dtype=wire, query_tile=128, corpus_tile=256)
    spread = all_knn(X, mesh=make_ring_mesh(cards), **kw)
    shared = all_knn(X, mesh=make_ring_mesh(devices=[cuda_device] * cards),
                     **kw)
    assert torch.equal(spread.ids, shared.ids)
    assert torch.equal(spread.dists, shared.dists)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ov", [10, 40, 150, 200])  # > 128: a global scratch
@pytest.mark.parametrize("dim", [24, 33, 100])
def test_block_merge_compress_equals_plain(cuda_device, wire, ov, dim):
    """K3b on the bf16 tensor-core tile: 200 query rows and 450-row blocks
    (off its 128 x 128 CTA tile), widths padded to 32, 64 and 128, every
    wire, and a NaN query row, whose keys count as +inf: its positions are
    each tile's first ov columns in order, as in the plain version."""
    q, qids, blk, bids, scale = _ring_operands(cuda_device, wire, q_local=200,
                                               b=450, dim=dim)
    q[9] = float("nan")
    before = fused_ring.LAUNCHES["fused_block_merge[compress]"]
    got = fused_ring.block_merge_compress(q, qids, blk, bids, scale, ov=ov,
                                          c_tile=225)
    torch.cuda.synchronize()
    want = fused_ring.block_merge_compress_reference(q, qids, blk, bids,
                                                     scale, ov=ov, c_tile=225)
    assert fused_ring.LAUNCHES["fused_block_merge[compress]"] == before + 1
    assert got.shape == (2, 200, ov) and torch.equal(got, want)
    first = torch.arange(ov, dtype=torch.int32, device=cuda_device)
    assert torch.equal(got[:, 9], first.expand(2, ov))


def _ring_of(device, P, wire, q_local=96, b=256, dim=24, k=10):
    """P ranks' operands on one card: queries, ids, a traveler each and a
    carry that ties block entries."""
    queries, qids, blocks, carries = [], [], [], []
    for r in range(P):
        q, qi, blk, bids, scale = _ring_operands(device, wire, q_local, b, dim,
                                                 seed=10 + r)
        rows = blk.float() if scale is None else blk.float() * scale[:, None]
        queries.append(q)
        qids.append(qi)
        blocks.append((blk, bids, scale))
        carries.append(_carry(q, rows, bids, k))
    return queries, qids, blocks, carries


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("cross", [False, True])
def test_round_dma_equals_plain(cuda_device, wire, P, cross):
    """K4 on one card named P times (P=1: the block copied to itself);
    ``cross`` runs the cross-card barrier and flags within the card."""
    queries, qids, blocks, carries = _ring_of(cuda_device, P, wire)
    queries[0][9] = float("nan")
    ring = fused_rotation.RingTransport([cuda_device] * P,
                                        cross_card=[cross] * P)
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
            for b in blocks]
    want_land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
                 for b in blocks]
    before = fused_rotation.LAUNCHES["fused_round_dma"]
    for _ in range(2):  # the flag words count on across rounds
        got = fused_rotation.fused_round_dma(ring, queries, qids, blocks,
                                             carries, land, c_tile=64)
    torch.cuda.synchronize()
    want = fused_rotation.fused_round_dma_reference(
        queries, qids, blocks, carries, want_land, c_tile=64)
    assert fused_rotation.LAUNCHES["fused_round_dma"] == before + 2
    for r in range(P):
        assert torch.equal(got[r][1], want[r][1])
        _same(got[r][0], want[r][0])
        for have, sent in zip(land[(r + 1) % P], blocks[r]):
            assert (have is None) == (sent is None)
            if sent is not None:
                assert torch.equal(have, sent)
    assert bool((got[0][1][9] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("cross", [False, True])
def test_rotation_grid_equals_plain(cuda_device, wire, P, cross):
    queries, qids, blocks, carries = _ring_of(cuda_device, P, wire)
    ring = fused_rotation.RingTransport([cuda_device] * P,
                                        cross_card=[cross] * P)
    slots = [fused_rotation.landing_slots(*b) for b in blocks]
    before = fused_rotation.LAUNCHES["fused_rotation_grid"]
    for _ in range(2):
        got = fused_rotation.fused_rotation_grid(ring, queries, qids, blocks,
                                                 carries, slots, c_tile=64)
    torch.cuda.synchronize()
    want = fused_rotation.fused_rotation_grid_reference(
        queries, qids, blocks, carries,
        [fused_rotation.landing_slots(*b) for b in blocks], c_tile=64)
    assert fused_rotation.LAUNCHES["fused_rotation_grid"] == before + 2
    for r in range(P):
        assert torch.equal(got[r][1], want[r][1])
        _same(got[r][0], want[r][0])


@pytest.mark.cuda
def test_unset_barrier_flag_raises_within_seconds(cuda_device):
    """A barrier whose peer never signals this epoch: the kernel gives up
    after the timeout and the wrapper raises; the ring then works again."""
    import time

    queries, qids, blocks, carries = _ring_of(cuda_device, 2, "float32")
    ring = fused_rotation.RingTransport([cuda_device] * 2,
                                        cross_card=[True, True])
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
            for b in blocks]
    kw = dict(c_tile=64, timeout_s=1.0)
    fused_rotation.fused_round_dma(ring, queries, qids, blocks, carries, land,
                                   **kw)
    ring.epoch += 1  # the next round waits for a signal no peer will send
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fused_round_dma: neighbour "
                       "barrier timed out"):
        fused_rotation.fused_round_dma(ring, queries, qids, blocks, carries,
                                       land, **kw)
    assert time.perf_counter() - t0 < 10.0
    got = fused_rotation.fused_round_dma(ring, queries, qids, blocks, carries,
                                         land, **kw)
    want = fused_rotation.fused_round_dma_reference(
        queries, qids, blocks, carries,
        [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
         for b in blocks], c_tile=64)
    assert torch.equal(got[1][1], want[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("rotation,wire", [
    ("round", None), ("round", "bfloat16"), ("grid", None), ("grid", "bfloat16")])
def test_transport_rings_across_cards_equal_one_card(cuda_device, rotation,
                                                     wire):
    """The dma (K4) and grid (K5) rings across every visible card: the
    cross-card barrier and peer stores. They must equal the same ring on
    one card named once per rank, and the driver-transport K3a ring."""
    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring
    from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs at least two cards")
    rng = np.random.default_rng(2)
    X = (rng.standard_normal((3000, 64)) * 3.0).astype(np.float32)
    cfg = KNNConfig(k=10, backend="ring-overlap", ring_fusion="fused",
                    ring_fused_rotation=rotation, ring_transfer_dtype=wire,
                    query_tile=128, corpus_tile=256, center=False)
    spread = all_knn(X, config=cfg, mesh=make_ring_mesh(cards))
    shared_mesh = make_ring_mesh(devices=[cuda_device] * cards)
    shared = all_knn(X, config=cfg, mesh=shared_mesh)
    driver = all_knn_ring(X, X, np.arange(3000, dtype=np.int32), cfg,
                          mesh=shared_mesh, form="driver")
    for dists, ids in ((shared.dists, shared.ids), driver):
        assert torch.equal(spread.ids, ids)
        assert torch.equal(spread.dists, dists)
