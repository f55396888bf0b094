"""The CUDA kernels against their plain versions on the card. These need a
CUDA device and nvcc; they skip elsewhere. On the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

The data are multiples of 1/16 or 1/4 small enough that every product and
sum is exact in f32 and every value is exact in bf16 (and in TF32, so the
exact tile splits them with lo = 0), and rows whose largest magnitude is
127/16 quantize to int8 without loss: kernel and plain version must then
agree bit for bit, ids, positions and distances. On centered MNIST-like
rows the exact kernels' keys must stay within the error gate of f64, and
each exact prologue's norms must equal its tile's own diagonal: K1/K2's
(``stage_tf32_split``) the wgmma tile's, the ring's (``stage_wire_norms``)
the mma.sync tile's.
"""

import os

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


def _compress_sweep_operands(device, all_pairs, rows=1000, dim=64):
    """Small-integer rows (an exact duplicate pair) padded to 1024, and
    queries: the rows themselves, or 200 others with a NaN row."""
    rng = np.random.default_rng(5)
    X = np.zeros((1024, dim), np.float32)
    X[:rows] = rng.integers(0, 8, (rows, dim)) * 0.25
    X[5] = X[60]
    if all_pairs:
        Q = X
    else:
        Q = np.zeros((256, dim), np.float32)
        Q[:200] = rng.integers(0, 8, (200, dim)) * 0.25
        Q[3] = np.nan
    return (torch.from_numpy(Q).to(device), torch.from_numpy(X).to(device), rows)


def _sweep_compress(Q, X, m, k, slices, all_pairs=True):
    """K2[c] through the wrapper (slices None: the plan's split), or at a
    forced split on the operands the wrapper would stage."""
    if slices is None:
        return fused_knn.fused_knn_sweep(Q, X, m, k, 128, 1024, all_pairs=all_pairs,
                                         compress=True)
    return fused_knn.launch_compress(
        "fused_knn_sweep", fused_knn.stage_bf16_rows(Q), fused_knn.stage_bf16_rows(X),
        m, k, 1024, all_pairs=all_pairs, slices=slices)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [None, 1, 3, 7])
@pytest.mark.parametrize("all_pairs", [True, False])
def test_compress_sweep_equals_plain_at_every_split(cuda_device, all_pairs, slices):
    """K2[c] (the bf16 wgmma tile) on small integers, bit for bit, at the
    plan's corpus split and at forced ones; one launch a call."""
    Q, X, m = _compress_sweep_operands(cuda_device, all_pairs)
    before = fused_knn.LAUNCHES["fused_knn_sweep[compress]"]
    gd, gi = _sweep_compress(Q, X, m, 40, slices, all_pairs)
    torch.cuda.synchronize()
    wd, wi = fused_knn.fused_knn_sweep_reference(Q, X, m, 40, 128, 1024,
                                                 all_pairs=all_pairs, compress=True)
    assert fused_knn.LAUNCHES["fused_knn_sweep[compress]"] == before + 1
    assert torch.equal(gi, wi)
    _same(gd, wd)
    if not all_pairs:
        assert bool(torch.isnan(gd[3]).all()) and bool((gi[3] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 3])
def test_compress_sweep_ov600_equals_plain(cuda_device, slices):
    """ov = 600: the lists live in the output (and scratch) rows."""
    Q, X, m = _compress_sweep_operands(cuda_device, True)
    gd, gi = _sweep_compress(Q, X, m, 600, slices)
    torch.cuda.synchronize()
    wd, wi = fused_knn.fused_knn_sweep_reference(Q, X, m, 600, 128, 1024, compress=True)
    assert torch.equal(gi, wi)
    _same(gd, wd)


@pytest.mark.cuda
def test_compress_sweep_is_split_invariant_on_mnist_shape(cuda_device):
    """MNIST-shaped 8192 x 784, centered: the output at every split equals
    the plan's bit for bit (a key's bits do not depend on its slice)."""
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like

    X, _ = make_mnist_like(8192)
    X = torch.from_numpy(X - X.astype(np.float64).mean(0)).float().to(cuda_device)
    want = _sweep_compress(X, X, 8192, 40, None)
    for slices in (1, 2, 5, 16, 32):
        got = _sweep_compress(X, X, 8192, 40, slices)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]), slices
        _same(got[0], want[0])


@pytest.mark.cuda
def test_compress_sweep_serving_batch_on_a_staged_corpus(cuda_device):
    """A 1024-row query batch against a corpus staged once (the serving
    call): the plan splits the corpus, one query prologue and one kernel
    launch, bit for bit the plain version's."""
    rng = np.random.default_rng(6)
    C = torch.from_numpy((rng.integers(0, 8, (12288, 64)) * 0.25).astype(np.float32))
    C[12000:] = 0.0
    Q = torch.from_numpy((rng.integers(0, 8, (1024, 64)) * 0.25).astype(np.float32))
    C, Q = C.to(cuda_device), Q.to(cuda_device)
    staged = fused_knn.stage_corpus(C, compress=True)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fused_knn.compress_sweep_plan(1024, 12000, sms)["slices"] > 1
    fused_knn.reset_launch_counts()
    gd, gi = fused_knn.fused_knn_sweep(Q, C, 12000, 40, 1024, 2048, all_pairs=False,
                                       compress=True, staged_corpus=staged)
    torch.cuda.synchronize()
    assert fused_knn.LAUNCHES["fused_knn_sweep[compress]"] == 1
    assert fused_knn.LAUNCHES["stage_bf16"] == 1
    wd, wi = fused_knn.fused_knn_sweep_reference(Q, C, 12000, 40, 1024, 2048,
                                                 all_pairs=False, compress=True)
    assert torch.equal(gi, wi)
    _same(gd, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 3])
def test_compress_sweep_tile_products_equal_the_product(cuda_device, slices):
    """K2[c]'s bf16 wgmma tile's raw products of the staged copies: exact on
    small integers, so equal to the f32 product of the copies."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy((rng.integers(0, 8, (300, 70)) * 0.25).astype(np.float32))
    c = torch.from_numpy((rng.integers(0, 8, (700, 70)) * 0.25).astype(np.float32))
    sq = fused_knn.stage_bf16_rows(q.to(cuda_device))
    sc = fused_knn.stage_bf16_rows(c.to(cuda_device))
    got = fused_knn.bf16_tile_dots(sq, sc, slices=slices)
    torch.cuda.synchronize()
    assert torch.equal(got, sq[0].float() @ sc[0].float().T)


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
        "fused_knn_tiles[default]": 0, "fused_knn_sweep[default]": 0,
        "fused_knn_tiles[high]": 0, "fused_knn_sweep[high]": 0,
        "stage_tf32_split": 0, "stage_bf16": 4, "stage_planes": 0,
        "stage_norms": 0}
    assert fused_ring.LAUNCHES == {"fused_block_merge[exact]": 0,
                                   "fused_block_merge[compress]": 1,
                                   "fused_block_merge[default]": 0,
                                   "fused_block_merge[high]": 0,
                                   "stage_tf32[wire]": 0,
                                   "stage_bf16[wire]": 2}


@pytest.mark.cuda
def test_exact_wrappers_count_stage_launches(cuda_device):
    """Each exact call stages the norms of its two row sets once (two
    prologue launches) and launches its kernel once; norms handed in are
    not staged again."""
    fused_knn.reset_launch_counts()
    fused_ring.reset_launch_counts()
    X = torch.from_numpy((np.random.default_rng(4).integers(0, 8, (256, 40))
                          * 0.25).astype(np.float32)).to(cuda_device)
    fused_knn.fused_knn_tiles(X, X, 256, 8, 128, 128)  # all pairs: staged once
    fused_knn.fused_knn_sweep(X[:128] + 0.25, X, 256, 8, 128, 128)
    q, qids, blk, bids, scale = _ring_operands(cuda_device, "int8")
    cd, ci = _carry(q, blk.float() * scale[:, None], bids, 10)
    fused_ring.block_merge_exact(q, qids, blk, bids, scale, cd, ci, c_tile=128)
    fused_ring.block_merge_exact(
        q, qids, blk, bids, scale, cd, ci, c_tile=128,
        query_norms=fused_ring.stage_wire_norms(q, None),
        block_norms=fused_ring.stage_wire_norms(blk, scale))
    torch.cuda.synchronize()
    assert fused_knn.LAUNCHES == {
        "fused_knn_tiles": 1, "fused_knn_sweep": 1,
        "fused_knn_tiles[compress]": 0, "fused_knn_sweep[compress]": 0,
        "fused_knn_tiles[default]": 0, "fused_knn_sweep[default]": 0,
        "fused_knn_tiles[high]": 0, "fused_knn_sweep[high]": 0,
        "stage_tf32_split": 3, "stage_bf16": 0, "stage_planes": 0,
        "stage_norms": 0}
    assert fused_ring.LAUNCHES == {"fused_block_merge[exact]": 2,
                                   "fused_block_merge[compress]": 0,
                                   "fused_block_merge[default]": 0,
                                   "fused_block_merge[high]": 0,
                                   "stage_tf32[wire]": 4,
                                   "stage_bf16[wire]": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("dim", [8, 24, 33, 97, 100, 784])
@pytest.mark.parametrize("k", [1, 10, 64, 65, 150, 200])
def test_exact_kernels_equal_plain_on_ragged_shapes(cuda_device, name,
                                                    all_pairs, dim, k):
    """The wgmma TF32x3 tile at shapes off its 128 x 128 CTA tile and its
    16-float k-block (8, 33, 97: planes padded to 16, 48, 112), list widths
    on both sides of the shared lists (32), the register lists (64) and the
    old shared limit (128), ragged corpus tiles (225 of 450 rows, 10 of
    them padding), and in query mode a NaN query row."""
    rng = np.random.default_rng(5)
    X = np.zeros((450, dim), np.float32)
    X[:440] = rng.integers(0, 8, (440, dim)) * 0.25
    X[5] = X[60]
    Q = X if all_pairs else X[:200] + 0.25
    if not all_pairs:
        Q[9] = np.nan
    Q = torch.from_numpy(np.ascontiguousarray(Q)).to(cuda_device)
    X = torch.from_numpy(X).to(cuda_device)
    args = (Q, X, 440, k, 9 if all_pairs else 8, 225)
    gd, gi = getattr(fused_knn, name)(*args, all_pairs=all_pairs)
    torch.cuda.synchronize()
    wd, wi = getattr(fused_knn, name + "_reference")(*args, all_pairs=all_pairs)
    assert torch.equal(gi, wi)
    _same(gd, wd)
    if not all_pairs:
        assert bool(torch.isnan(gd[9]).all()) and bool((gi[9] == -1).all())


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
@pytest.mark.parametrize("k", [1, 10, 65, 150])
@pytest.mark.parametrize("dim", [24, 33, 100, 784])
def test_block_merge_exact_equals_plain(cuda_device, wire, k, dim):
    """K3a on the TF32x3 tile: 96 query rows and a 256-row block, widths
    off the 16-deep slice, every wire (bf16 and int8 decoded in registers),
    a NaN query row that poisons its row."""
    q, qids, blk, bids, scale = _ring_operands(cuda_device, wire, dim=dim)
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
def test_block_merge_exact_wide_groups_equal_plain(cuda_device):
    """A shard large enough for K3a's 128-row groups (the narrow 64-row
    groups serve shapes that would leave the card's slots empty)."""
    q, qids, blk, bids, scale = _ring_operands(cuda_device, "float32",
                                               q_local=40000, b=384, dim=40)
    plan = fused_ring.exact_plan(torch.float32, 40000, 10)
    assert plan["rows_per_cta"] == 128 and plan["ctas"] == 313
    small = fused_ring.exact_plan(torch.float32, 96, 10)
    assert small["rows_per_cta"] == 64 and small["ctas"] == 2
    cd, ci = _carry(q[:4096], blk.float(), bids, 10)
    cd = torch.cat([cd, cd.new_full((40000 - 4096, 10), float("inf"))])
    ci = torch.cat([ci, ci.new_full((40000 - 4096, 10), -1)])
    got = fused_ring.block_merge_exact(q, qids, blk, bids, scale, cd, ci,
                                       c_tile=128)
    torch.cuda.synchronize()
    want = fused_ring.block_merge_exact_reference(q, qids, blk, bids, scale,
                                                  cd, ci, c_tile=128)
    assert torch.equal(got[1], want[1])
    _same(got[0], want[0])


def _centered_mnist(device, m=2048, seed=0):
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like

    X, _ = make_mnist_like(m, seed=seed)
    Xc = (X - X.astype(np.float64).mean(0)).astype(np.float32)
    return torch.from_numpy(Xc).to(device)


def _rel_err(X, rows, ids, d):
    """|d - d_f64| / (q^2 + c^2) over the finite slots of (rows, ids, d)."""
    fin = torch.isfinite(d) & (ids >= 0)
    q, c = X[rows].double(), X[ids.clamp_min(0).long()].double()
    d64 = ((q - c) ** 2).sum(-1)
    scale = (q ** 2).sum(-1) + (c ** 2).sum(-1)
    return torch.where(fin, (d.double() - d64).abs() / scale,
                       torch.zeros_like(d64)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_keys_within_the_error_gate(cuda_device, seed):
    """Centered MNIST-like rows (not integers, so lo != 0): every key the
    exact sweep and K3a report is within max(5e-7, 2x the plain
    version's) of its f64 distance, relative to q^2 + c^2."""
    X = _centered_mnist(cuda_device, seed=seed)
    n = X.shape[0]
    rows = torch.arange(n, device=cuda_device)[:, None].expand(n, 10)
    gd, gi = fused_knn.fused_knn_sweep(X, X, n, 10, 128, 256)
    wd, wi = fused_knn.fused_knn_sweep_reference(X, X, n, 10, 128, 256)
    torch.cuda.synchronize()
    gate = max(5e-7, 2 * _rel_err(X, rows, wi, wd))
    assert _rel_err(X, rows, gi, gd) <= gate
    ids = torch.arange(n, dtype=torch.int32, device=cuda_device)
    carry = (torch.full((n, 10), float("inf"), device=cuda_device),
             torch.full((n, 10), -1, dtype=torch.int32, device=cuda_device))
    kd, ki = fused_ring.block_merge_exact(X, ids, X, ids, None, *carry, c_tile=256)
    pd, pi = fused_ring.block_merge_exact_reference(X, ids, X, ids, None, *carry,
                                                    c_tile=256)
    gate = max(5e-7, 2 * _rel_err(X, rows, pi, pd))
    assert _rel_err(X, rows, ki, kd) <= gate


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [777, 784])  # rows staged in registers / by cp.async
def test_prologue_norms_equal_the_tiles_diagonal(cuda_device, dim):
    """The ring prologue's norms equal, bit for bit, the mma.sync tile's
    (K3a's, K4's, K5's) own products of each row with itself, wherever the
    row sits in the tile's fragments (rows permuted against the columns)."""
    X = _centered_mnist(cuda_device, m=1000)[:, :dim].contiguous()
    perm = torch.randperm(1000, generator=torch.Generator().manual_seed(0))
    perm = perm.to(cuda_device)
    norms = fused_ring.stage_wire_norms(X, None)
    dots = fused_knn.exact_tile_dots(X, X[perm])
    torch.cuda.synchronize()
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(1000, device=cuda_device)
    assert torch.equal(dots[torch.arange(1000, device=cuda_device), inv], norms)
    assert torch.equal(torch.diagonal(fused_knn.exact_tile_dots(X, X)), norms)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 97, 784])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_norms_equal_the_wgmma_diagonal(cuda_device, dim, seed):
    """K1/K2's prologue norms equal, bit for bit, the wgmma tile's products
    of each row with itself at every row position of a 64-row warpgroup
    and every column of a 128-column chunk: the columns are the rows
    shifted by each of 0..127 positions, and a random permutation."""
    n = 384
    X = _centered_mnist(cuda_device, m=n, seed=seed)[:, :dim].contiguous()
    staged = fused_knn.stage_tf32_split(X)
    rows = torch.arange(n, device=cuda_device)
    perms = [torch.roll(rows, s) for s in range(0, 128, 7)]
    perms.append(torch.randperm(n, generator=torch.Generator().manual_seed(seed))
                 .to(cuda_device))
    for perm in perms:
        cols = tuple(t[perm].contiguous() for t in staged)
        dots = fused_knn.split_tile_dots(staged, cols)
        inv = torch.empty_like(perm)
        inv[perm] = rows
        assert torch.equal(dots[rows, inv], staged[2])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [8, 97, 784])
def test_split_planes_equal_plain(cuda_device, dim):
    """The prologue's planes equal the plain version's bit for bit (NaN
    where it has NaN), zero past d; its norms are within rtol 1e-5 of the
    plain f32 norms, NaN for a NaN row."""
    X = _centered_mnist(cuda_device, m=300)[:, :dim].contiguous()
    X[7] = float("nan")
    X[9, dim // 2] = float("inf")
    hi, lo, norms = fused_knn.stage_tf32_split(X)
    torch.cuda.synchronize()
    wh, wl, wn = fused_knn.stage_tf32_split_reference(X, fused_knn.split_width(dim))
    for got, want in ((hi, wh), (lo, wl)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    fin = torch.isfinite(wn)
    assert bool(((norms - wn).abs()[fin] <= 1e-5 * wn[fin]).all())
    assert bool(torch.isnan(norms[7])) and not bool(torch.isfinite(norms[9]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
def test_exact_duplicates_are_excluded_at_any_fragment_position(cuda_device,
                                                                name):
    """Duplicate pairs planted at rows of many residues mod 64 (a
    warpgroup's rows) against columns of many residues mod 128 (a chunk's
    columns), on non-integer rows: with the zero rule on, each is
    excluded; with it off, the pair's distance is exactly 0."""
    X = _centered_mnist(cuda_device, m=1024, seed=2)
    pairs = [(16 * i + i, 512 + 8 * (3 * i) + i % 8) for i in range(16)]
    pairs += [(300 + 13 * i, 700 + 19 * i) for i in range(12)]
    for a, b in pairs:
        X[b] = X[a]
    n = X.shape[0]
    kern = getattr(fused_knn, name)
    d, i = kern(X, X, n, 10, 128, 256)
    torch.cuda.synchronize()
    if name == "fused_knn_tiles":
        d, i = fused_knn._select(d, i, 10)
    for a, b in pairs:
        assert b not in i[a].tolist() and a not in i[b].tolist()
    d, i = kern(X, X, n, 3, 128, 256, exclude_zero=False)
    if name == "fused_knn_tiles":
        d, i = fused_knn._select(d, i, 3)
    for a, b in pairs:
        row = dict(zip(i[a].tolist(), d[a].tolist()))
        assert row.get(b) == 0.0


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
@pytest.mark.parametrize("dim", [24, 100])
def test_round_dma_equals_plain(cuda_device, wire, P, cross, dim):
    """K4 on one card named P times (P=1: the block copied to itself);
    ``cross`` runs the cross-card barrier and flags within the card."""
    queries, qids, blocks, carries = _ring_of(cuda_device, P, wire, dim=dim)
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
@pytest.mark.parametrize("dim", [24, 100])
def test_rotation_grid_equals_plain(cuda_device, wire, P, cross, dim):
    queries, qids, blocks, carries = _ring_of(cuda_device, P, wire, dim=dim)
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


def _k2_at_interval(X, define, k=10):
    """K2 exact and its prologue's norms from a build of csrc/fused_knn.cu
    with the preprocessor ``define`` (a promotion interval of the wgmma
    tile), all pairs of X."""
    from mpi_knn_tpu_torch.ops import _build

    lib = fused_knn.configure(_build.load("fused_knn", (define,)))
    n, d = X.shape
    width = fused_knn.split_width(d)
    hi, lo = (torch.empty((n, width), device=X.device) for _ in range(2))
    norms = torch.empty(n, device=X.device)
    out_d = torch.empty((n, k), device=X.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=X.device)
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.stage_tf32_split_launch(X.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                       norms.data_ptr(), n, d, width, stream) == 0
    planes = [t.data_ptr() for t in (hi, lo, norms)] * 2
    assert lib.fused_knn_sweep_launch(*planes, out_d.data_ptr(), out_i.data_ptr(),
                                      n, n, width, n, k, 1, 1, 1, 0.0, stream) == 0
    return (out_d, out_i), norms


@pytest.mark.cuda
def test_wgmma_8deep_equals_mma_sync_merge(cuda_device):
    """The wgmma tile promoted every 8-deep k-step (K2 built with
    KNN_WGMMA_PROMOTE=1) and the mma.sync Tf32x3 tile (K3a at P=1, an
    all-+inf carry: the same all-pairs sweep) give the same distances and
    ids bit for bit on centered MNIST-like rows at the main shape, and the
    two prologues (stage_tf32_split at that interval, stage_tf32[wire])
    the same norms: K4 may run the wgmma tile while the ring's bitwise
    checks against K3a and K5 stand."""
    X = _centered_mnist(cuda_device, m=60000)
    n, k = X.shape[0], 10
    (wd, wi), w_norms = _k2_at_interval(X, "KNN_WGMMA_PROMOTE=1", k)
    ids = torch.arange(n, dtype=torch.int32, device=cuda_device)
    carry = (torch.full((n, k), float("inf"), device=cuda_device),
             torch.full((n, k), -1, dtype=torch.int32, device=cuda_device))
    md, mi = fused_ring.block_merge_exact(X, ids, X, ids, None, *carry, c_tile=n)
    m_norms = fused_ring.stage_wire_norms(X, None)
    torch.cuda.synchronize()
    diff = {"norms": int((w_norms != m_norms).sum()),
            "ids": int((wi != mi).sum()), "dists": int((wd != md).sum())}
    print("wgmma 8-deep vs mma.sync, differing elements:", diff)
    assert diff == {"norms": 0, "ids": 0, "dists": 0}


def _mnist_ring(device, P, dim, q_local=300, b=512, k=10, seed=5):
    """P ranks of centered MNIST-like rows (not integers, so the planes' lo
    parts are not 0) cut to ``dim`` columns: queries, ids, an f32 traveler
    staged as the ring driver stages it for K4 (norms and planes), and a
    carry of real distances under ids of rows outside the block."""
    X = _centered_mnist(device, m=P * (q_local + b) + 64, seed=seed)[:, :dim]
    queries, qids, blocks, carries, q_staged = [], [], [], [], []
    for r in range(P):
        q0 = r * (q_local + b)
        q = X[q0:q0 + q_local].contiguous()
        blk = X[q0 + q_local:q0 + q_local + b].contiguous()
        ids = torch.arange(q0, q0 + q_local, dtype=torch.int32, device=device)
        bids = torch.arange(q0 + q_local, q0 + q_local + b, dtype=torch.int32,
                            device=device)
        bids[-5:] = -1
        hi, lo, norms = fused_rotation.stage_round_planes(blk)
        extra = X[-64:]
        cd = ((q.double()[:, None] - extra.double()[None]) ** 2).sum(-1)
        cd, pos = torch.sort(cd.float(), dim=1, stable=True)
        carries.append((cd[:, 2:2 + k].contiguous(),
                        (pos[:, 2:2 + k] + 900000).to(torch.int32).contiguous()))
        queries.append(q)
        qids.append(ids)
        blocks.append((blk, bids, None, norms, hi, lo))
        q_staged.append(fused_rotation.stage_round_planes(q))
    return queries, qids, blocks, carries, q_staged


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("dim", [96, 784])
def test_round_dma_wgmma_equals_plain_tie_aware(cuda_device, P, dim):
    """K4's f32 form (the wgmma tile) against its plain version on
    non-integer rows: each id judged by its own f64 distance (in the plain
    version's list, or tied with its k-th), each distance within the exact
    error gate of that f64 distance, relative to q^2 + c^2."""
    queries, qids, blocks, carries, q_staged = _mnist_ring(cuda_device, P, dim)
    ring = fused_rotation.RingTransport([cuda_device] * P)
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0) for b in blocks]
    got = fused_rotation.fused_round_dma(
        ring, queries, qids, blocks, carries, land, c_tile=64,
        query_norms=[s[2] for s in q_staged], query_planes=[s[:2] for s in q_staged])
    torch.cuda.synchronize()
    want = fused_rotation.fused_round_dma_reference(
        queries, qids, blocks, carries,
        [fused_rotation.slot(fused_rotation.landing_slots(*b), 0) for b in blocks],
        c_tile=64)
    for r in range(P):
        (gd, gi), (wd, wi) = got[r], want[r]
        q, (blk, bids) = queries[r].double(), blocks[r][:2]
        from_block = torch.isin(gi, bids[bids >= 0])
        # the block's ids are consecutive: id - bids[0] is the row
        rows = blk[(gi - bids[0]).clamp(0, blk.shape[0] - 1).long()].double()
        exact = ((q[:, None] - rows) ** 2).sum(-1)
        scale = (q ** 2).sum(1, keepdim=True) + (rows ** 2).sum(-1)
        tol = 2 * 5e-7 * scale
        assert torch.equal(gi >= 0, wi >= 0)
        assert bool(((gd.double() - exact).abs() <= tol)[from_block].all())
        own = torch.where(from_block, exact, gd.double())  # carry slots: as carried
        in_set = (gi[:, :, None] == wi[:, None, :]).any(-1)
        tie = own <= wd[:, -1:].double() + tol
        assert bool((in_set | tie)[gi >= 0].all())


def _dup_corpus(m=4096, dim=784, seed=4):
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like

    X, _ = make_mnist_like(m, seed=seed)
    X = X[:, :dim].copy()
    # exact duplicates at many residues of a 64-row warpgroup and a
    # 128-column chunk; a near-twin of row 11 one pixel off by 8
    pairs = [(16 * i + i, 2048 + 8 * (3 * i) + i % 8) for i in range(16)]
    for a, b in pairs:
        X[b] = X[a]
    X[3001] = X[11]
    X[3001, 0] += 8.0
    return (X - X.astype(np.float64).mean(0)).astype(np.float32), pairs


@pytest.mark.cuda
def test_round_dma_ring_equals_k3a_ring_and_resume(cuda_device, tmp_path):
    """On a 4-rank mesh of one card, on MNIST-like rows: the dma ring (K4,
    the wgmma tile) equals the driver-transport K3a ring (the mma.sync tile)
    bit for bit, and a resumed ring (K4 rounds, then K3a's last) equals the
    one-shot dma ring bit for bit."""
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring
    from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable

    X, _ = _dup_corpus()
    ids = np.arange(X.shape[0], dtype=np.int32)
    mesh = [cuda_device] * 4
    cfg = KNNConfig(k=10, backend="ring-overlap", ring_fusion="fused",
                    query_tile=128, corpus_tile=256)
    before = fused_rotation.LAUNCHES["fused_round_dma"]
    dma = all_knn_ring(X, X, ids, cfg, mesh=mesh, form="dma")
    assert fused_rotation.LAUNCHES["fused_round_dma"] == before + 4
    driver = all_knn_ring(X, X, ids, cfg, mesh=mesh, form="driver")
    assert torch.equal(dma[1], driver[1]) and torch.equal(dma[0], driver[0])
    all_knn_ring_resumable(X, X, ids, cfg, mesh=mesh, checkpoint_dir=tmp_path,
                           stop_after_rounds=2)
    d, i = all_knn_ring_resumable(X, X, ids, cfg, mesh=mesh, checkpoint_dir=tmp_path)
    assert torch.equal(i, dma[1]) and torch.equal(d, dma[0])


@pytest.mark.cuda
def test_round_dma_drops_planted_duplicates(cuda_device):
    """The dma ring drops every planted exact duplicate (its distance is 0
    bit for bit: K4's prologue norms are its tile's own diagonal) and keeps
    the near-twin first at d^2 = 64; with the zero rule off, each pair's
    distance is exactly 0."""
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring

    X, pairs = _dup_corpus()
    ids = np.arange(X.shape[0], dtype=np.int32)
    kw = dict(k=10, backend="ring-overlap", ring_fusion="fused", query_tile=128,
              corpus_tile=256)
    d, i = all_knn_ring(X, X, ids, KNNConfig(**kw), mesh=[cuda_device] * 4, form="dma")
    i, d = i.cpu().numpy(), d.cpu().numpy()
    for a, b in pairs:
        assert b not in i[a] and a not in i[b]
    assert i[11][0] == 3001 and i[3001][0] == 11
    twin_tol = 2 * 5e-7 * float((X[[11, 3001]].astype(np.float64) ** 2).sum())
    assert abs(float(d[11][0]) - 64.0) <= twin_tol
    d, i = all_knn_ring(X, X, ids, KNNConfig(exclude_zero=False, **kw),
                        mesh=[cuda_device] * 4, form="dma")
    i, d = i.cpu().numpy(), d.cpu().numpy()
    for a, b in pairs:
        assert dict(zip(i[a].tolist(), d[a].tolist())).get(b) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_round_dma_lands_planes_norms_and_ids(cuda_device, P):
    """Each rank's landing slot holds its predecessor's block, ids, norms
    and planes byte for byte after a K4 round on the f32 wire."""
    queries, qids, blocks, carries, q_staged = _mnist_ring(cuda_device, P, 784)
    ring = fused_rotation.RingTransport([cuda_device] * P)
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 1) for b in blocks]
    before = fused_rotation.LAUNCHES["stage_tf32_split[ring]"]
    fused_rotation.fused_round_dma(
        ring, queries, qids, blocks, carries, land, c_tile=64,
        query_norms=[s[2] for s in q_staged], query_planes=[s[:2] for s in q_staged])
    torch.cuda.synchronize()
    assert fused_rotation.LAUNCHES["stage_tf32_split[ring]"] == before
    for r in range(P):
        have, sent = land[(r + 1) % P], blocks[r]
        for part in (0, 1, 3, 4, 5):
            assert torch.equal(have[part].view(torch.int32), sent[part].view(torch.int32))
        assert have[2] is None


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tiles", "sweep"])
@pytest.mark.parametrize("policy", ["exact", "mixed"])
def test_serve_resident_planes_equal_all_knn(cuda_device, variant, policy):
    """query_knn over a pallas index reads the corpus's planes (or, mixed,
    its bf16 copy, and only that) staged once at build: every batch, ragged
    and across buckets, equals all_knn bit for bit, with one query prologue
    and one kernel launch, and the corpus is never staged again."""
    from mpi_knn_tpu_torch import all_knn, build_index, query_knn

    rng = np.random.default_rng(8)
    X = (rng.standard_normal((3000, 100)) * 3.0).astype(np.float32)
    Q = (rng.standard_normal((300, 100)) * 3.0).astype(np.float32)
    Q[7] = X[42]  # a duplicate: the zero rule drops it
    kw = dict(k=10, backend="pallas", pallas_variant=variant,
              precision_policy=policy, corpus_tile=512, query_bucket=128)
    compress = policy == "mixed"
    stage = "stage_bf16" if compress else "stage_tf32_split"
    kernel = f"fused_knn_{variant}" + ("[compress]" if compress else "")
    fused_knn.reset_launch_counts()
    index = build_index(X, device=cuda_device, **kw)
    torch.cuda.synchronize()
    built = {k: v for k, v in fused_knn.LAUNCHES.items() if v}
    assert built == {stage: 1}
    assert (index.staged.exact is None) == compress
    assert (index.staged.compress is None) != compress
    for n in (1, 100, 128, 129, 300):
        fused_knn.reset_launch_counts()
        got = query_knn(Q[:n], index, device=cuda_device)
        assert {k: v for k, v in fused_knn.LAUNCHES.items() if v} == {
            stage: 1, kernel: 1}
        want = all_knn(X, queries=Q[:n], device=cuda_device, **kw)
        assert torch.equal(got.ids, want.ids.cpu())
        assert torch.equal(got.dists, want.dists.cpu())
    assert 42 not in got.ids[7].tolist()


@pytest.mark.cuda
def test_serve_refuses_a_policy_whose_part_is_not_staged(cuda_device):
    """An index stages the one corpus part its build config reads; a
    per-call config that reads the other part is refused, and one that
    reads the staged part serves, with no prologue launched on the corpus."""
    from mpi_knn_tpu_torch import ServeSession, all_knn, build_index, query_knn

    rng = np.random.default_rng(9)
    X = rng.standard_normal((2000, 64)).astype(np.float32)
    Q = rng.standard_normal((50, 64)).astype(np.float32)
    kw = dict(k=10, backend="pallas", corpus_tile=512, query_bucket=64)
    exact = build_index(X, device=cuda_device, **kw)
    mixed = build_index(X, device=cuda_device, precision_policy="mixed", **kw)
    for index, override in ((exact, dict(precision_policy="mixed")),
                            (mixed, dict(precision_policy="exact")),
                            (mixed, dict(k=200))):  # mixed past its reach
        with pytest.raises(ValueError, match="did not stage at build"):
            query_knn(Q, index, device=cuda_device, **override)
        with pytest.raises(ValueError, match="did not stage at build"):
            ServeSession(index, device=cuda_device, **override)
    fused_knn.reset_launch_counts()
    got = query_knn(Q, exact, device=cuda_device, k=5)
    assert {k: v for k, v in fused_knn.LAUNCHES.items() if v} == {
        "stage_tf32_split": 1, "fused_knn_tiles": 1}
    want = all_knn(X, queries=Q, device=cuda_device, **{**kw, "k": 5})
    assert torch.equal(got.ids, want.ids.cpu())
    assert torch.equal(got.dists, want.dists.cpu())


def _approx_case(name, device):
    """(tensor, k, recall_target, aggregate) of the approx kernel's shapes
    on the main path, its edge rows, widths past shared memory (L = n
    at 20480 and 60000, L = 50048 < n at 100000: two passes), and L = n
    not a multiple of 4 in each plan (the last bins' groups short)."""
    rng = np.random.default_rng(11)
    shapes = {"tile_k10": (1024, 2048, 10, 0.95, True),
              "tile_rerank": (1024, 2048, 40, 0.95, False),
              "stream_k10": (1024, 2176, 10, 0.95, True),
              "stream_rerank": (1024, 2176, 40, 0.95, False),
              "merge_k10": (60416, 384, 10, 0.95, True),
              "k1": (512, 2048, 1, 0.95, True),
              "wide_k120": (64, 20480, 120, 0.99, True),
              "wide_raw": (64, 20480, 120, 0.99, False),
              "full_k128": (16, 60000, 128, 0.999, True),
              "full_raw": (16, 60000, 128, 0.999, False),
              "reduced_k256": (8, 100000, 256, 0.99, True),
              "reduced_raw": (8, 100000, 256, 0.99, False),
              "cta_k40": (64, 8192, 40, 0.99, True),
              "cta_raw": (64, 8192, 40, 0.99, False),
              "odd_warp": (256, 301, 10, 0.95, True),
              "odd_warp_raw": (256, 301, 10, 0.95, False),
              "odd_cta": (64, 1155, 40, 0.95, True),
              "odd_cta_raw": (64, 1155, 40, 0.95, False),
              "odd_two_pass": (16, 20481, 120, 0.99, True),
              "odd_two_pass_raw": (16, 20481, 120, 0.99, False)}
    if name in shapes:
        R, n, k, rt, agg = shapes[name]
        x = rng.standard_normal((R, n)).astype(np.float32)
        return torch.from_numpy(x).to(device), k, rt, agg
    x = rng.integers(0, 4, (64, 2048)).astype(np.float32)  # planted ties
    if name == "inf_padding":
        x[:, 1500:] = np.inf
        x[3] = np.inf
    elif name == "zeros_nan":
        x[1, ::3] = -0.0
        x[2] = 0.0
        x[4, ::5] = np.nan
    return torch.from_numpy(x).to(device), 10, 0.95, name != "ties_raw"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tile_k10", "tile_rerank", "stream_k10",
                                  "stream_rerank", "merge_k10", "k1", "ties",
                                  "ties_raw", "inf_padding", "zeros_nan",
                                  "wide_k120", "wide_raw", "full_k128",
                                  "full_raw", "reduced_k256", "reduced_raw",
                                  "cta_k40", "cta_raw", "odd_warp",
                                  "odd_warp_raw", "odd_cta", "odd_cta_raw",
                                  "odd_two_pass", "odd_two_pass_raw"])
def test_approx_kernel_equals_plain(cuda_device, name):
    from mpi_knn_tpu_torch.ops import approx_topk

    x, k, rt, agg = _approx_case(name, cuda_device)
    before = approx_topk.LAUNCHES["approx_min_k"]
    gv, gp = approx_topk.approx_min_k(x, k, rt, agg)
    torch.cuda.synchronize()
    wv, wp = approx_topk.approx_min_k_reference(x, k, rt, agg)
    assert approx_topk.LAUNCHES["approx_min_k"] == before + 1
    assert torch.equal(gp, wp)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


def _fused_case(name, device):
    """(dists, ids, k, method) of the fused form at the main path's five
    shapes (the serial tile with its (c,) ids, the stream step's carry ||
    tile with (q, c) ids, the pallas merge of 30 x 10 survivors) and its
    edge rows, on a view with a row stride wider than its columns."""
    rng = np.random.default_rng(13)
    shapes = {"tile_k10": (1024, 2048, True, "approx"),
              "tile_rerank": (1024, 2048, True, "approx-rerank"),
              "stream_k10": (1024, 2058, False, "approx"),
              "stream_rerank": (1024, 2058, False, "approx-rerank"),
              "merge_k10": (60416, 300, False, "approx")}
    q, c, flat, method = shapes.get(name, (256, 2058, False, "approx-rerank"))
    x = (rng.standard_normal((q, c + 6)) ** 2).astype(np.float32)
    if name == "ties":
        x = rng.integers(0, 4, x.shape).astype(np.float32)
    elif name == "inf":
        x[:, ::3] = np.inf
        x[5] = np.inf
        x[6, :100] = -np.inf
    elif name == "zeros_nan":
        x[1, ::3] = -0.0
        x[2] = 0.0
        x[4, ::5] = np.nan
        x[7] = np.nan
    ids = rng.permutation(c).astype(np.int32)
    if not flat:
        ids = np.stack([rng.permutation(c).astype(np.int32) for _ in range(4)])
        ids = ids[np.arange(q) % 4]
    d = torch.from_numpy(x).to(device)[:, 3:3 + c]
    return d, torch.from_numpy(ids).to(device), 10, method


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tile_k10", "tile_rerank", "stream_k10",
                                  "stream_rerank", "merge_k10", "ties", "inf",
                                  "zeros_nan"])
def test_fused_approx_kernel_equals_the_chain(cuda_device, name):
    """``smallest_k``'s approximate branches on the card: one launch of the
    fused form, values and ids bit for bit the plain chain's."""
    from mpi_knn_tpu_torch.ops import approx_topk
    from mpi_knn_tpu_torch.ops.topk import smallest_k

    d, ids, k, method = _fused_case(name, cuda_device)
    before = approx_topk.LAUNCHES["approx_min_k"]
    gv, gi = smallest_k(d, ids, k, method=method)
    torch.cuda.synchronize()
    assert approx_topk.LAUNCHES["approx_min_k"] == before + 1
    wv, wi = approx_topk.approx_smallest_k_reference(d, ids, k, method)
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.cuda
def test_approx_kernel_runs_a_width_past_shared_memory(cuda_device):
    """(2, 20480) at k 120, 0.99: L = n = 20480, past the 16384 keys a CTA
    sorts in shared memory; one launch (two passes), the plain version's
    winners."""
    from mpi_knn_tpu_torch.ops import approx_topk

    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 20480)).astype(np.float32))
    x = x.to(cuda_device)
    assert approx_topk.reduction_width(20480, 120, 0.99) == 20480
    before = approx_topk.LAUNCHES["approx_min_k"]
    gv, gp = approx_topk.approx_min_k(x, 120, 0.99)
    torch.cuda.synchronize()
    assert approx_topk.LAUNCHES["approx_min_k"] == before + 1
    wv, wp = approx_topk.approx_min_k_reference(x, 120, 0.99)
    assert torch.equal(gp, wp)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.cuda
def test_cli_runs_a_mat_file_on_the_card(cuda_device, tmp_path):
    """The reference's file layout through the run CLI on the card: the
    saved ids are those of all_knn on the same array, and the approximate
    method launches the bin-minimum kernel once per corpus tile."""
    from mpi_knn_tpu_torch import all_knn
    from mpi_knn_tpu_torch.cli import main
    from mpi_knn_tpu_torch.data.matfile import write_mat
    from mpi_knn_tpu_torch.ops import approx_topk

    rng = np.random.default_rng(12)
    X = rng.integers(0, 255, (3000, 64)).astype(np.float64)
    y = rng.integers(1, 11, 3000).astype(np.float64)
    write_mat(tmp_path / "X.mat", {"train_X": X, "train_labels": y})
    nn = tmp_path / "nn.npz"
    assert main(["--data", str(tmp_path / "X.mat"), "--k", "10", "--loo",
                 "--backend", "pallas", "-q", "--save-neighbors", str(nn)]) == 0
    want = all_knn(X.astype(np.float32), k=10, backend="pallas",
                   device=cuda_device)
    assert np.array_equal(np.load(nn)["ids"], want.ids.cpu().numpy())
    approx_topk.reset_launch_counts()
    assert main(["--data", str(tmp_path / "X.mat"), "--k", "10", "--loo",
                 "--backend", "serial", "--corpus-tile", "1024",
                 "--query-tile", "1024", "--topk-method", "approx", "-q"]) == 0
    assert approx_topk.LAUNCHES["approx_min_k"] == 3 * 3


# ---------------------------------------------------------------------------
# matmul_precision "default" / "high": the f32 tile with bf16 operands
# rounded (one pass) or split into hi + lo (three passes). On the small
# multiples of 1/4 or 1/16 above every value is exact in bf16 (lo = 0) and
# every product and sum exact in f32, so kernel and plain version agree bit
# for bit; on random rows the products hold to the plain version's within
# the sum order's rounding.

PRECISIONS = ["default", "high"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("k", [10, 150])  # 150: lists kept in the output
def test_precision_knn_kernels_equal_plain_on_small_integers(cuda_device, name,
                                                             precision, all_pairs, k):
    rng = np.random.default_rng(20)
    X = torch.from_numpy((rng.integers(0, 8, (512, 36)) * 0.25).astype(np.float32))
    X[5] = X[60]
    X = X.to(cuda_device)
    Q = X if all_pairs else X[:200] + 0.25  # all pairs: one row set, staged once
    if not all_pairs:
        Q[3] = float("nan")
    key = f"{name}[{precision}]"
    before = (fused_knn.LAUNCHES[key], fused_knn.LAUNCHES["stage_norms"])
    args = (Q, X, 500, k, 8, 256)
    got = getattr(fused_knn, name)(*args, all_pairs=all_pairs, precision=precision)
    torch.cuda.synchronize()
    want = getattr(fused_knn, name + "_reference")(*args, all_pairs=all_pairs,
                                                   precision=precision)
    assert fused_knn.LAUNCHES[key] == before[0] + 1
    assert fused_knn.LAUNCHES["stage_norms"] == before[1] + (1 if all_pairs else 2)
    assert torch.equal(got[1], want[1])
    _same(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("dim,k", [(24, 1), (33, 10), (100, 65)])
def test_precision_knn_kernels_on_ragged_shapes(cuda_device, name, precision,
                                                all_pairs, dim, k):
    """K1 / K2 at "default" / "high" (the bf16 wgmma tile on the staged
    planes) off its shapes: widths padded to 32, 64 and 128, corpus tiles
    of 384 columns (a chunk of 256 straddles two), m_corpus ragged (760 of
    768 rows), a duplicate pair (the zero rule), self in all pairs, a NaN
    query row, and multiples of 1/64 up to 300/64, some of 9 significant
    bits, so that "high"'s lo planes are not all zero: x = hi + lo exactly,
    and every product and sum is exact in f32."""
    rng = np.random.default_rng(22)
    X = np.zeros((768, dim), np.float32)
    X[:760] = rng.integers(-300, 301, (760, dim)) / 64.0
    X[5] = X[60] = rng.integers(-127, 128, dim) / 16.0  # exact in bf16: d = 0
    X = torch.from_numpy(X).to(cuda_device)
    Q = X if all_pairs else X[:300] + 0.0625  # all pairs: staged once
    if not all_pairs:
        Q[9] = float("nan")
    args = (Q, X, 760, k, 4, 384)
    key = f"{name}[{precision}]"
    before = (fused_knn.LAUNCHES[key], fused_knn.LAUNCHES["stage_planes"])
    gd, gi = getattr(fused_knn, name)(*args, all_pairs=all_pairs, precision=precision)
    torch.cuda.synchronize()
    wd, wi = getattr(fused_knn, name + "_reference")(*args, all_pairs=all_pairs,
                                                   precision=precision)
    assert fused_knn.LAUNCHES[key] == before[0] + 1
    assert fused_knn.LAUNCHES["stage_planes"] == before[1] + (1 if all_pairs else 2)
    assert torch.equal(gi, wi)
    _same(gd, wd)
    if not all_pairs:
        assert bool(torch.isnan(gd[9]).all()) and bool((gi[9] == -1).all())
    else:
        assert 5 not in gi[5].tolist() and 60 not in gi[5].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_prologue_equals_plain(cuda_device, precision):
    """``stage_planes`` on random normal rows with a zero row and a
    duplicate: the planes bit for bit the plain version's (hi = bf16(x), lo
    = bf16(x − hi)), the norms bit for bit ``stage_f32_norms``'s."""
    rng = np.random.default_rng(23)
    X = rng.standard_normal((1000, 101)).astype(np.float32) * 3.0
    X[7] = 0.0
    X[8] = X[9]
    X = torch.from_numpy(X).to(cuda_device)
    before = fused_knn.LAUNCHES["stage_planes"], fused_knn.LAUNCHES["stage_norms"]
    hi, lo, norms = fused_knn.stage_planes(X, precision)
    torch.cuda.synchronize()
    assert (fused_knn.LAUNCHES["stage_planes"], fused_knn.LAUNCHES["stage_norms"]) == (
        before[0] + 1, before[1] + 1)
    whi, wlo, _ = fused_knn.stage_planes_reference(X, precision,
                                                   fused_knn.staged_width(101))
    assert hi.shape == (1000, 128) and torch.equal(hi, whi)
    assert (lo is None) == (precision == "default")
    if lo is not None:
        assert torch.equal(lo, wlo)
    assert torch.equal(norms, fused_knn.stage_f32_norms(X))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_sweep_is_split_invariant(cuda_device, precision):
    """K2 at "default" / "high" on centered MNIST-like rows: the output at
    S = 1, 2, 5 (and the plan's) is the same bit for bit, and holds to the
    plain version's within its keys' rounding."""
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like

    X, _ = make_mnist_like(4096)
    X = torch.from_numpy(X - X.astype(np.float64).mean(0)).float().to(cuda_device)
    staged = fused_knn.stage_planes(X, precision)
    runs = [fused_knn.launch_planes("fused_knn_sweep", staged, staged, 4096, 10, 1024,
                                    precision, slices=s)
            for s in (None, 1, 2, 5)]
    torch.cuda.synchronize()
    for gd, gi in runs[1:]:
        assert torch.equal(gi, runs[0][1])
        _same(gd, runs[0][0])
    gd, gi = runs[0]
    wd, wi = fused_knn.fused_knn_sweep_reference(X, X, 4096, 10, 128, 1024,
                                                 precision=precision)
    assert float((gi == wi).float().mean()) > 0.99
    assert bool(((gd - wd).abs() <= 1e-4 * wd.abs().clamp_min(1.0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_sweep_serving_bucket_on_a_staged_corpus(cuda_device, precision):
    """A 1024-row bucket against a corpus staged once at the precision:
    the plan splits the corpus, one query prologue (planes and norms) and
    one kernel launch, bit for bit the plain version's."""
    rng = np.random.default_rng(24)
    C = torch.from_numpy((rng.integers(-300, 301, (12288, 64)) / 64.0).astype(np.float32))
    C[12000:] = 0.0
    Q = torch.from_numpy((rng.integers(-300, 301, (1024, 64)) / 64.0).astype(np.float32))
    C[40] = Q[3] = torch.from_numpy(rng.integers(-127, 128, 64) / 16.0)  # d = 0
    C, Q = C.to(cuda_device), Q.to(cuda_device)
    staged = fused_knn.stage_corpus(C, precision=precision)
    assert staged.part(precision) is not None and staged.nbytes > 0
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fused_knn.compress_sweep_plan(1024, 12000, sms)["slices"] > 1
    fused_knn.reset_launch_counts()
    gd, gi = fused_knn.fused_knn_sweep(Q, C, 12000, 10, 1024, 2048, all_pairs=False,
                                       staged_corpus=staged, precision=precision)
    torch.cuda.synchronize()
    assert fused_knn.LAUNCHES[f"fused_knn_sweep[{precision}]"] == 1
    assert fused_knn.LAUNCHES["stage_planes"] == 1
    assert fused_knn.LAUNCHES["stage_norms"] == 1
    wd, wi = fused_knn.fused_knn_sweep_reference(Q, C, 12000, 10, 1024, 2048,
                                                 all_pairs=False, precision=precision)
    assert torch.equal(gi, wi)
    _same(gd, wd)
    assert 40 not in gi[3].tolist()  # the zero rule


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default", "high"])
@pytest.mark.parametrize("dim", [24, 33, 784])
def test_precision_tile_products_match_plain(cuda_device, precision, dim):
    """The tile's raw products at each policy against ``_mm_t`` at that
    precision on random rows: within 1e-5 of |q| |c| (the sum orders
    differ); "default" and "high" are nearer their rounded-operand oracle
    than to the f64 product's error of another policy."""
    from mpi_knn_tpu_torch.ops.distance import _mm_t

    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal((300, dim)).astype(np.float32)).to(cuda_device)
    c = torch.from_numpy(rng.standard_normal((400, dim)).astype(np.float32)).to(cuda_device)
    got = fused_knn.exact_tile_dots(q, c, precision)
    torch.cuda.synchronize()
    want = _mm_t(q, c, precision)
    scale = q.norm(dim=1)[:, None] * c.norm(dim=1)[None, :]
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    exact = q.double() @ c.double().T
    err = ((got.double() - exact).abs() / scale.double()).max().item()
    assert err <= {"highest": 1e-6, "high": 1e-4, "default": 2e-2}[precision]
    if precision == "default":
        assert err > 1e-4  # the operands really were rounded


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("dim", [24, 100])
def test_precision_block_merge_equals_plain(cuda_device, wire, precision, dim):
    q, qids, blk, bids, scale = _ring_operands(cuda_device, wire, dim=dim)
    q[9] = float("nan")
    rows = blk.float() if scale is None else blk.float() * scale[:, None]
    cd, ci = _carry(q, rows, bids, 10)
    key = f"fused_block_merge[{precision}]"
    before = fused_ring.LAUNCHES[key]
    got = fused_ring.block_merge_exact(q, qids, blk, bids, scale, cd, ci, c_tile=64,
                                       precision=precision)
    torch.cuda.synchronize()
    want = fused_ring.block_merge_exact_reference(q, qids, blk, bids, scale, cd, ci,
                                                  c_tile=64, precision=precision)
    assert fused_ring.LAUNCHES[key] == before + 1
    assert torch.equal(got[1], want[1])
    _same(got[0], want[0])
    assert bool(torch.isnan(got[0][9]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("P", [1, 4])
def test_precision_round_dma_equals_plain(cuda_device, wire, precision, P):
    """K4 at "default" / "high": the bf16 wgmma tile on the f32 wire (the
    wrapper stages the planes), the mma.sync round kernel on the others."""
    queries, qids, blocks, carries = _ring_of(cuda_device, P, wire)
    ring = fused_rotation.RingTransport([cuda_device] * P)
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0) for b in blocks]
    want_land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 0)
                 for b in blocks]
    key = f"fused_round_dma[{precision}]"
    before = fused_rotation.LAUNCHES[key]
    got = fused_rotation.fused_round_dma(ring, queries, qids, blocks, carries, land,
                                         c_tile=64, precision=precision)
    torch.cuda.synchronize()
    want = fused_rotation.fused_round_dma_reference(queries, qids, blocks, carries,
                                                    want_land, c_tile=64,
                                                    precision=precision)
    assert fused_rotation.LAUNCHES[key] == before + 1
    assert fused_rotation.ring_kernel_plan("round", blocks[0][0].dtype, P, 96, 10,
                                           precision)["wgmma_tile"] == int(wire == "float32")
    for r in range(P):
        assert torch.equal(got[r][1], want[r][1])
        _same(got[r][0], want[r][0])
        assert torch.equal(land[(r + 1) % P][0], blocks[r][0])


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_rotation_grid_equals_plain(cuda_device, wire, precision):
    queries, qids, blocks, carries = _ring_of(cuda_device, 4, wire)
    ring = fused_rotation.RingTransport([cuda_device] * 4)
    key = f"fused_rotation_grid[{precision}]"
    before = fused_rotation.LAUNCHES[key]
    got = fused_rotation.fused_rotation_grid(
        ring, queries, qids, blocks, carries,
        [fused_rotation.landing_slots(*b) for b in blocks], c_tile=64,
        precision=precision)
    torch.cuda.synchronize()
    want = fused_rotation.fused_rotation_grid_reference(
        queries, qids, blocks, carries,
        [fused_rotation.landing_slots(*b) for b in blocks], c_tile=64,
        precision=precision)
    assert fused_rotation.LAUNCHES[key] == before + 1
    for r in range(4):
        assert torch.equal(got[r][1], want[r][1])
        _same(got[r][0], want[r][0])


def _staged_ring(device, P, precision, q_local, b, dim, k):
    """_ring_of's f32 operands with each traveler staged by K4's prologue
    at ``precision`` (norms and bf16 planes), so that its landing slots
    carry them too."""
    queries, qids, blocks, carries = _ring_of(device, P, "float32", q_local, b, dim, k)
    staged = []
    for blk, bids, scale in blocks:
        hi, lo, norms = fused_rotation.stage_ring_planes(blk, precision)
        staged.append((blk, bids, scale, norms, hi, lo))
    return queries, qids, staged, carries


# (k, q_local, b, dim): lists in shared memory; k past them (64 at
# "default", 40 at "high"); ragged rows, an odd B (a slot's norms off a
# 16-byte boundary) and a width not a multiple of 32
BF16_RING_SHAPES = {"k10": (10, 96, 256, 24), "k_past_lists": (70, 96, 256, 40),
                    "ragged": (10, 203, 301, 50)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("shape", list(BF16_RING_SHAPES))
def test_precision_bf16_transport_equals_plain(cuda_device, precision, P, shape):
    """K4 (two rounds: the second reads landing slot 1) and K5 (the whole
    rotation) on the f32 wire at "default" / "high", the bf16 wgmma tile,
    against their plain versions bit for bit on small integers: a query's
    duplicate in the block, a query whose id is in the block, -1 padding, a
    carry that ties block entries, a NaN query row."""
    k, q_local, b, dim = BF16_RING_SHAPES[shape]
    queries, qids, blocks, carries = _staged_ring(cuda_device, P, precision, q_local,
                                                  b, dim, k)
    queries[0][9] = float("nan")
    ring = fused_rotation.RingTransport([cuda_device] * P)
    slot = fused_rotation.slot
    slots = [fused_rotation.landing_slots(*t) for t in blocks]
    want_slots = [fused_rotation.landing_slots(*t) for t in blocks]
    kw = dict(c_tile=b, precision=precision)
    key = f"fused_round_dma[{precision}]"
    before = fused_rotation.LAUNCHES[key]
    got = fused_rotation.fused_round_dma(ring, queries, qids, blocks, carries,
                                         [slot(s, 1) for s in slots], **kw)
    got = fused_rotation.fused_round_dma(ring, queries, qids, [slot(s, 1) for s in slots],
                                         got, [slot(s, 0) for s in slots], **kw)
    torch.cuda.synchronize()
    want = fused_rotation.fused_round_dma_reference(
        queries, qids, blocks, carries, [slot(s, 1) for s in want_slots], **kw)
    want = fused_rotation.fused_round_dma_reference(
        queries, qids, [slot(s, 1) for s in want_slots], want,
        [slot(s, 0) for s in want_slots], **kw)
    assert fused_rotation.LAUNCHES[key] == before + 2
    for r in range(P):
        assert torch.equal(got[r][1], want[r][1])
        _same(got[r][0], want[r][0])
        for have, sent in zip(slot(slots[(r + 2) % P], 0), blocks[r]):
            assert (have is None) == (sent is None)
            if sent is not None:
                assert torch.equal(have.view(torch.uint8), sent.view(torch.uint8))
    assert bool((got[0][1][9] == -1).all())
    plain = [t[:3] for t in blocks]
    key = f"fused_rotation_grid[{precision}]"
    before = fused_rotation.LAUNCHES[key]
    got = fused_rotation.fused_rotation_grid(
        ring, queries, qids, plain, carries,
        [fused_rotation.landing_slots(*t) for t in plain], **kw)
    torch.cuda.synchronize()
    want = fused_rotation.fused_rotation_grid_reference(
        queries, qids, plain, carries,
        [fused_rotation.landing_slots(*t) for t in plain], **kw)
    assert fused_rotation.LAUNCHES[key] == before + 1
    assert fused_rotation.ring_kernel_plan("grid", torch.float32, P, q_local, k,
                                           precision)["wgmma_tile"] == 1
    for r in range(P):
        assert torch.equal(got[r][1], want[r][1])
        _same(got[r][0], want[r][0])


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_round_dma_lands_bf16_planes(cuda_device, precision):
    """After a K4 round on the f32 wire at "default" / "high" each landing
    slot holds its predecessor's block, ids, norms and bf16 planes byte for
    byte (no lo plane at "default"), and the wrapper staged nothing."""
    queries, qids, blocks, carries = _staged_ring(cuda_device, 4, precision, 96, 256,
                                                  100, 10)
    q_staged = [fused_rotation.stage_ring_planes(q, precision) for q in queries]
    ring = fused_rotation.RingTransport([cuda_device] * 4)
    land = [fused_rotation.slot(fused_rotation.landing_slots(*b), 1) for b in blocks]
    before = (fused_knn.LAUNCHES["stage_planes"], fused_knn.LAUNCHES["stage_norms"])
    fused_rotation.fused_round_dma(
        ring, queries, qids, blocks, carries, land, c_tile=64, precision=precision,
        query_norms=[s[2] for s in q_staged], query_planes=[s[:2] for s in q_staged])
    torch.cuda.synchronize()
    assert (fused_knn.LAUNCHES["stage_planes"], fused_knn.LAUNCHES["stage_norms"]) == before
    for r in range(4):
        have, sent = land[(r + 1) % 4], blocks[r]
        assert have[2] is None and (have[5] is None) == (precision == "default")
        for part in (0, 1, 3, 4, 5):
            if sent[part] is not None:
                assert torch.equal(have[part].view(torch.uint8), sent[part].view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [100, 784])
def test_stage_norms_equal_the_ring_wire_norms(cuda_device, dim):
    """The "default" / "high" prologue's norms (stage_norms, which K4's bf16
    travelers carry) equal stage_wire_norms' (K3a's and K5's) bit for bit:
    the resumable ring's K3a round and the grid ring may take either."""
    X = _centered_mnist(cuda_device, m=3000)[:, :dim].contiguous()
    assert torch.equal(fused_knn.stage_f32_norms(X), fused_ring.stage_wire_norms(X, None))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", PRECISIONS)
def test_precision_grid_ring_equals_dma_ring(cuda_device, precision):
    """The fused-grid ring (K5, planes made on the card each round) equals
    the fused-dma ring (K4, planes staged once and travelling) bit for bit
    at "default" / "high" on non-integer rows: one tile, one epilogue."""
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.backends.ring import all_knn_ring

    rng = np.random.default_rng(12)
    X = (rng.standard_normal((1500, 50)) * 3.0).astype(np.float32)
    ids = np.arange(1500, dtype=np.int32)
    mesh = [cuda_device] * 4
    kw = dict(k=10, backend="ring-overlap", ring_fusion="fused", query_tile=128,
              corpus_tile=256, center=False, matmul_precision=precision)
    dma = all_knn_ring(X, X, ids, KNNConfig(**kw), mesh=mesh, form="dma")
    grid = all_knn_ring(X, X, ids, KNNConfig(ring_fused_rotation="grid", **kw), mesh=mesh,
                        form="grid")
    assert torch.equal(dma[1], grid[1]) and torch.equal(dma[0], grid[0])


# ---------------------------------------------------------------------------
# the f64 bin minimum: the same plans on double rows, 16-byte keys


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tile_k10", "tile_rerank", "stream_rerank", "k1",
                                  "ties", "ties_raw", "inf_padding", "zeros_nan",
                                  "wide_raw", "cta_k40", "cta_raw", "odd_warp",
                                  "odd_cta_raw", "odd_two_pass"])
def test_approx_kernel_f64_equals_plain(cuda_device, name):
    from mpi_knn_tpu_torch.ops import approx_topk

    x, k, rt, agg = _approx_case(name, cuda_device)
    x = x.double()
    if name in ("tile_k10", "wide_raw"):  # values no f32 holds
        x = x + 1e-12 * torch.arange(x.shape[1], device=x.device, dtype=x.dtype)
    before = approx_topk.LAUNCHES["approx_min_k[f64]"]
    gv, gp = approx_topk.approx_min_k(x, k, rt, agg)
    torch.cuda.synchronize()
    wv, wp = approx_topk.approx_min_k_reference(x, k, rt, agg)
    assert approx_topk.LAUNCHES["approx_min_k[f64]"] == before + 1
    assert gv.dtype == torch.float64
    assert torch.equal(gp, wp)
    assert torch.equal(gv.view(torch.int64), wv.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tile_k10", "tile_rerank", "stream_rerank",
                                  "merge_k10", "ties", "inf", "zeros_nan"])
def test_fused_approx_f64_equals_the_chain(cuda_device, name):
    from mpi_knn_tpu_torch.ops import approx_topk
    from mpi_knn_tpu_torch.ops.topk import smallest_k

    d, ids, k, method = _fused_case(name, cuda_device)
    d = d.double()
    before = approx_topk.LAUNCHES["approx_min_k[f64]"]
    gv, gi = smallest_k(d, ids, k, method=method)
    torch.cuda.synchronize()
    assert approx_topk.LAUNCHES["approx_min_k[f64]"] == before + 1
    wv, wi = approx_topk.approx_smallest_k_reference(d, ids, k, method)
    assert torch.equal(gi, wi)
    assert torch.equal(gv.view(torch.int64), wv.view(torch.int64))


# ---------------------------------------------------------------------------
# ring serving: a resident ring index on one card (P ranks), every batch
# bit for bit all_knn's, the shards never written


RING_SERVE_CASES = {
    "dma": dict(ring_fusion="fused"),
    "bidir": dict(ring_fusion="fused", ring_schedule="bidir"),
    "grid": dict(ring_fusion="fused", ring_fused_rotation="grid"),
    "dma_default": dict(ring_fusion="fused", matmul_precision="default"),
    "bidir_high": dict(ring_fusion="fused", ring_schedule="bidir",
                       matmul_precision="high"),
    "mixed_int8": dict(ring_fusion="fused", precision_policy="mixed",
                       ring_transfer_dtype="int8"),
    "bf16_wire": dict(ring_fusion="fused", ring_transfer_dtype="bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RING_SERVE_CASES))
@pytest.mark.parametrize("P", [1, 4])
def test_ring_serve_equals_all_knn(cuda_device, case, P):
    from mpi_knn_tpu_torch import all_knn
    from mpi_knn_tpu_torch.serve import ServeSession, build_index, engine, query_knn

    rng = np.random.default_rng(22)
    X = rng.standard_normal((1500, 64)).astype(np.float32)
    kw = dict(k=10, backend="ring-overlap", query_bucket=64, corpus_tile=256,
              query_tile=64, **RING_SERVE_CASES[case])
    mesh = [cuda_device] * P
    index = build_index(X, device=cuda_device, mesh=mesh, **kw)
    before = [tuple(None if t is None else t.clone() for t in s) for s in index.shards]
    engine.reset_misses()
    for rows in (64, 17, 130, 1):  # the kernels' rows do not depend on the batch
        Q = rng.standard_normal((rows, 64)).astype(np.float32)
        got = query_knn(Q, index, device=cuda_device)
        want = all_knn(X, queries=Q, device=cuda_device, mesh=mesh, **kw)
        assert torch.equal(got.ids, want.ids.cpu())
        assert torch.equal(got.dists, want.dists.cpu())
    session = ServeSession(index, device=cuda_device)
    session.warm([5, 64, 100])
    misses = engine.MISSES
    list(session.stream([rng.standard_normal((n, 64)).astype(np.float32)
                         for n in (5, 64, 100)]))
    assert engine.MISSES == misses
    for b, a in zip(before, index.shards):
        for x, y in zip(b, a):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the clustered (IVF) index: no kernel of its own, but its bits on the card


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [31, 128])
def test_int4_codes_on_the_card_equal_the_cpu(cuda_device, dim):
    from mpi_knn_tpu_torch.ops.quant import dequantize_rows, unpack_int4

    rng = np.random.default_rng(dim)
    x = torch.from_numpy((rng.standard_normal((4096, dim)) * 3).astype(np.float32))
    x[3] = 0.0
    for dtype in ("int4", "int8"):
        gc, gs = quantize_rows(x.to(cuda_device), dtype)
        wc, ws = quantize_rows(x, dtype)
        assert torch.equal(gc.cpu(), wc) and torch.equal(gs.cpu(), ws)
        assert torch.equal(dequantize_rows(gc, gs, dtype, dim).cpu(),
                           dequantize_rows(wc, ws, dtype, dim))
    assert torch.equal(unpack_int4(gc, dim).cpu(), unpack_int4(wc, dim))


def _ivf_corpus(m=8192, d=64, centers=64, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((centers, d)).astype(np.float32) * 4
    X = cents[rng.integers(0, centers, m)] + rng.standard_normal((m, d)).astype(np.float32)
    return X.astype(np.float32), rng.standard_normal((1000, d)).astype(np.float32) * 4


@pytest.mark.cuda
@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_built_twice_gives_equal_bits(cuda_device, init):
    from mpi_knn_tpu_torch.ivf import build_ivf_index, kmeans

    X, _ = _ivf_corpus()
    a = kmeans(X, 64, iters=10, seed=7, init=init, device=cuda_device)
    b = kmeans(X, 64, iters=10, seed=7, init=init, device=cuda_device)
    assert a.centroids.is_cuda
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.assignments, b.assignments)
    assert torch.equal(a.counts, b.counts)
    cfg = dict(k=10, partitions=32, kmeans_iters=5, kmeans_init=init)
    i1 = build_ivf_index(X, device=cuda_device, **cfg)
    i2 = build_ivf_index(X, device=cuda_device, **cfg)
    assert i1.nprobe == i2.nprobe
    for f in ("centroids", "buckets", "bucket_ids", "bucket_sqs"):
        assert torch.equal(getattr(i1, f), getattr(i2, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("policy", ["exact", "mixed"])
def test_ivf_serving_equals_the_one_shot_search(cuda_device, dtype, policy):
    """Every served batch, ragged ones included, equals the one-shot search
    of its rows, and the one-shot search of all the rows, bit for bit; the
    card's search agrees with the CPU's on the same index."""
    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf
    from mpi_knn_tpu_torch.serve import ServeSession, query_knn

    if dtype == "bfloat16" and policy == "mixed":
        pytest.skip("mixed is refused over a bf16 store (a config rule)")
    X, Q = _ivf_corpus()
    idx = build_ivf_index(X, k=10, partitions=32, nprobe=6, kmeans_iters=5,
                          dtype=dtype, query_bucket=64,
                          precision_policy=policy, device=cuda_device)
    for t in (idx.centroids, idx.buckets, idx.bucket_ids, idx.bucket_sqs):
        assert t.is_cuda
    d_all, i_all = search_ivf(idx, Q, device=cuda_device)
    start = 0
    for rows in (64, 1, 17, 130, 300):
        q = Q[start:start + rows]
        got = query_knn(q, idx, device=cuda_device)
        d1, i1 = search_ivf(idx, q, device=cuda_device)
        assert torch.equal(got.ids, i1.cpu()) and torch.equal(got.dists, d1.cpu())
        assert torch.equal(got.ids, i_all[start:start + rows].cpu())
        assert torch.equal(got.dists, d_all[start:start + rows].cpu())
        start += rows
    outs = list(ServeSession(idx, device=cuda_device).stream(
        [Q[s:s + 100] for s in range(0, 1000, 100)]))
    assert np.array_equal(np.concatenate([o.ids for o in outs]), i_all.cpu().numpy())
    assert np.array_equal(np.concatenate([o.dists for o in outs]), d_all.cpu().numpy())
    # the same index searched on the CPU: ids tie-aware, distances close
    from mpi_knn_tpu_torch.ivf.index import IVFIndex

    cpu = IVFIndex(**{f: (getattr(idx, f).cpu() if isinstance(getattr(idx, f), torch.Tensor)
                          else getattr(idx, f))
                      for f in ("cfg", "m", "dim", "partitions", "bucket_cap", "nprobe",
                                "mu", "centroids", "centroid_sqs", "buckets",
                                "bucket_ids", "bucket_sqs", "bucket_scales")},
                   device=torch.device("cpu"))
    wd, wi = search_ivf(cpu, Q, device="cpu")
    agree = (i_all.cpu() == wi).float().mean().item()
    assert agree >= 0.999, agree
    assert torch.allclose(d_all.cpu(), wd, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Live mutation on the card (serve/mutate.py, ivf/mutate.py): no kernel,
# but in-place scatters, reductions whose order may follow a tensor's shape,
# and streams that threads do not share


def _moved(idx, device):
    """A copy of an IVF index on ``device`` (the freelist derived anew)."""
    from mpi_knn_tpu_torch.ivf.index import IVFIndex

    fields = ("cfg", "m", "dim", "partitions", "bucket_cap", "nprobe", "mu",
              "centroids", "centroid_sqs", "buckets", "bucket_ids",
              "bucket_sqs", "bucket_scales")
    return IVFIndex(**{f: (getattr(idx, f).to(device, copy=True)
                           if isinstance(getattr(idx, f), torch.Tensor)
                           else getattr(idx, f)) for f in fields},
                    device=torch.device(device))


def _store_of(idx):
    from mpi_knn_tpu_torch.serve import mutate as sm

    return [t for t in sm._store(idx) if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("chunk", [1, 128, 8192])
def test_mutation_reupsert_keeps_the_store_bit_for_bit(cuda_device, dtype, chunk):
    """Every live row upserted again under its own id with its own raw
    values, in chunks of 1 (a chunk padded to the bucket), 128 and all rows:
    every store tensor keeps its storage and its bits (the assignment, the
    quantizer and the norms of a chunk equal the build's)."""
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.serve import mutate as sm

    X, _ = _ivf_corpus()
    idx = build_ivf_index(X, k=10, partitions=32, nprobe=6, kmeans_iters=5,
                          dtype=dtype, bucket_headroom=0.5, mutation_bucket=128,
                          device=cuda_device)
    before = [t.clone() for t in _store_of(idx)]
    ptrs = [t.data_ptr() for t in _store_of(idx)]
    for s in range(0, len(X), chunk):
        sm.upsert_rows(idx, np.arange(s, min(s + chunk, len(X))), X[s:s + chunk])
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in _store_of(idx)] == ptrs
    for a, b in zip(_store_of(idx), before):
        assert torch.equal(a, b)
    assert sm.mutation_stats(idx)["tombstones"] == 0


@pytest.mark.cuda
def test_serial_reupsert_keeps_the_tile_stack_bit_for_bit(cuda_device):
    from mpi_knn_tpu_torch.serve import build_index
    from mpi_knn_tpu_torch.serve import mutate as sm

    X, _ = _ivf_corpus(m=3000)
    idx = build_index(X, k=10, backend="serial", bucket_headroom=0.5,
                      mutation_bucket=128, device=cuda_device)
    before = [t.clone() for t in _store_of(idx)]
    for s in range(0, len(X), 128):
        sm.upsert_rows(idx, np.arange(s, min(s + 128, len(X))), X[s:s + 128])
    for a, b in zip(_store_of(idx), before):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_mutation_peak_memory_grows_by_chunks_only(cuda_device, dtype):
    """An upsert and a delete of 128 rows on a store of tens of MB: the same
    storage, and the peak allocation grows by a few chunk sizes (the chunk's
    rows and its (rows, partitions) centroid score), never by the store's."""
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.serve import mutate as sm

    rng = np.random.default_rng(1)
    X = (rng.standard_normal((60000, 128)) * 4).astype(np.float32)
    idx = build_ivf_index(X, k=10, partitions=64, nprobe=4, kmeans_iters=3,
                          dtype=dtype, bucket_headroom=0.5, mutation_bucket=128,
                          device=cuda_device)
    new = (rng.standard_normal((256, 128)) * 4).astype(np.float32)
    sm.upsert_rows(idx, np.arange(10**6, 10**6 + 128), new[:128])  # warm-up
    sm.delete_rows(idx, np.arange(10**6, 10**6 + 128))
    ptrs = [t.data_ptr() for t in _store_of(idx)]
    store = sum(t.numel() * t.element_size() for t in _store_of(idx))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    sm.upsert_rows(idx, np.arange(2 * 10**6, 2 * 10**6 + 128), new[128:])
    sm.delete_rows(idx, np.arange(2 * 10**6, 2 * 10**6 + 128))
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(cuda_device) - base
    chunk = 128 * (128 + idx.partitions) * 4
    assert [t.data_ptr() for t in _store_of(idx)] == ptrs
    assert grew <= 8 * chunk < store // 16, (grew, chunk, store)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_quantized_slots_written_on_the_card_equal_the_cpu(cuda_device, dtype):
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.serve import mutate as sm

    X, _ = _ivf_corpus()
    cpu = build_ivf_index(X, k=10, partitions=32, nprobe=6, kmeans_iters=5,
                          dtype=dtype, bucket_headroom=0.5, device="cpu")
    card = _moved(cpu, cuda_device)
    rng = np.random.default_rng(2)
    new = (X[rng.integers(0, len(X), 300)]
           + rng.standard_normal((300, X.shape[1])).astype(np.float32))
    ids = np.arange(50000, 50300)
    for idx in (cpu, card):
        sm.upsert_rows(idx, ids, new)
        sm.delete_rows(idx, ids[:50])
        sm.upsert_rows(idx, ids[100:140], new[:40])  # updates, some moving
    assert torch.equal(card.bucket_ids.cpu(), cpu.bucket_ids)
    assert torch.equal(card.buckets.cpu(), cpu.buckets)
    assert torch.equal(card.bucket_scales.cpu(), cpu.bucket_scales)
    assert torch.allclose(card.bucket_sqs.cpu(), cpu.bucket_sqs, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_no_scatter_sees_a_sentinel_on_the_card(cuda_device, monkeypatch):
    """Every index tensor that reaches a scatter lies inside the store (a
    sentinel would be a device-side assert); a chunk of unknown ids
    launches no scatter."""
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.ivf import mutate as pim
    from mpi_knn_tpu_torch.serve import mutate as sm

    X, _ = _ivf_corpus()
    idx = build_ivf_index(X, k=10, partitions=32, nprobe=6, kmeans_iters=5,
                          bucket_headroom=0.5, device=cuda_device)
    seen = []
    real = pim._kept

    def spy(part, slot, total):
        out = real(part, slot, total)
        seen.append(None if out is None else
                    (int(out[0].min()), int(out[0].max()), int(out[1].max()), total))
        return out

    monkeypatch.setattr(sm, "_kept", spy)
    sm.upsert_rows(idx, np.arange(9000, 9100), X[:100] + 0.5)
    sm.upsert_rows(idx, np.arange(9000, 9010), X[500:510])  # moves: clears
    sm.delete_rows(idx, [10**7, 10**7 + 1])  # unknown: nothing launched
    sm.delete_rows(idx, np.arange(9000, 9050))
    torch.cuda.synchronize()
    assert seen[-2] is None
    for entry in seen:
        if entry is not None:
            lo, hi, slot_hi, total = entry
            assert 0 <= lo and hi < total and slot_hi < idx.bucket_cap


@pytest.mark.cuda
def test_compaction_with_retrain_gives_the_same_bits_twice(cuda_device):
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.serve import mutate as sm

    X, _ = _ivf_corpus()
    a = build_ivf_index(X, k=10, partitions=32, nprobe=6, kmeans_iters=5,
                        dtype="int8", bucket_headroom=0.5, device=cuda_device)
    sm.delete_rows(a, np.arange(0, len(X), 3))
    b = _moved(a, cuda_device)
    for idx in (a, b):
        st = sm.compact_index(idx, retrain=True)
        assert st["live"] == len(X) - len(range(0, len(X), 3))
    for x, y in zip(_store_of(a) + [a.centroids], _store_of(b) + [b.centroids]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("side_stream", [False, True])
def test_compactor_and_a_depth_2_session_share_the_store_safely(cuda_device,
                                                                side_stream):
    """A thread churns (upserts, deletes) beside a depth-2 session while a
    Compactor thread compacts on the tombstone trigger; with
    ``side_stream`` the churning thread enqueues on a stream of its own.
    Every batch is finite and returns no id deleted before it was
    submitted; once quiet, a served batch equals the one-shot search."""
    import threading

    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf
    from mpi_knn_tpu_torch.serve import ServeSession

    X, Q = _ivf_corpus()
    idx = build_ivf_index(X, k=10, partitions=32, nprobe=6, kmeans_iters=5,
                          bucket_headroom=0.5, dispatch_depth=2, query_bucket=128,
                          compact_tombstone_fraction=0.02, device=cuda_device)
    ses = ServeSession(idx, device=cuda_device)
    deleted, lock, stop = [], threading.Lock(), threading.Event()

    def churn():
        stream = torch.cuda.Stream() if side_stream else torch.cuda.current_stream()
        rng = np.random.default_rng(4)
        nid = 10**6
        with torch.cuda.stream(stream):
            while not stop.is_set():
                ses.upsert(np.arange(nid, nid + 128),
                           X[rng.integers(0, len(X), 128)] + 0.5)
                gone = rng.choice(len(X), 64, replace=False)
                ses.delete(np.concatenate([np.arange(nid, nid + 64), gone]))
                with lock:
                    deleted.extend(range(nid, nid + 64))
                    deleted.extend(gone.tolist())
                nid += 128

    worker = threading.Thread(target=churn)
    comp = ses.start_compactor(interval_s=0.005)
    gone_at, done = [], []
    try:
        worker.start()
        for s in range(60):
            with lock:
                gone_at.append(set(deleted))
            done += ses.submit(Q[(s % 8) * 100:(s % 8) * 100 + 100])
        done += ses.drain()
    finally:
        stop.set()
        worker.join(timeout=120)
        comp.stop(timeout=120)
    assert not worker.is_alive() and not comp._thread.is_alive()
    assert comp.snapshot()["compactions"] >= 1 and len(done) == 60
    for res in done:
        assert np.isfinite(res.dists).all()
        assert not gone_at[res.seq] & set(res.ids.ravel().tolist())
    got = list(ses.stream([Q[:100]]))[0]
    _, want = search_ivf(idx, Q[:100], device=cuda_device)
    assert np.array_equal(got.ids, want.cpu().numpy())


# ---------------------------------------------------------------------------
# the operations layer on the card: the kernel cache across restarts, the
# sentinel, the ladder's rungs, the parallel warm, the doctor

_RESTART_CHILD = """
import json, sys
import numpy as np
import torch
from mpi_knn_tpu_torch.obs.metrics import get_registry
from mpi_knn_tpu_torch.serve import ServeSession, aotcache, build_index

aotcache.set_cache_dir(sys.argv[1])
rng = np.random.default_rng(12)
X = rng.standard_normal((4000, 96)).astype(np.float32)
Q = rng.standard_normal((300, 96)).astype(np.float32)
index = build_index(X, device="cuda", k=10, backend="pallas", query_bucket=128)
ses = ServeSession(index, device="cuda")
out = list(ses.stream([Q[:100], Q[100:300]]))
reg = get_registry()
print(json.dumps({k: reg.counter(k).value for k in (
    "nvcc_builds_total", "aot_cache_hits_total", "aot_cache_misses_total",
    "aot_cache_errors_total", "aot_cache_stores_total")} | {
    "ids": np.concatenate([r.ids for r in out]).tolist(),
    "dists": np.concatenate([r.dists for r in out]).view(np.int32).tolist()}))
"""


@pytest.mark.cuda
def test_a_warm_restart_builds_nothing_and_serves_the_same_bits(cuda_device,
                                                               tmp_path):
    """A cold process builds fused_knn with nvcc and stores it; a restarted
    one loads it from the cache (zero nvcc builds, one hit) and serves the
    same bits; a truncated entry is rebuilt loudly, the same bits again."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    cache = tmp_path / "cache"

    def child():
        r = subprocess.run([sys.executable, "-c", _RESTART_CHILD, str(cache)],
                           cwd=repo, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
        return json.loads(r.stdout.strip().splitlines()[-1])

    cold = child()
    n = cold["nvcc_builds_total"]
    assert n >= 1 and (cold["aot_cache_misses_total"], cold["aot_cache_stores_total"],
                       cold["aot_cache_hits_total"]) == (n, n, 0)
    warm = child()
    assert (warm["nvcc_builds_total"], warm["aot_cache_hits_total"],
            warm["aot_cache_misses_total"]) == (0, n, 0)
    assert (warm["ids"], warm["dists"]) == (cold["ids"], cold["dists"])
    entry = sorted(cache.glob("*.tknnlib"))[0]
    entry.write_bytes(entry.read_bytes()[: entry.stat().st_size // 2])
    damaged = child()
    assert (damaged["aot_cache_errors_total"], damaged["nvcc_builds_total"]) == (1, 1)
    assert (damaged["ids"], damaged["dists"]) == (cold["ids"], cold["dists"])


@pytest.mark.cuda
def test_the_sentinel_trips_on_a_poisoned_card_result(cuda_device):
    from mpi_knn_tpu_torch import ServeSession, build_index
    from mpi_knn_tpu_torch.resilience import (
        PoisonedResultError,
        ResiliencePolicy,
        install_faults,
    )

    rng = np.random.default_rng(13)
    X = rng.standard_normal((2000, 64)).astype(np.float32)
    index = build_index(X, device=cuda_device, k=10, backend="pallas",
                        query_bucket=64)
    ses = ServeSession(index, resilience=ResiliencePolicy(max_retries=0),
                       device=cuda_device, dispatch_depth=2)
    Q = rng.standard_normal((50, 64)).astype(np.float32)
    ses.submit(Q)
    with install_faults({"serve-nan": "nan"}):
        ses.submit(Q)  # poisoned on the card, retired by the next submit
    with pytest.raises(PoisonedResultError) as e:
        ses.submit(Q)
    assert (e.value.batch_seq, e.value.bucket, e.value.rows) == (1, 64, 50)
    rest = ses.drain()
    assert len(rest) == 1 and np.isfinite(rest[0].dists).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["pallas", "serial"])
def test_each_rung_on_the_card_serves_what_a_session_at_its_config_serves(
        cuda_device, layout):
    """An exact pallas index on the card stages the bf16 copy the mixed
    rung reads at the session's construction; every rung's batches equal,
    bit for bit, a session built at that rung's config, and walking the
    whole ladder after warm builds nothing."""
    from mpi_knn_tpu_torch import ServeSession, build_index
    from mpi_knn_tpu_torch.obs.metrics import watch_compiles
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy

    rng = np.random.default_rng(14)
    X = rng.standard_normal((3000, 64)).astype(np.float32)
    Q = rng.standard_normal((100, 64)).astype(np.float32)
    index = build_index(X, device=cuda_device, k=10, backend=layout,
                        query_bucket=128)
    ses = ServeSession(index, resilience=ResiliencePolicy(min_bucket=16),
                       device=cuda_device)
    assert [lb for lb, _ in ses.ladder] == ["full", "mixed", "bucket/64"]
    if layout == "pallas":
        assert ses.staged_bytes == sum(t.numel() * t.element_size()
                                       for t in index.staged.compress)
    ses.warm([100])
    for i, (label, cfg) in enumerate(ses.ladder):
        if i:
            ses.shed_rung(reason="test")
        with watch_compiles() as builds:
            (got,) = ses.submit(Q) + ses.drain()
        assert builds == []
        (want,) = ServeSession(index, cfg, device=cuda_device).stream([Q])
        assert np.array_equal(got.ids, want.ids)
        assert np.array_equal(got.dists, want.dists)


@pytest.mark.cuda
def test_a_parallel_warm_serves_the_bits_of_a_sequential_one(cuda_device):
    from mpi_knn_tpu_torch import ServeSession, build_index

    rng = np.random.default_rng(15)
    X = rng.standard_normal((3000, 64)).astype(np.float32)
    Q = rng.standard_normal((250, 64)).astype(np.float32)
    kw = dict(k=10, backend="pallas", query_bucket=16)
    outs = []
    for parallel in (1, 4):
        ses = ServeSession(build_index(X, device=cuda_device, **kw),
                           device=cuda_device, dispatch_depth=2)
        rep = ses.warm([16, 64, 128, 256], parallel=parallel)
        assert rep["built"] == rep["cells"] == 4
        outs.append(list(ses.stream([Q[:16], Q[:64], Q[:128], Q])))
    for a, b in zip(*outs):
        assert np.array_equal(a.ids, b.ids) and np.array_equal(a.dists, b.dists)


@pytest.mark.cuda
def test_the_doctor_on_the_card_and_a_supervisor_that_never_touches_it(
        cuda_device, tmp_path):
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    probe = ("import json, sys; from mpi_knn_tpu_torch.resilience.doctor import main; "
             "rc = main(['--report', sys.argv[1], '--cache-dir', sys.argv[2]]); "
             "torch_loaded = 'torch' in sys.modules; import torch; "
             "print(json.dumps({'rc': rc, 'torch_loaded': torch_loaded, "
             "'cuda_initialized': torch.cuda.is_initialized()}))")
    r = subprocess.run([sys.executable, "-c", probe, str(tmp_path / "v.json"),
                        str(tmp_path / "cache")], cwd=repo, capture_output=True,
                       text=True, timeout=600)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    v = json.loads((tmp_path / "v.json").read_text())
    assert out == {"rc": 0, "torch_loaded": False, "cuda_initialized": False}, v
    assert v["ok"] and v["probe"]["platform"] == "cuda"
    assert v["probe"]["launches"] == 1 and v["probe"]["agrees_with_plain"]
    assert v["aot_cache"]["dlopen_ok"] and v["aot_cache"]["bit_identical"]
    assert v["mutation"]["ok"] and v["mutation"]["second_pass_builds"] == 0
    # the memory line: the recorded K1 probe against the allocator
    assert v["memory"]["ok"] and v["memory"]["model_bytes"] is None
    assert v["memory"]["band"][0] <= v["memory"]["measured_bytes"] <= v["memory"]["band"][1]


# ---------------------------------------------------------------------------
# the serving front end on the card


def _mnist_like(m, seed):
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like

    return make_mnist_like(m, seed=seed)[0]


@pytest.mark.cuda
def test_coalesced_answers_on_the_card_equal_the_session_alone_bit_for_bit(
        cuda_device):
    """Ragged requests of several tenants, coalesced by the front end into
    shared batches (a row lands at another place of another bucket than
    when served alone), answer bit for bit as the session alone answers
    each request's rows: K1's per-row arithmetic does not depend on its
    neighbours."""
    from mpi_knn_tpu_torch import KNNConfig, ServeSession, build_index
    from mpi_knn_tpu_torch.frontend import Frontend, Rejection, SLOPolicy
    from mpi_knn_tpu_torch.resilience import ResiliencePolicy

    X, Q = _mnist_like(8192, 0), _mnist_like(1024, 1)
    index = build_index(X, KNNConfig(k=10, backend="pallas", query_bucket=128),
                        device=cuda_device)
    fe = Frontend(ServeSession(index, resilience=ResiliencePolicy(),
                               device=cuda_device),
                  SLOPolicy(max_batch_rows=512, max_wait_s=0.005,
                            max_queue_rows=65536)).start()
    sizes = [1, 5, 16, 33, 7, 16, 64, 2, 31, 16, 200, 128, 9, 3]
    reqs, at = [], 0
    for i, n in enumerate(sizes):
        reqs.append((f"tenant-{i % 5}", Q[at:at + n]))
        at += n
    try:
        tickets = [fe.submit(t, q) for t, q in reqs]
        got = [t.result(timeout=120) for t in tickets]
    finally:
        fe.stop()
    assert not any(isinstance(t, Rejection) for t in tickets)
    alone = ServeSession(index, device=cuda_device)
    for (_, q), (d, i) in zip(reqs, got):
        (res,) = alone.submit(q) + alone.drain()
        assert np.array_equal(i, res.ids) and np.array_equal(d, res.dists)


@pytest.mark.cuda
def test_an_acknowledged_upsert_is_seen_by_the_next_pumped_batch(cuda_device):
    """A handler thread's upsert (its own thread, its own current stream)
    answered, the next batch the pump dispatches returns the new ids, and
    after an acknowledged delete never returns the deleted one: the
    mutation lock and ``order_stream`` order them across threads."""
    import threading

    from mpi_knn_tpu_torch import KNNConfig, ServeSession, build_index
    from mpi_knn_tpu_torch.frontend import Frontend, SLOPolicy

    X = _mnist_like(8192, 0)
    index = build_index(X, KNNConfig(k=10, backend="serial", query_bucket=256,
                                     bucket_headroom=0.1, mutation_bucket=64),
                        device=cuda_device)
    fe = Frontend(ServeSession(index, device=cuda_device),
                  SLOPolicy(max_batch_rows=256, max_wait_s=0.001,
                            max_queue_rows=65536)).start()
    try:
        for round_ in range(8):
            rows = _mnist_like(64, 100 + round_)
            ids = 1_000_000 + 64 * round_ + np.arange(64)
            out = {}
            th = threading.Thread(target=lambda: out.update(  # noqa: B023
                up=fe.upsert("w", ids, rows)))  # noqa: B023
            th.start()
            th.join(60)
            assert out["up"]["upserted"] == 64
            _, got = fe.submit("r", rows + 0.5).result(timeout=60)
            assert np.array_equal(got[:, 0], ids)
            th = threading.Thread(target=lambda: out.update(  # noqa: B023
                dl=fe.delete("w", ids[:32])))  # noqa: B023
            th.start()
            th.join(60)
            assert out["dl"]["deleted"] == 32
            _, got = fe.submit("r", rows + 0.5).result(timeout=60)
            assert not np.isin(got, ids[:32]).any()
            assert np.array_equal(got[32:, 0], ids[32:])
    finally:
        fe.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["serial", "ivf"])
def test_warm_mutation_makes_the_first_upsert_as_cheap_as_the_second(
        cuda_device, layout):
    """After ``warm_mutation`` the first 128-row upsert pays nothing lazy:
    its time is within 2x (+ 1 ms) of the second's. The times of an index
    not warmed are printed beside them."""
    import time

    from mpi_knn_tpu_torch import KNNConfig, build_index
    from mpi_knn_tpu_torch.ivf import build_ivf_index
    from mpi_knn_tpu_torch.serve.mutate import upsert_rows, warm_mutation

    X = _mnist_like(16384, 0)
    cfg = KNNConfig(k=10, backend="serial", bucket_headroom=0.25,
                    mutation_bucket=128,
                    **({"partitions": 16, "nprobe": 4} if layout == "ivf" else {}))

    def fresh():
        build = build_ivf_index if layout == "ivf" else build_index
        return build(X, cfg, device=cuda_device)

    def timed(index, seed):
        rows = _mnist_like(128, seed)
        ids = 2_000_000 + 128 * seed + np.arange(128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        upsert_rows(index, ids, rows)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cold = fresh()
    cold_s = (timed(cold, 1), timed(cold, 2))
    warm = fresh()
    first_pass = warm_mutation(warm)
    assert first_pass["built"] >= 1 and warm_mutation(warm)["built"] == 0
    warm_s = (timed(warm, 1), timed(warm, 2))
    print(f"{layout}: not warmed {cold_s}, warmed {warm_s}, {first_pass}")
    assert warm_s[0] <= 2 * warm_s[1] + 1e-3


@pytest.mark.cuda
def test_run_supervised_stops_and_names_a_card_child(cuda_device):
    """``on_spawn`` gets the pid of a child that holds a CUDA context; a set
    ``stop_event`` kills it (status "timeout", reason "stop requested")."""
    import os
    import sys
    import threading
    import time

    from mpi_knn_tpu_torch.resilience.worker import run_supervised

    script = ("import time, torch; torch.zeros(1, device='cuda'); "
              "open(__import__('sys').argv[1], 'w').close(); time.sleep(300)")
    up = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"tknn-up-{os.getpid()}")
    pids, stop, out = [], threading.Event(), {}
    th = threading.Thread(target=lambda: out.update(res=run_supervised(
        [sys.executable, "-c", script, up], beat_timeout_s=None,
        stop_event=stop, on_spawn=pids.append)), daemon=True)
    th.start()
    try:
        deadline = time.time() + 120
        while not os.path.exists(up) and time.time() < deadline:
            time.sleep(0.1)
        assert pids and os.path.exists(up)
        os.kill(pids[0], 0)
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive()
    assert out["res"].status == "timeout" and out["res"].reason == "stop requested"
    with pytest.raises(ProcessLookupError):
        os.kill(pids[0], 0)
    os.unlink(up)


# ---------------------------------------------------------------------------
# the profile surface, the sharded clustered index, the 2-D mesh


@pytest.mark.cuda
def test_profile_trace_counts_equal_the_counters(cuda_device, tmp_path):
    """A torch.profiler trace sees every hand-kernel launch the port's
    counters count: K1, K1[c] and their prologues (pallas tiles), K4 and
    its prologue (a P = 4 fused ring on the one card), the bin minimum
    (serial twolevel approx); and ServeSession.profile's window builds
    nothing and reports the same launches the trace holds."""
    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.obs.kineto import launch_mismatches, parse_trace
    from mpi_knn_tpu_torch.serve import ServeSession, build_index
    from mpi_knn_tpu_torch.ops import launch_counts
    from mpi_knn_tpu_torch.utils.timing import profile_trace

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.standard_normal((4096, 96)).astype(np.float32))
    Xd = X.to(cuda_device)
    windows = {
        "k1": lambda: all_knn(Xd, k=10, backend="pallas", device=cuda_device),
        "k1c": lambda: all_knn(Xd, k=10, backend="pallas",
                               precision_policy="mixed", device=cuda_device),
        "k4": lambda: all_knn(Xd, config=KNNConfig(
            k=10, backend="ring-overlap", ring_fusion="fused"),
            mesh=[cuda_device] * 4, device=cuda_device),
        "approx": lambda: all_knn(Xd, k=10, backend="serial",
                                  topk_method="approx", device=cuda_device),
    }
    for name, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        before = launch_counts()
        with profile_trace(str(tmp_path / name), cuda_device):
            fn()
            torch.cuda.synchronize()
        after = launch_counts()
        counted = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        assert counted, name
        events = parse_trace(str(tmp_path / name / "trace.json"))
        assert launch_mismatches(events, counted) == [], name
    idx = build_index(X, KNNConfig(k=10, backend="pallas", query_bucket=256),
                      device=cuda_device)
    sess = ServeSession(idx, device=cuda_device)
    Q = rng.standard_normal((256, 96)).astype(np.float32)
    out = sess.profile([Q] * 4, trace_dir=str(tmp_path / "serve"))
    assert out["compiles_in_window"] == []
    assert out["kernel_launches"] == {"fused_knn_tiles": 4, "stage_tf32_split": 4}
    events = parse_trace(str(tmp_path / "serve" / "trace.json"))
    assert launch_mismatches(events, out["kernel_launches"]) == []
    assert out["plane"] == "/device:GPU:0" and out["busy_ms"]["matmul"] > 0
    assert out["busy_total_ms"] == pytest.approx(sum(out["busy_ms"].values()),
                                                 abs=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_ivf_on_one_card_equals_unsharded(cuda_device, dtype):
    """S = 4 ranks on the one card: the sharded search and its served
    batches are bit for bit the unsharded index's; a tight route cap
    drops, counted."""
    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.ivf import (
        build_ivf_index,
        search_ivf,
        search_ivf_sharded,
        shard_ivf_index,
    )
    from mpi_knn_tpu_torch.serve import ServeSession

    rng = np.random.default_rng(1)
    cents = rng.standard_normal((32, 64)).astype(np.float32) * 4
    X = (cents[rng.integers(0, 32, 8192)]
         + rng.standard_normal((8192, 64)).astype(np.float32)).astype(np.float32)
    # query_tile 128: every search below cuts the same 128-row tiles, so
    # the finish's f64 products see the same batches
    idx = build_ivf_index(X, KNNConfig(k=10, partitions=32, nprobe=3,
                                       dtype=dtype, query_bucket=256,
                                       query_tile=128),
                          device=cuda_device)
    Q = X[:768] + 0.01
    d0, i0 = search_ivf(idx, Q, device=cuda_device)
    for S in (1, 4):
        sidx = shard_ivf_index(idx, mesh=[cuda_device] * S)
        d, i, stats = search_ivf_sharded(sidx, Q, device=cuda_device)
        assert torch.equal(i, i0) and torch.equal(d, d0)
        assert int(stats[:, 1].sum()) == 0 and int(stats[:, 0].sum()) > 0
    sess = ServeSession(sidx, device=cuda_device)
    for q in (Q[:256], Q[256:768]):
        got = list(sess.stream([q]))[0]
        want = search_ivf_sharded(sidx, q, device=cuda_device)
        assert np.array_equal(got.ids, want[1].cpu().numpy())
        assert np.array_equal(got.dists, want[0].cpu().numpy())
    tight = shard_ivf_index(idx, mesh=[cuda_device] * 4, route_cap=4)
    d, i, stats = search_ivf_sharded(tight, Q, device=cuda_device)
    assert int(stats[:, 1].sum()) > 0
    assert torch.isfinite(d[i >= 0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_sharded_ivf_across_cards_equals_unsharded(cuda_device, dtype, tmp_path):
    """Shards on distinct cards: each card holds its slice of the store and
    a replica of the centroids, and tiles, requests and candidate tiles
    move between cards. Over every visible card, and over two cards named
    twice each, the search and its served batches are bit for bit the
    unsharded index's on one card; a tight route cap drops, counted; the
    query CLI's ``--backend ring --devices S`` serves the saved index over
    the cards."""
    import json

    from mpi_knn_tpu_torch import KNNConfig
    from mpi_knn_tpu_torch.ivf import (
        build_ivf_index,
        save_ivf_index,
        search_ivf,
        search_ivf_sharded,
        shard_ivf_index,
    )
    from mpi_knn_tpu_torch.serve import ServeSession
    from mpi_knn_tpu_torch.serve import cli as serve_cli

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs at least two cards")
    rng = np.random.default_rng(1)
    cents = rng.standard_normal((30, 64)).astype(np.float32) * 4
    X = (cents[rng.integers(0, 30, 8192)]
         + rng.standard_normal((8192, 64)).astype(np.float32)).astype(np.float32)
    # 30 partitions: a shard count that does not divide them pads the last
    # card's slice with unreachable clusters
    idx = build_ivf_index(X, KNNConfig(k=10, partitions=30, nprobe=3,
                                       dtype=dtype, query_bucket=256,
                                       query_tile=128),
                          device=cuda_device)
    Q = X[:768] + 0.01
    d0, i0 = search_ivf(idx, Q, device=cuda_device)
    spread = [torch.device("cuda", c) for c in range(cards)]
    for mesh in (spread, [spread[0], spread[1]] * 2):
        sidx = shard_ivf_index(idx, mesh=mesh)
        assert sidx.shard_store is not None and sidx.buckets is None
        for s, d in enumerate(mesh):
            assert sidx.slices[s][0].device == d
            assert sidx.centroid_replica(d)[0].device == d
        d, i, stats = search_ivf_sharded(sidx, Q, device=cuda_device)
        assert torch.equal(i, i0) and torch.equal(d, d0), mesh
        assert int(stats[:, 1].sum()) == 0 and int(stats[:, 0].sum()) > 0
        sess = ServeSession(sidx, device=cuda_device)
        for q in (Q[:256], Q[256:768]):
            got = list(sess.stream([q]))[0]
            want = search_ivf_sharded(sidx, q, device=cuda_device)
            assert np.array_equal(got.ids, want[1].cpu().numpy())
            assert np.array_equal(got.dists, want[0].cpu().numpy())
        del sess
    tight = shard_ivf_index(idx, mesh=spread, route_cap=4)
    d, i, stats = search_ivf_sharded(tight, Q, device=cuda_device)
    assert int(stats[:, 1].sum()) > 0
    assert torch.isfinite(d[i >= 0]).all()
    path = save_ivf_index(idx, str(tmp_path / "i.npz"))
    report = tmp_path / "r.json"
    assert serve_cli.main(["--data", "synthetic:8192x64c30", "--index-load",
                           path, "--backend", "ring", "--devices", str(cards),
                           "--synthetic", "512", "--batch", "256",
                           "--bucket", "256", "-q", "--report",
                           str(report)]) == 0
    sh = json.loads(report.read_text())["sharded"]
    assert sh["shards"] == cards and len(sh["served_per_shard"]) == cards
    assert sh["routed_total"] > 0 and sh["overflow_dropped_total"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("extra,form", [
    ({}, "driver"), ({"ring_fusion": "fused", "ring_schedule": "bidir"}, "bidir"),
    ({"ring_fusion": "fused"}, "dma"),
    ({"ring_fusion": "fused", "ring_fused_rotation": "grid"}, "grid"),
])
def test_mesh2d_on_one_card_is_each_groups_1d_ring(cuda_device, extra, form):
    """A 2×2 mesh naming the card four times: each dp group's rows are bit
    for bit the 1-D P = 2 ring of the same transport over those rows, and
    the ids are serial's."""
    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.standard_normal((2048, 64)).astype(np.float32))
    Xd = X.to(cuda_device)
    cfg = KNNConfig(k=10, backend="ring-overlap", **extra)
    got = all_knn(Xd, config=cfg, device=cuda_device,
                  mesh=make_mesh2d(2, 2, devices=[cuda_device] * 4))
    half = 1024
    for g in range(2):
        rows = torch.arange(g * half, (g + 1) * half)
        one = all_knn(Xd, queries=Xd[rows], query_ids=rows.numpy(), config=cfg,
                      mesh=[cuda_device] * 2, device=cuda_device)
        assert torch.equal(got.ids[rows.to(cuda_device)], one.ids), form
        assert torch.equal(got.dists[rows.to(cuda_device)], one.dists), form
    want = all_knn(Xd, config=cfg.replace(backend="serial", ring_fusion="xla",
                                          ring_fused_rotation="round"),
                   device=cuda_device)
    assert (got.ids == want.ids).float().mean().item() >= 0.999


def _mp_recall(X):
    """recall@10 against the serial backend's ids on 256 rows, as the
    smoke's ``recall`` reads it."""
    from mpi_knn_tpu_torch import all_knn

    want = all_knn(X, k=10, backend="serial", device="cpu").ids.numpy()
    sample = np.linspace(0, len(X) - 1, 256, dtype=np.int64)

    def recall(ids):
        got = ids[torch.as_tensor(sample)].cpu().numpy()
        return float((want[sample][:, :, None] == got[:, None, :]).any(-1).mean())

    return recall


@pytest.mark.cuda
def test_multiproc_on_one_card_is_the_single_process_ring(cuda_device):
    """The smoke's multiproc phase at a small size: two processes on the
    one card (gloo, the boundary's blocks through host memory), each form
    and the resumed ring bit for bit the single-process P = 2 ring, process
    0's checkpoint deciding the resume, K4 once a round a process."""
    import chip_smoke
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build

    _build.build_all()  # the workers load what this process built
    X, _ = make_mnist_like(4096)
    launches, _, _ = chip_smoke.multiproc_phase(torch.device("cuda", 0), X,
                                                _mp_recall(X))
    assert launches["fused_round_dma"] == 2 + 1  # the one-shot, the stopped run
    assert launches["fused_block_merge[exact]"] == 2 + 1  # bidir, the last round


@pytest.mark.cuda
def test_multiproc_ranks_on_one_card_is_the_single_process_ring(cuda_device):
    """The smoke's pod at a small size with two ranks a process on the one
    card (cuda:0 named twice in each of two processes): every form, the
    grid form (K5 across the processes over CUDA IPC) and --dp 2 among
    them, bit for bit the single-process P = 4 ring (--dp: the 2 × 2
    mesh), with the smoke's launch and boundary gates; K5 once a process,
    no block moved by the process group."""
    import chip_smoke
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build

    _build.build_all()
    X, _ = make_mnist_like(4096)
    _, ranks, _ = chip_smoke.multiproc_phase(torch.device("cuda", 0), X,
                                             _mp_recall(X), ranks=2)
    assert ranks["fused_rotation_grid"] == 1 + 1  # the 1-D ring, --dp 2
    assert ranks["fused_round_dma"] == 4 + 1 + 2 + 2  # 1-D, stopped, resumed, --dp


@pytest.mark.cuda
def test_multiproc_hosts_k5_on_one_card_is_the_ipc_form(cuda_device):
    """The smoke's multiproc_hosts phase at a small size: the 2 × 2 pod on
    the one card, its workers reporting hosts h0 and h1, runs K5 over the
    host proxy at both boundaries, bit for bit the single-process K5 ring
    and the IPC form, one K5 launch a process, no CUDA IPC mapping, the
    proxy's bytes 3 hops of block + ids + norms (the phase's gates)."""
    import chip_smoke
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build

    _build.build_all()
    X, _ = make_mnist_like(4096)
    recall = _mp_recall(X)
    _, _, k5 = chip_smoke.multiproc_phase(torch.device("cuda", 0), X, recall, ranks=2)
    launches = chip_smoke.multiproc_hosts_phase(X, recall, k5)
    assert launches["fused_rotation_grid"] == 1


@pytest.mark.cuda
def test_multiproc_across_cards_equals_the_single_process_ring(cuda_device, tmp_path):
    """Four processes, one card each (NCCL moves the boundary's blocks): the
    fused-dma, bidir and resumable rings bit for bit the single-process
    4-card ring (K4's in-kernel peer stores), and the sharded clustered
    index over four processes bit for bit the one-process distinct-card
    layout. Skips below four cards."""
    import chip_smoke
    from mpi_knn_tpu_torch import KNNConfig, all_knn
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ivf import (
        build_ivf_index,
        save_ivf_index,
        search_ivf_sharded,
        shard_ivf_index,
    )
    from mpi_knn_tpu_torch.ops import _build

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _build.build_all()
    cards = [torch.device("cuda", c) for c in range(4)]
    m = 8192
    X, _ = make_mnist_like(m)
    Xd = torch.from_numpy(X).to(cards[0])
    single = {}
    for label, over in chip_smoke.MP_FORMS:
        one = all_knn(Xd, config=KNNConfig(k=10, backend="ring-overlap", **over),
                      mesh=cards, device=cards[0])
        single[label] = (one.ids.cpu().numpy(), one.dists.cpu().numpy())
    single[chip_smoke.MP_RESUMABLE] = single["fused-dma/K4"]
    idx = build_ivf_index(X, KNNConfig(k=10, partitions=30, nprobe=3,
                                       query_tile=128), device=cards[0])
    Q = X[:768] + np.float32(0.01)
    save_ivf_index(idx, str(tmp_path / "index.npz"))
    np.save(tmp_path / "queries.npy", Q)
    wd, wi, wstats = search_ivf_sharded(shard_ivf_index(idx, mesh=cards), Q,
                                        device=cards[0])
    # one host: NCCL's bootstrap on the loopback interface
    env = {"MP_STOP": "2", "MP_IVF": "1",
           "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")}
    got = chip_smoke.multiproc_pod(str(tmp_path), m, 4, env=env)
    for doc, arrays, _ in got:
        assert doc["info"]["backend"] == "nccl+gloo", doc["info"]
        for label, (ids, dists) in single.items():
            assert np.array_equal(arrays[f"{label}/ids"], ids), label
            assert np.array_equal(arrays[f"{label}/dists"], dists), label
        res = doc["forms"][chip_smoke.MP_RESUMABLE]
        assert res["rounds_resumed"] == [3, 4]
        assert doc["forms"]["fused-dma/K4"]["launches"]["fused_round_dma"] == 4
        assert np.array_equal(arrays["ivf/ids"], wi.cpu().numpy())
        assert np.array_equal(arrays["ivf/dists"], wd.cpu().numpy())
        assert np.array_equal(arrays["ivf/stats"], wstats.cpu().numpy())
    assert (tmp_path / "ck-proc0" / "knn_state.npz").exists()
    assert not any((tmp_path / f"ck-proc{p}" / "knn_state.npz").exists()
                   for p in (1, 2, 3))


@pytest.mark.cuda
def test_multiproc_ranks_across_cards_equals_the_single_process_ring(cuda_device,
                                                                     tmp_path):
    """Two processes of two cards each (cards {0, 1} and {2, 3}; NCCL
    between the processes through each one's first card, K4's peer stores
    inside each): fused-dma, bidir, xla, grid (K5 over CUDA IPC between
    cards of one host), the resumable ring and --dp 2 bit for bit the
    single-process 4-card ring (--dp: the 4-card 2 × 2 mesh). Skips below
    four cards."""
    import chip_smoke
    from mpi_knn_tpu_torch.data.synthetic import make_mnist_like
    from mpi_knn_tpu_torch.ops import _build
    from mpi_knn_tpu_torch.parallel.mesh import make_mesh2d

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    _build.build_all()
    cards = [torch.device("cuda", c) for c in range(4)]
    m = 8192
    X, _ = make_mnist_like(m)
    Xd = torch.from_numpy(X).to(cards[0])
    single = chip_smoke._single_forms(cards[0], Xd, cards, chip_smoke.MP_RANK_FORMS)
    single.update(chip_smoke._single_forms(
        cards[0], Xd, make_mesh2d(2, 2, devices=cards), chip_smoke.MP_DP_FORMS))
    single[chip_smoke.MP_RESUMABLE] = single["fused-dma/K4"]
    env = {"MP_RANKS": "2",
           "NCCL_SOCKET_IFNAME": os.environ.get("NCCL_SOCKET_IFNAME", "lo")}
    got = chip_smoke.multiproc_pod(str(tmp_path), m, 2, env=env)
    for pid, (doc, arrays, _) in enumerate(got):
        info = doc["info"]
        assert info["backend"] == "nccl+gloo", info
        assert info["cards"] == [f"cuda:{2 * pid}", f"cuda:{2 * pid + 1}"], info
        for label, (ids, dists, _, _) in single.items():
            assert np.array_equal(arrays[f"ranks/{label}/ids"], ids), label
            assert np.array_equal(arrays[f"ranks/{label}/dists"], dists), label
        ranks = doc["ranks"]
        assert ranks["fused-grid/K5"]["launches"]["fused_rotation_grid"] == 2  # a card
        assert ranks["fused-grid/K5"]["boundary"]["exchanges"] == 0
        assert ranks["fused-dma/K4"]["boundary"]["exchanges"] == 3
        assert ranks["fused-dma/K4"]["launches"]["fused_round_dma"] == 4 * 2
        assert ranks[chip_smoke.MP_RESUMABLE]["rounds_resumed"] == [2, 3, 4]
    assert (tmp_path / "ck-ranks-proc0" / "knn_state.npz").exists()
    assert not (tmp_path / "ck-ranks-proc1" / "knn_state.npz").exists()


def _sm_small(monkeypatch):
    """The smoke's sharded_mutation phase at a test's size: 20000 rows of
    the deployment's distribution, 64 partitions, 256-row session batches
    (the pod's workers read the sizes from the saved plan)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "IVF_M", 20000)
    monkeypatch.setattr(chip_smoke, "IVF_P", 64)
    monkeypatch.setattr(chip_smoke, "IVF_QUERIES", 4096)
    monkeypatch.setattr(chip_smoke, "SM_BATCH", 256)
    return chip_smoke


@pytest.mark.cuda
def test_sharded_mutation_across_cards_equals_one_card(cuda_device, monkeypatch,
                                                       tmp_path):
    """One process, four shards over the visible cards (slices on distinct
    cards): the smoke's churn (upserts, partition-moving updates, deletes,
    a compaction with retrain, a burst that overflows, compacts and grows)
    and sessions with churn between batches; after every step each
    shard's checksums, the centroids and a search equal the one-card
    store's, and the final slices and every session batch bit for bit.
    Skips below two cards."""
    from mpi_knn_tpu_torch.ops import _build

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs at least two cards")
    cs = _sm_small(monkeypatch)
    _build.build_all()
    cards = [torch.device("cuda", c % n) for c in range(cs.SHARDS)]
    cs.sm_prepare(cards[0], str(tmp_path))
    single = cs.sm_drive(cards[0], [cards[0]] * cs.SHARDS, str(tmp_path), cs.sync_all)
    spread = cs.sm_drive(cards[0], cards, str(tmp_path), cs.sync_all)
    cs.sm_gates("across_cards", single, [(*spread, 0.0)], cs.SHARDS)


@pytest.mark.cuda
def test_multiproc_sharded_mutation_on_one_card(cuda_device, monkeypatch):
    """The smoke's sharded_mutation phase at a small size: two processes of
    two shards each on the one card (gloo) against the one-process 4-shard
    store, bit for bit after every step and in both sessions, both
    processes on the same rung at every seq."""
    from mpi_knn_tpu_torch.ops import _build

    cs = _sm_small(monkeypatch)
    _build.build_all()
    cs.sharded_mutation_phase(torch.device("cuda", 0))


@pytest.mark.cuda
def test_multiproc_sharded_mutation_across_cards(cuda_device, monkeypatch):
    """The four-card form of the smoke's sharded_mutation run at a small
    size: one process with its four slices on four cards, and two
    processes of two cards each over NCCL, each bit for bit the one-card
    store. Skips below four cards."""
    from mpi_knn_tpu_torch.ops import _build

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    cs = _sm_small(monkeypatch)
    _build.build_all()
    cs.sharded_mutation_cards([torch.device("cuda", c) for c in range(4)])


# ---------------------------------------------------------------------------
# the lint on the card


@pytest.mark.cuda
@pytest.mark.parametrize("label,overrides,kernel", [
    ("pallas/l2/float32", None, "fused_knn_tiles"),
    ("pallas/l2/float32/mixed", None, "fused_knn_tiles[compress]"),
    ("ring-overlap/l2/float32/fused", None, "fused_round_dma"),
    ("ring-overlap/l2/float32/mixed/fused", None, "fused_block_merge[compress]"),
    ("ring-overlap/l2/float32/bidir/fused", None, "fused_block_merge[exact]"),
    ("ivf/l2/float32/mixed/int8/serve", None, None),
    ("pallas/l2/float32", {"pallas_variant": "sweep"}, "fused_knn_sweep"),
    ("pallas/l2/float32/mixed", {"pallas_variant": "sweep"},
     "fused_knn_sweep[compress]"),
    ("ring-overlap/l2/float32/fused", {"ring_fused_rotation": "grid"},
     "fused_rotation_grid"),
    ("serial/l2/float32", {"topk_method": "approx"}, "approx_min_k")])
def test_lint_cells_on_the_card(cuda_device, label, overrides, kernel):
    """A cell of each kernel the matrix reaches, and the variants that
    reach the rest, on the hand kernels: no finding, the kernel launched,
    the side-band's FLOPs inside the counted ones that equal the closed
    form, the allocator's growth inside R7's band."""
    from mpi_knn_tpu_torch.analysis import engine, lowering
    from mpi_knn_tpu_torch.analysis.memory import ALLOCATOR_BAND

    (target,) = [t for t in lowering.default_targets() if t.label == label]
    res = engine.lint_target(target, device=cuda_device, overrides=overrides)
    assert res.findings == [] and res.stages == ["cuda"]
    assert kernel is None or res.launches.get(kernel, 0) > 0
    assert res.cost["mxu_flops"] == res.cost["analytical_flops"]
    # the product kernels' side-band FLOPs (the bin minimum has none)
    assert (res.cost["kernel_flops"] > 0) == label.startswith(("pallas", "ring"))
    m = res.memory
    assert (m["peak_alloc_bytes"] - ALLOCATOR_BAND[0] <= m["measured_bytes"]
            <= m["peak_alloc_bytes"] + ALLOCATOR_BAND[1])
