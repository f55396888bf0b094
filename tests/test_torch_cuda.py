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
        "stage_tf32_split": 0, "stage_bf16": 4}
    assert fused_ring.LAUNCHES == {"fused_block_merge[exact]": 0,
                                   "fused_block_merge[compress]": 1,
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
        "stage_tf32_split": 3, "stage_bf16": 0}
    assert fused_ring.LAUNCHES == {"fused_block_merge[exact]": 2,
                                   "fused_block_merge[compress]": 0,
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
    """(tensor, k, aggregate) of the approx kernel's shapes on the main
    path, and its edge rows."""
    from mpi_knn_tpu_torch.ops.approx_topk import approx_min_k  # noqa: F401

    rng = np.random.default_rng(11)
    shapes = {"tile_k10": (1024, 2048, 10, True),
              "tile_rerank": (1024, 2048, 40, False),
              "stream_k10": (1024, 2176, 10, True),
              "stream_rerank": (1024, 2176, 40, False),
              "merge_k10": (60416, 384, 10, True),
              "k1": (512, 2048, 1, True)}
    if name in shapes:
        R, n, k, agg = shapes[name]
        x = rng.standard_normal((R, n)).astype(np.float32)
        return torch.from_numpy(x).to(device), k, agg
    x = rng.integers(0, 4, (64, 2048)).astype(np.float32)  # planted ties
    if name == "inf_padding":
        x[:, 1500:] = np.inf
        x[3] = np.inf
    elif name == "zeros_nan":
        x[1, ::3] = -0.0
        x[2] = 0.0
        x[4, ::5] = np.nan
    return torch.from_numpy(x).to(device), 10, name != "ties_raw"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tile_k10", "tile_rerank", "stream_k10",
                                  "stream_rerank", "merge_k10", "k1", "ties",
                                  "ties_raw", "inf_padding", "zeros_nan"])
def test_approx_kernel_equals_plain(cuda_device, name):
    from mpi_knn_tpu_torch.ops import approx_topk

    x, k, agg = _approx_case(name, cuda_device)
    before = approx_topk.LAUNCHES["approx_min_k"]
    gv, gp = approx_topk.approx_min_k(x, k, 0.95, agg)
    torch.cuda.synchronize()
    wv, wp = approx_topk.approx_min_k_reference(x, k, 0.95, agg)
    assert approx_topk.LAUNCHES["approx_min_k"] == before + 1
    assert torch.equal(gp, wp)
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))


@pytest.mark.cuda
def test_approx_kernel_refuses_a_width_past_its_bound(cuda_device):
    from mpi_knn_tpu_torch.ops import approx_topk

    x = torch.zeros((2, 20480), device=cuda_device)
    L = approx_topk.reduction_width(20480, 120, 0.99)
    before = approx_topk.LAUNCHES["approx_min_k"]
    with pytest.raises(ValueError, match=f"L={L} exceeds"):
        approx_topk.approx_min_k(x, 120, 0.99)
    assert approx_topk.LAUNCHES["approx_min_k"] == before


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
