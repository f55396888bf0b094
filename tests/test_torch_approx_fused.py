"""The fused form of the approximate methods (``approx_smallest_k``, one
launch for ``smallest_k``'s "approx" and "approx-rerank" branches) and the
bin-minimum kernel's launch plan, on the CPU.

The fused form's plain version is held bit for bit (values and ids) to the
chain ``smallest_k`` ran before it (lane padding, the bin minimum, the id
gather, for "approx-rerank" the exact finish over all L winners, the mask),
and to the direct reading the kernel computes: the first k of the L bin
winners sorted by (value, column). Where the reduction is exact it equals
the JAX package's ``smallest_k``. The plan is checked for its regimes and
its chunk and list arithmetic; a model of the kernel's passes built on it
gives the plain version's winners."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_knn_tpu.ops import topk as ref_topk
from mpi_knn_tpu_torch.ops import topk
from mpi_knn_tpu_torch.ops.approx_topk import (
    _order_keys,
    approx_min_k_reference,
    approx_smallest_k,
    approx_smallest_k_reference,
    launch_plan,
    reduction_width,
)
from mpi_knn_tpu_torch.types import INVALID_ID

# the main path's shapes, narrowed in rows: (rows, columns, 1-D ids)
SHAPES = {"tile": (16, 2048, True), "stream": (16, 2058, False),
          "merge": (16, 300, False)}
CASES = [("tile", "approx", 10), ("tile", "approx-rerank", 10),
         ("stream", "approx", 10), ("stream", "approx-rerank", 10),
         ("merge", "approx", 10), ("tile", "approx", 1),
         ("stream", "approx-rerank", 1)]
DATA = ("distinct", "ties", "inf", "zeros_nan")


def _tile(shape, data, seed=0):
    q, c, flat = SHAPES[shape]
    rng = np.random.default_rng(seed)
    if data == "distinct":
        d = rng.standard_normal((q, c)).astype(np.float32) ** 2
    else:  # a few values, each tied many times
        d = rng.integers(0, 5, (q, c)).astype(np.float32)
    if data == "inf":
        d[:, ::3] = np.inf
        d[1] = np.inf
        d[2, : c // 2] = -np.inf
    elif data == "zeros_nan":
        d[0, ::2] = -0.0
        d[1] = 0.0
        d[3, ::7] = np.nan
        d[4] = np.nan
    ids = np.arange(c, dtype=np.int32) * 3 + 7
    ids = ids if flat else ids[None] + 100000 * np.arange(q, dtype=np.int32)[:, None]
    return torch.from_numpy(d), torch.from_numpy(ids)


def _chain(dists, ids, k, method, rt):
    """``smallest_k``'s approximate branches as they ran before the fused
    form, written out here."""
    q, c = dists.shape
    if ids.ndim == 1:
        ids = ids[None, :].expand(q, c)
    pad = -c % 128
    dists = torch.cat([dists, dists.new_full((q, pad), float("inf"))], -1)
    ids = torch.cat([ids, ids.new_full((q, pad), INVALID_ID)], -1)
    if method == "approx-rerank":
        dists, pos = approx_min_k_reference(dists.contiguous(), 4 * k, rt,
                                            aggregate_to_topk=False)
        ids = torch.gather(ids, -1, pos)
        vals, order = torch.sort(dists, dim=-1, stable=True)
        vals, out = vals[..., :k], torch.gather(ids, -1, order[..., :k])
    else:
        vals, pos = approx_min_k_reference(dists.contiguous(), k, rt)
        out = torch.gather(ids, -1, pos)
    return vals, torch.where(torch.isinf(vals), INVALID_ID, out)


def _direct(dists, ids, k, method, rt):
    """What the kernel computes: the first k of the L bin winners by
    (value, column) key, their ids gathered, -1 on +-inf values."""
    q, c = dists.shape
    n_pad = -(-c // 128) * 128
    L = reduction_width(n_pad, 4 * k if method == "approx-rerank" else k, rt)
    d = torch.cat([dists, dists.new_full((q, n_pad - c), float("inf"))], -1)
    keys = _order_keys(d)
    pad = -n_pad % L
    keys = torch.cat([keys, torch.full((q, pad), np.iinfo(np.int64).max)], -1)
    win = torch.sort(keys.view(q, -1, L).amin(1), -1).values[:, :min(k, L)]
    pos = win & 0xFFFFFFFF
    vals = torch.gather(d, 1, pos)
    full = ids[None].expand(q, c) if ids.ndim == 1 else ids
    got = torch.gather(full, 1, pos.clamp(max=c - 1))
    return vals, torch.where(torch.isinf(vals), INVALID_ID, got)


def _bitwise(a, b):
    assert a[0].shape == b[0].shape
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("shape,method,k", CASES)
def test_fused_plain_equals_the_chain_bitwise(shape, method, k, data):
    d, ids = _tile(shape, data)
    want = _chain(d, ids, k, method, 0.95)
    _bitwise(approx_smallest_k_reference(d, ids, k, method, 0.95), want)
    _bitwise(approx_smallest_k(d, ids, k, method, 0.95), want)
    _bitwise(topk.smallest_k(d, ids, k, method=method), want)
    _bitwise(_direct(d, ids, k, method, 0.95), want)


def test_the_chain_is_the_direct_reading_on_random_shapes():
    """approx-rerank's exact finish over the L winners returns their first
    k: 120 random shapes, tied integer values, 5 % +inf."""
    rng = np.random.default_rng(9)
    for _ in range(120):
        q, c, k = int(rng.integers(1, 6)), int(rng.integers(50, 2500)), int(rng.integers(1, 41))
        method = ("approx", "approx-rerank")[int(rng.integers(0, 2))]
        if c <= (4 * k if method == "approx-rerank" else k):
            continue
        d = rng.integers(0, 9, (q, c)).astype(np.float32)
        d[rng.random((q, c)) < 0.05] = np.inf
        ids = torch.from_numpy(rng.permutation(c).astype(np.int32))
        d = torch.from_numpy(d)
        _bitwise(_direct(d, ids, k, method, 0.9), _chain(d, ids, k, method, 0.9))


@pytest.mark.parametrize("method,c,k", [
    ("approx", 100, 5), ("approx", 2048, 1), ("approx", 2058, 1),
    ("approx-rerank", 300, 40), ("approx-rerank", 120, 10),
])
def test_fused_equals_jax_where_the_reduction_is_exact(method, c, k):
    n_pad = -(-c // 128) * 128
    L = reduction_width(n_pad, 4 * k if method == "approx-rerank" else k)
    assert L == n_pad or (k == 1 and method == "approx")
    rng = np.random.default_rng(4)
    d = (rng.standard_normal((6, c)) ** 2).astype(np.float32)
    ids = np.tile(np.arange(c, dtype=np.int32) * 3 + 7, (6, 1))
    gv, gi = approx_smallest_k(torch.from_numpy(d), torch.from_numpy(ids), k,
                               method)
    wv, wi = ref_topk.smallest_k(jnp.asarray(d), jnp.asarray(ids), k,
                                 method=method)
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gi.numpy(), np.asarray(wi))


def test_fused_refuses_what_the_chain_refuses():
    d, ids = _tile("tile", "distinct")
    with pytest.raises(TypeError, match="float32"):
        approx_smallest_k(d.half(), ids, 10, "approx")
    with pytest.raises(ValueError, match="not approximate"):
        approx_smallest_k(d, ids, 10, "exact")
    with pytest.raises(ValueError, match="outside"):
        approx_smallest_k(d, ids, 200, "approx", 0.1)


# ------------------------------------------------------------ launch plan

@pytest.mark.parametrize("L,regime", [
    (100, "warp"), (128, "warp"), (256, "warp"), (384, "warp"),
    (1024, "warp"), (1152, "cta"), (4096, "cta"), (8192, "cta"),
    (8320, "two_pass"), (16384, "two_pass"), (50048, "two_pass"),
    (60000, "two_pass"), (301, "warp"), (1155, "cta"), (20481, "two_pass"),
])
@pytest.mark.parametrize("out", [1, 10, 40])
def test_the_plan_picks_its_regime_by_width(L, regime, out):
    plan = launch_plan(1024, max(L, 2176), L, out)
    assert plan["regime"] == regime
    assert plan["G"] in (1, 2, 4, 8) and plan["chunk"] <= 128 * plan["G"]
    assert (plan["chunks"] - 1) * plan["chunk"] < L <= plan["chunks"] * plan["chunk"]
    assert plan["select"] == ("rounds" if min(out, plan["chunk"]) <= 32 else "sort")
    assert plan["threads"] <= 1024 and plan["shared_bytes"] <= 227 * 1024
    if regime == "warp":
        assert (plan["chunks"], plan["rows_per_cta"], plan["grid"]) == (1, 4, 256)
        assert plan["passes"] == 1 and plan["scratch_keys"] == 0
    elif regime == "cta":
        assert (plan["rows_per_cta"], plan["grid"], plan["passes"]) == (1, 1024, 1)
        assert plan["threads"] == 32 * plan["chunks"] and plan["scratch_keys"] == 0
    else:
        assert plan["passes"] >= 2 and plan["scratch_keys"] > 0


def test_the_main_path_plans():
    """The five path shapes of the fused form: a warp a row but for the
    stream step's approx-rerank (L = 1152), a CTA of 3 warps a row."""
    got = {}
    for name, rows, c, asked in (("tile_k10", 1024, 2048, 10),
                                 ("tile_rerank", 1024, 2048, 40),
                                 ("stream_k10", 1024, 2176, 10),
                                 ("stream_rerank", 1024, 2176, 40),
                                 ("merge_k10", 60416, 384, 10)):
        L = reduction_width(c, asked)
        p = launch_plan(rows, c, L, 10)
        got[name] = (L, p["regime"], p["G"], p["chunks"], p["select"])
    assert got == {"tile_k10": (256, "warp", 2, 1, "rounds"),
                   "tile_rerank": (1024, "warp", 8, 1, "rounds"),
                   "stream_k10": (384, "warp", 4, 1, "rounds"),
                   "stream_rerank": (1152, "cta", 4, 3, "rounds"),
                   "merge_k10": (256, "warp", 2, 1, "rounds")}


def _model(x, L, out):
    """The kernel's passes by its plan, in numpy: chunk minima, each
    chunk's min(out, chunk) smallest (missing keys as the largest), merges
    of 32 lists into min(out, 32 len), the last merge's out smallest."""
    rows, n = x.shape
    plan = launch_plan(rows, n, L, out)
    none = np.iinfo(np.int64).max
    keys = _order_keys(torch.from_numpy(x)).numpy()
    keys = np.concatenate([keys, np.full((rows, -n % L), none)], 1)
    wins = keys.reshape(rows, -1, L).min(1)
    ch = plan["chunk"]
    length = out if plan["regime"] != "two_pass" else min(out, ch)
    lists = []
    for i in range(plan["chunks"]):
        part = np.sort(wins[:, i * ch:(i + 1) * ch], 1)[:, :length]
        lists.append(np.pad(part, ((0, 0), (0, length - part.shape[1])),
                            constant_values=none))
    while len(lists) > 32:
        length = min(out, 32 * length)
        lists = [np.sort(np.concatenate(lists[g:g + 32], 1), 1)[:, :length]
                 for g in range(0, len(lists), 32)]
    return np.sort(np.concatenate(lists, 1), 1)[:, :out] & 0xFFFFFFFF


@pytest.mark.parametrize("n,k,rt,aggregate", [
    (2048, 10, 0.95, True), (2176, 40, 0.95, False), (2176, 10, 0.95, True),
    (20480, 120, 0.99, True), (40000, 100, 0.99, False),
    (100000, 256, 0.99, True), (60000, 128, 0.999, True),
    (301, 10, 0.95, True), (301, 10, 0.95, False), (1155, 40, 0.95, True),
    (1155, 40, 0.95, False), (20481, 120, 0.99, True),
    (20481, 120, 0.99, False),
])
def test_the_plan_model_gives_the_plain_winners(n, k, rt, aggregate):
    x = np.random.default_rng(3).integers(0, 50, (2, n)).astype(np.float32)
    L = reduction_width(n, k, rt)
    out = k if aggregate else L
    _, pos = approx_min_k_reference(torch.from_numpy(x), k, rt, aggregate)
    assert np.array_equal(_model(x, L, out), pos.numpy())
