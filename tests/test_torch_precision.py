"""``matmul_precision="default"`` / ``"high"`` in the port, on the CPU.

The JAX package documents them as throughput choices: on the TPU DEFAULT
rounds each f32 operand to bf16 and multiplies once, HIGH splits each into
bf16 hi + lo and multiplies three times. JAX on the CPU ignores the
precision and multiplies in f32, so the CPU cannot show the rounding there.
The port's plain versions are held instead to an f64 oracle of the rounded
operands (bf16 rounding by JAX's own ``astype``), every path at both
precisions, and to the JAX package by recall. Data are random normal rows
(no exact duplicates, no distance ties), made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.backends.ring import all_knn_ring
from mpi_knn_tpu_torch.convert import config_from_reference
from mpi_knn_tpu_torch.ops import fused_knn, fused_ring, fused_rotation
from mpi_knn_tpu_torch.ops.distance import _mm_t, resolve_precision
from tests.oracle import recall_against_oracle

CPU = "cpu"
PRECISIONS = ["default", "high"]
K = 5
PATHS = {
    "serial": dict(backend="serial"),
    "pallas_tiles": dict(backend="pallas", pallas_variant="tiles"),
    "pallas_sweep": dict(backend="pallas", pallas_variant="sweep"),
    "ring_xla": dict(backend="ring", num_devices=4),
    "ring_fused_uni": dict(backend="ring-overlap", num_devices=4, ring_fusion="fused"),
    "ring_fused_bidir": dict(backend="ring-overlap", num_devices=4,
                             ring_fusion="fused", ring_schedule="bidir"),
    "ring_overlap": dict(backend="ring-overlap", num_devices=4),
}
# recall against the JAX package (f32 products on the CPU): what bf16
# rounding (2^-9 relative per operand) and the split (~2^-17) may cost on
# 24-wide rows
JAX_RECALL = {"default": 0.9, "high": 0.99}


def _data(seed, m=256, d=24):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(np.float32)


def _bf16(x):
    """f32 values rounded to bf16 by JAX (nearest even), as f64."""
    return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float64))


def _oracle_dots(q, c, precision):
    """q · cᵀ in f64 on the operands the precision multiplies."""
    q, c = np.asarray(q, np.float32), np.asarray(c, np.float32)
    if precision == "default":
        return _bf16(q) @ _bf16(c).T
    qh, ch = _bf16(q), _bf16(c)
    ql = _bf16((q - qh).astype(np.float32))
    cl = _bf16((c - ch).astype(np.float32))
    return ql @ ch.T + qh @ cl.T + qh @ ch.T


def _oracle(q, c, precision, all_pairs):
    """The rounded-operand oracle's squared distances (f32 norms, the
    rounded product), masked as the paths mask (self, zero rule)."""
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    qs, cs = (q64 ** 2).sum(1)[:, None], (c64 ** 2).sum(1)[None, :]
    d = np.maximum(qs + cs - 2.0 * _oracle_dots(q, c, precision), 0.0)
    d[d <= 1e-6 * (qs + cs)] = np.inf
    if all_pairs:
        np.fill_diagonal(d, np.inf)
    return d, qs + cs


def _check_against_oracle(got, q, c, precision, all_pairs):
    d, scale = _oracle(q, c, precision, all_pairs)
    order = np.argsort(d, axis=1, kind="stable")[:, :K]
    od = np.take_along_axis(d, order, 1)
    gi, gd = got.ids.cpu().numpy(), got.dists.cpu().numpy().astype(np.float64)
    assert recall_against_oracle(gi, od, order, K) == 1.0
    own = np.take_along_axis(d, gi, 1)
    tol = 1e-5 * np.take_along_axis(np.broadcast_to(scale, d.shape), gi, 1)
    assert (np.abs(gd - own) <= tol).all()


def _centered(X, Q=None):
    mu = X.astype(np.float64).mean(0)
    Xc = (X - mu).astype(np.float32)
    return Xc, (Xc if Q is None else (Q - mu).astype(np.float32))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("path", list(PATHS))
def test_paths_hold_to_the_rounded_operand_oracle_and_to_jax(path, precision):
    """Every exact path at the precision: ids tie-aware the oracle's, each
    distance within 1e-5 (q² + c²) of its own oracle key; the JAX package
    (which multiplies in f32 on the CPU) by recall."""
    X = _data(0)
    kw = dict(k=K, query_tile=32, corpus_tile=128, matmul_precision=precision,
              **PATHS[path])
    got = all_knn(X, device=CPU, **kw)
    Xc, _ = _centered(X)
    _check_against_oracle(got, Xc, Xc, precision, True)
    jax_kw = {**kw, "ring_fusion": "xla"} if "ring" in path else kw
    want = jax_pkg.all_knn(X, **jax_kw)
    rec = recall_against_oracle(got.ids.numpy(), np.asarray(want.dists),
                                np.asarray(want.ids), K)
    assert rec >= JAX_RECALL[precision], rec


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("form", ["dma", "grid"])
def test_transport_forms_hold_to_the_driver_ring(form, precision):
    """K4's and K5's plain versions (one round per launch, the whole
    rotation) at the precision equal the driver-transport ring bit for
    bit, and the query mode holds to the oracle."""
    X, Q = _data(1), _data(2, m=40)
    Xc, Qc = _centered(X, Q)
    qids = np.full(40, -1, np.int32)
    devices = [torch.device(CPU)] * 4
    cfg = KNNConfig(k=K, backend="ring-overlap", ring_fusion="fused",
                    query_tile=16, corpus_tile=64, matmul_precision=precision)
    got = all_knn_ring(Xc, Qc, qids, cfg, mesh=devices, device=CPU, form=form)
    want = all_knn_ring(Xc, Qc, qids, cfg, mesh=devices, device=CPU, form="driver")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _check_against_oracle(type("R", (), {"ids": got[1], "dists": got[0]}), Qc, Xc,
                          precision, False)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("compute", ["mm_t", "tile_dots"])
def test_products_equal_their_definition(precision, compute):
    """``_mm_t`` (and the tile hook's plain form) at the precision is the
    f32 product of the rounded operands, the rounding JAX's astype."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((33, 40)).astype(np.float32)
    c = rng.standard_normal((50, 40)).astype(np.float32)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    got = (_mm_t(tq, tc, precision) if compute == "mm_t"
           else fused_knn.exact_tile_dots(tq, tc, precision)).numpy()
    want = _oracle_dots(q, c, precision)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    full = q.astype(np.float64) @ c.astype(np.float64).T
    if precision == "default":  # the operands really were rounded
        assert np.abs(got - full).max() > 1e-4
    else:
        assert np.abs(got - full).max() <= 1e-3


def test_precision_leaves_f64_and_bf16_operands_alone():
    rng = np.random.default_rng(4)
    for dtype in (torch.float64, torch.bfloat16):
        q = torch.from_numpy(rng.standard_normal((8, 16))).to(dtype)
        c = torch.from_numpy(rng.standard_normal((9, 16))).to(dtype)
        base = _mm_t(q, c)
        for p in ("default", "high", "highest"):
            assert torch.equal(_mm_t(q, c, p), base)
    assert resolve_precision(None, torch.bfloat16) == "default"
    assert resolve_precision(None, torch.float32) == "highest"


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("name", ["fused_knn_tiles", "fused_knn_sweep"])
def test_fused_plain_versions_hold_to_the_oracle(name, precision):
    """K1's and K2's plain versions at the precision, query mode with a
    ragged padded corpus (m 250 of 256)."""
    X, Q = _data(5), _data(6, m=32)
    Xp = np.zeros((256, 24), np.float32)
    Xp[:250] = X[:250]
    got = getattr(fused_knn, name + "_reference")(
        torch.from_numpy(Q), torch.from_numpy(Xp), 250, K, 32, 128,
        all_pairs=False, precision=precision)
    if name == "fused_knn_tiles":  # each tile's k survivors, merged here
        got = fused_knn._select(*got, K)
    res = type("R", (), {"dists": got[0], "ids": got[1]})
    _check_against_oracle(res, Q, X[:250], precision, False)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_ring_plain_merges_hold_to_the_oracle(wire, precision):
    """K3a's, K4's and K5's plain versions at the precision from an empty
    carry (one rank, one block) against the oracle of the wire's rows."""
    X, Q = _data(7, m=128), _data(8, m=32)
    blk = torch.from_numpy(X)
    if wire == "bfloat16":
        blk = blk.to(torch.bfloat16)
    bids = torch.arange(128, dtype=torch.int32)
    qids = torch.full((32,), -1, dtype=torch.int32)
    carry = (torch.full((32, K), float("inf")), torch.full((32, K), -1, dtype=torch.int32))
    q = torch.from_numpy(Q)
    outs = [fused_ring.block_merge_exact_reference(
        q, qids, blk, bids, None, *carry, c_tile=64, precision=precision)]
    outs.append(fused_rotation.fused_round_dma_reference(
        [q], [qids], [(blk, bids, None)], [carry],
        [fused_rotation.slot(fused_rotation.landing_slots(blk, bids, None), 0)],
        c_tile=64, precision=precision)[0])
    outs.append(fused_rotation.fused_rotation_grid_reference(
        [q], [qids], [(blk, bids, None)], [carry],
        [fused_rotation.landing_slots(blk, bids, None)], c_tile=64,
        precision=precision)[0])
    rows = blk.float().numpy()
    for d, i in outs:
        assert torch.equal(i, outs[0][1]) and torch.equal(d, outs[0][0])
    _check_against_oracle(type("R", (), {"dists": outs[0][0], "ids": outs[0][1]}),
                          Q, rows, precision, False)


@pytest.mark.parametrize("setting", [
    dict(matmul_precision="default"), dict(matmul_precision="high"),
    dict(matmul_precision="highest"),
    dict(matmul_precision="default", backend="ring-overlap", ring_fusion="fused"),
    dict(matmul_precision="high", backend="pallas", pallas_variant="sweep"),
])
def test_config_accepts_the_precisions_as_the_reference_does(setting):
    cfg = KNNConfig(**setting)
    assert cfg.matmul_precision == setting["matmul_precision"]
    ref = jax_pkg.KNNConfig(**setting)
    import dataclasses
    assert config_from_reference(dataclasses.asdict(ref)) == cfg


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
def test_mixed_policy_still_owns_its_precisions(precision):
    """The reference's cross-field rule: the mixed policy needs
    matmul_precision=None, in both packages."""
    with pytest.raises(ValueError, match="matmul_precision must be None"):
        KNNConfig(precision_policy="mixed", matmul_precision=precision)
    with pytest.raises(ValueError, match="matmul_precision"):
        jax_pkg.KNNConfig(precision_policy="mixed", matmul_precision=precision)


def test_planted_duplicates_under_default_follow_their_rounded_keys():
    """Under "default" an exact duplicate's d² is the rounding's,
    q² + c² − 2 bf16(q)·bf16(c), of order 2^-8 q² and of either sign, not
    ~0: a positive key above the zero rule's 1e-6 (q² + c²) (calibrated for
    "highest") keeps the twin as the nearest neighbour, as the reference on
    the TPU keeps it; a key clamped to 0 drops it. At "highest" every
    duplicate drops."""
    X = _data(9, m=128, d=32) * 3.0
    pairs = [(3, 7), (11, 20), (30, 41), (50, 66), (80, 99), (100, 120)]
    for a, b in pairs:
        X[b] = X[a]
    out = {p: all_knn(X, k=K, backend="serial", matmul_precision=p, device=CPU)
           for p in ("highest", "default")}
    Xc, _ = _centered(X)
    kept = 0
    for a, b in pairs:
        assert b not in out["highest"].ids[a].tolist()
        qs = 2.0 * float((Xc[a].astype(np.float64) ** 2).sum())
        key = max(qs - 2.0 * float(_oracle_dots(Xc[a:a + 1], Xc[b:b + 1], "default")[0, 0]),
                  0.0)
        assert abs(qs - 2.0 * float(_oracle_dots(Xc[a:a + 1], Xc[b:b + 1],
                                                   "default")[0, 0])) > 1e-6 * qs
        if key > 1e-6 * qs:
            kept += 1
            assert out["default"].ids[a, 0].item() == b
            assert abs(out["default"].dists[a, 0].item() - key) <= 1e-5 * qs
        else:
            assert b not in out["default"].ids[a].tolist()
    assert 0 < kept < len(pairs)
