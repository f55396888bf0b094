"""The port's clustered (IVF) index (``mpi_knn_tpu_torch/ivf``) against the
JAX package's ``mpi_knn_tpu.ivf`` on the CPU, at small sizes.

- k-means: the port's Lloyd rounds fed the JAX package's own initial
  centroids end where ``mpi_knn_tpu.ivf.kmeans`` ends (the port's init
  draws from a ``torch.Generator``, so its own centroids cannot equal
  JAX's);
- search: a JAX-built index carried across by ``convert.py`` searches to
  the same ids (tie-aware) and distances, per store and policy;
- the ``.npz``: either package's file loads in the other and searches to
  the same ids;
- ``nprobe == partitions`` against the serial ``all_knn``, serving against
  the one-shot search bit for bit, determinism, the empty-cluster
  re-seed, and the refusals of the build, the config and the CLIs.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_knn_tpu import KNNConfig as JaxConfig
from mpi_knn_tpu import ivf as jivf
from mpi_knn_tpu.ops.distance import sq_norms as jax_sq_norms
from mpi_knn_tpu_torch import KNNConfig, all_knn, build_index, query_knn
from mpi_knn_tpu_torch.convert import ivf_index_from_reference
from mpi_knn_tpu_torch.ivf import (
    build_ivf_index,
    kmeans,
    lloyd,
    load_ivf_index,
    save_ivf_index,
    search_ivf,
    tune_nprobe,
)
from mpi_knn_tpu_torch.ivf.search import ivf_query_shapes
from mpi_knn_tpu_torch.ops.quant import dequantize_rows
from mpi_knn_tpu_torch.serve import ServeSession
from tests.oracle import recall_against_oracle

# the module (the package's ``kmeans`` name is the function)
jkm = importlib.import_module("mpi_knn_tpu.ivf.kmeans")
CPU = "cpu"
K = 10
STORES = ("float32", "bfloat16", "int8", "int4")


def _clustered(rng, m=2048, d=32, centers=24, spread=0.25):
    """A corpus with cluster structure (the JAX package's test corpus)."""
    cents = rng.standard_normal((centers, d)).astype(np.float32) * 4
    assign = rng.integers(0, centers, size=m)
    return (cents[assign] + rng.standard_normal((m, d)).astype(np.float32)
            * spread * 4).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _corpus():
    rng = np.random.default_rng(0)
    X = _clustered(rng, m=4096, d=32)
    Q = _clustered(np.random.default_rng(1), m=96, d=32)
    return X, Q


@functools.lru_cache(maxsize=None)
def _jax_index(dtype: str):
    X, _ = _corpus()
    return jivf.build_ivf_index(
        X, JaxConfig(k=K, partitions=16, nprobe=4, kmeans_iters=5,
                     dtype=dtype))


def _state(j) -> dict:
    """A JAX IVFIndex as the host values ``ivf_index_from_reference``
    takes."""
    return dict(
        cfg=dataclasses.asdict(j.cfg), m=j.m, dim=j.dim,
        partitions=j.partitions, bucket_cap=j.bucket_cap, nprobe=j.nprobe,
        tuned_recall=j.tuned_recall, mu=j.mu,
        centroids=np.asarray(j.centroids),
        centroid_sqs=np.asarray(j.centroid_sqs),
        buckets=np.asarray(j.buckets), bucket_ids=np.asarray(j.bucket_ids),
        bucket_sqs=np.asarray(j.bucket_sqs),
        bucket_scales=(None if j.bucket_scales is None
                       else np.asarray(j.bucket_scales)),
    )


def _stored_rows(p) -> np.ndarray:
    """(m, d) f64: each corpus row as the index stores it (dequantized)."""
    flat = p.buckets.reshape(-1, p.buckets.shape[-1])
    if p.bucket_scales is not None:
        flat = dequantize_rows(flat, p.bucket_scales.reshape(-1), p.cfg.dtype,
                               p.dim)
    ids = p.bucket_ids.reshape(-1).numpy()
    rows = np.zeros((p.m, p.dim))
    rows[ids[ids >= 0]] = flat.double().numpy()[ids >= 0]
    return rows


def _assert_same_search(p, q, got, want, k=K):
    """Ids tie-aware against the JAX package's (>= 0.999); the port's
    distances within rtol = atol = 1e-5 of the f64 distances to the rows as
    stored, and of the JAX package's up to its own f32 cancellation error
    (its products are f32, ~2e-7 of q² + c²; the port's rerank is f64)."""
    gd, gi = (np.asarray(t) for t in got)
    wd, wi = (np.asarray(t) for t in want)
    assert recall_against_oracle(gi, wd, wi, k) >= 0.999
    rows = _stored_rows(p)
    qc = np.asarray(q, np.float64)
    if p.mu is not None:
        qc = (qc - p.mu).astype(np.float32).astype(np.float64)
    valid = gi >= 0
    assert np.array_equal(valid, np.isfinite(gd))
    cand = rows[np.where(valid, gi, 0)]
    truth = ((qc[:, None, :] - cand) ** 2).sum(-1)
    np.testing.assert_allclose(gd[valid], truth[valid], rtol=1e-5, atol=1e-5)
    scale = (qc ** 2).sum(-1)[:, None] + (cand ** 2).sum(-1)
    assert (np.abs(gd - wd)[valid]
            <= (1e-5 + 1e-5 * np.abs(wd) + 1e-6 * scale)[valid]).all()


# ---------------------------------------------------------------------------
# k-means


@functools.partial(jax.jit, static_argnames=("k", "init"))
def _jax_init(data, seed, k, init):
    """The JAX package's initialisation, as its ``_kmeans_jit`` draws it."""
    data = data.astype(jnp.float32)
    key = jax.random.PRNGKey(seed)
    if init == "kmeans++":
        return jkm._init_kmeanspp(key, data, jax_sq_norms(data), k)
    return jkm._init_random(key, data, k)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_lloyd_from_jax_init_matches_jax_kmeans(init):
    X, _ = _corpus()
    k, iters, seed = 16, 5, 3
    want = jkm.kmeans(X, k, iters=iters, seed=seed, init=init)
    init_c = np.array(_jax_init(jnp.asarray(X), seed, k, init))
    got = lloyd(torch.from_numpy(X), torch.from_numpy(init_c), iters)
    wc = np.asarray(want.centroids)
    np.testing.assert_allclose(got.centroids.numpy(), wc, rtol=1e-5,
                               atol=1e-5 * np.abs(wc).max())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    # assignments equal, except rows whose two nearest centroids tie to 1e-5
    d2 = ((X.astype(np.float64)[:, None, :] - wc[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    near_tie = two[:, 1] - two[:, 0] <= 1e-5 * two[:, 1]
    diff = got.assignments.numpy() != np.asarray(want.assignments)
    assert not (diff & ~near_tie).any()
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


def test_kmeans_is_seed_deterministic():
    X, _ = _corpus()
    a = kmeans(X, 12, iters=3, seed=3, device=CPU)
    b = kmeans(X, 12, iters=3, seed=3, device=CPU)
    assert torch.equal(a.centroids, b.centroids)
    assert torch.equal(a.assignments, b.assignments)
    c = kmeans(X, 12, iters=3, seed=4, device=CPU)
    assert not torch.equal(a.centroids, c.centroids)
    # an explicit generator draws the same as the seed it was given
    gen = torch.Generator(device=CPU).manual_seed(3)
    d = kmeans(X, 12, iters=3, generator=gen, device=CPU)
    assert torch.equal(a.centroids, d.centroids)
    cfg = KNNConfig(k=5, partitions=12, nprobe=2, ivf_seed=3, kmeans_iters=3)
    i1 = build_ivf_index(X, cfg, device=CPU)
    i2 = build_ivf_index(X, cfg, device=CPU)
    assert torch.equal(i1.bucket_ids, i2.bucket_ids)
    assert torch.equal(i1.buckets, i2.buckets)


def test_empty_cluster_reseed_matches_jax():
    """More partitions than distinct points: the re-seed keeps every
    centroid finite, as the JAX package's does, from the same start."""
    base = np.random.default_rng(5).standard_normal((4, 8)).astype(
        np.float32) * 3
    X = np.repeat(base, 8, axis=0)  # 32 rows, 4 distinct
    res = kmeans(X, 8, seed=0, init="random", device=CPU)
    assert torch.isfinite(res.centroids).all()
    assert int((res.counts == 0).sum()) >= 4
    want = jkm.kmeans(X, 8, iters=25, seed=0, init="random")
    init_c = np.array(_jax_init(jnp.asarray(X), 0, 8, "random"))
    got = lloyd(torch.from_numpy(X), torch.from_numpy(init_c), 25)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    idx = build_ivf_index(X, KNNConfig(k=3, partitions=8, nprobe=8,
                                       kmeans_init="random"), device=CPU)
    d, i = search_ivf(idx, X, query_ids=np.arange(32), device=CPU)
    assert torch.isfinite(d).all() and (i >= 0).all()
    for r in range(32):
        assert r not in i[r].tolist()  # duplicates: zero-distance excluded


# ---------------------------------------------------------------------------
# search against the JAX package, on an index carried across


@pytest.mark.parametrize("policy", ["exact", "mixed"])
@pytest.mark.parametrize("dtype", STORES)
def test_search_matches_jax_on_a_carried_index(dtype, policy):
    X, Q = _corpus()
    j = _jax_index(dtype)
    p = ivf_index_from_reference(_state(j), CPU)
    policy_kw = {"precision_policy": policy}
    if dtype == "bfloat16" and policy == "mixed":
        # the exact rerank contract is void over a store rounded at rest:
        # both packages refuse the mixed policy there
        with pytest.raises(ValueError, match="mixed"):
            jivf.search_ivf(j, Q, **policy_kw)
        with pytest.raises(ValueError, match="mixed"):
            search_ivf(p, Q, device=CPU, **policy_kw)
        return
    assert p.nbytes_resident == j.nbytes_resident
    assert p.probe_bytes == j.probe_bytes
    sample = np.arange(0, 4096, 37)
    for q, qids in ((Q, None), (X[sample], sample.astype(np.int32))):
        want = jivf.search_ivf(j, q, query_ids=qids, **policy_kw)
        got = search_ivf(p, q, query_ids=qids, device=CPU, **policy_kw)
        _assert_same_search(p, q, got, want)
    for nprobe in (1, 16):
        want = jivf.search_ivf(j, Q, nprobe=nprobe)
        got = search_ivf(p, Q, nprobe=nprobe, device=CPU)
        _assert_same_search(p, Q, got, want)


def test_tuned_nprobe_matches_jax():
    j = _jax_index("float32")
    p = ivf_index_from_reference(_state(j), CPU)
    got = tune_nprobe(p, 0.95, k=K)
    assert got == jivf.tune_nprobe(j, 0.95, k=K)


@pytest.mark.parametrize("dtype", STORES)
def test_build_matches_jax_layout_from_the_same_partitions(dtype,
                                                           monkeypatch):
    """The port's layout, quantization and norms on the JAX package's
    clusters: the same buckets, ids, codes and scales, bit for bit."""
    from mpi_knn_tpu_torch.ivf import index as pindex

    X, _ = _corpus()
    j = _jax_index(dtype)
    want_ids = np.asarray(j.bucket_ids)
    assign = np.full(X.shape[0], -1)
    parts, slots = np.nonzero(want_ids >= 0)
    assign[want_ids[parts, slots]] = parts
    monkeypatch.setattr(pindex, "kmeans", lambda data, P, **kw: (
        _fixed_partition(P, assign, np.asarray(j.centroids))))
    q = build_ivf_index(X, KNNConfig(k=K, partitions=16, nprobe=4,
                                     kmeans_iters=5, dtype=dtype),
                        device=CPU)
    np.testing.assert_array_equal(q.bucket_ids.numpy(), want_ids)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            q.buckets.view(torch.int16).numpy(),
            np.asarray(j.buckets).view(np.int16))
    else:
        np.testing.assert_array_equal(q.buckets.numpy(),
                                      np.asarray(j.buckets))
    if dtype in ("int8", "int4"):
        # within one ulp: the JAX package divides by QMAX under jit, where
        # XLA may multiply by its reciprocal (the port's quantize_rows
        # equals its eager one bit for bit, tests/test_torch_quant.py)
        np.testing.assert_array_max_ulp(q.bucket_scales.numpy(),
                                        np.asarray(j.bucket_scales), maxulp=1)
    np.testing.assert_allclose(q.bucket_sqs.numpy(), np.asarray(j.bucket_sqs),
                               rtol=1e-6)
    np.testing.assert_array_equal(q.mu, j.mu)


def _fixed_partition(P, assign, centroids):
    from mpi_knn_tpu_torch.ivf.kmeans import KMeansResult

    a = torch.from_numpy(assign.astype(np.int32))
    return KMeansResult(centroids=torch.from_numpy(np.array(centroids)),
                        assignments=a,
                        counts=torch.bincount(a.long(), minlength=P).int(),
                        inertia=torch.tensor(0.0))


# ---------------------------------------------------------------------------
# the .npz, both ways


@pytest.mark.parametrize("dtype", STORES)
def test_jax_npz_loads_in_the_port(dtype, tmp_path):
    _, Q = _corpus()
    j = _jax_index(dtype)
    path = jivf.save_ivf_index(j, str(tmp_path / "jax"))
    p = load_ivf_index(path, device=CPU)
    assert p.cfg == ivf_index_from_reference(_state(j), CPU).cfg
    assert (p.m, p.dim, p.partitions, p.bucket_cap, p.nprobe) == (
        j.m, j.dim, j.partitions, j.bucket_cap, j.nprobe)
    _assert_same_search(p, Q, search_ivf(p, Q, device=CPU),
                        jivf.search_ivf(j, Q))


@pytest.mark.parametrize("dtype", STORES)
def test_port_npz_loads_in_jax(dtype, tmp_path):
    X, Q = _corpus()
    p = build_ivf_index(X[:2048], KNNConfig(k=K, partitions=8, nprobe=3,
                                            kmeans_iters=3, dtype=dtype),
                        device=CPU)
    path = save_ivf_index(p, str(tmp_path / "port"))
    j = jivf.load_ivf_index(path)
    assert j.cfg.dtype == dtype and j.nprobe == 3
    np.testing.assert_array_equal(np.asarray(j.bucket_ids),
                                  p.bucket_ids.numpy())
    _assert_same_search(p, Q, search_ivf(p, Q, device=CPU),
                        jivf.search_ivf(j, Q))
    # and back: the port's own load, mapped and copied, searches the same
    for mmap in (True, False):
        again = load_ivf_index(path, mmap=mmap, device=CPU)
        for a, b in zip(search_ivf(again, Q, device=CPU),
                        search_ivf(p, Q, device=CPU)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# full scan, serving, shapes


def test_nprobe_equals_partitions_is_serial_all_knn():
    X, _ = _corpus()
    idx = build_ivf_index(X[:1024], KNNConfig(k=K, partitions=8, nprobe=8,
                                              kmeans_iters=3), device=CPU)
    sample = np.arange(0, 1024, 4)
    gd, gi = search_ivf(idx, X[sample], query_ids=sample, device=CPU)
    want = all_knn(X[:1024], queries=X[sample], query_ids=sample,
                   config=KNNConfig(k=K, backend="serial"), device=CPU)
    np.testing.assert_allclose(gd.numpy(), want.dists.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert recall_against_oracle(gi.numpy(), want.dists.numpy(),
                                 want.ids.numpy(), K) >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "int4"])
def test_serving_equals_the_one_shot_search_bit_for_bit(dtype):
    rng = np.random.default_rng(2)
    X = _clustered(rng, m=768, d=24)
    idx = build_ivf_index(X, KNNConfig(k=6, partitions=8, query_bucket=32,
                                       kmeans_iters=3, dtype=dtype),
                          device=CPU)
    Q = rng.standard_normal((70, 24)).astype(np.float32)
    d1, i1 = search_ivf(idx, Q, device=CPU)
    res = query_knn(Q, idx, device=CPU)
    assert torch.equal(res.dists, d1) and torch.equal(res.ids, i1)
    sess = ServeSession(idx, device=CPU)
    outs = list(sess.stream([Q[:20], Q[20:50], Q[50:]]))
    assert np.array_equal(np.concatenate([o.ids for o in outs]), i1.numpy())
    assert np.array_equal(np.concatenate([o.dists for o in outs]), d1.numpy())
    # tensor queries go the same way
    res_t = query_knn(torch.from_numpy(Q), idx, device=CPU)
    assert torch.equal(res_t.ids, i1)
    # live mutation through the session (serve/mutate.py): row 0 upserted
    # again with its own values changes no answer, and a compaction keeps
    # the cap and every live row
    assert sess.upsert([0], X[:1])["live"] == 768
    d2, i2 = search_ivf(idx, Q, device=CPU)
    assert torch.equal(i2, i1) and torch.equal(d2, d1)
    st = sess.compact(retrain=False)
    assert st["cap_after"] == idx.bucket_cap and st["live"] == 768


@pytest.mark.parametrize("nq,nprobe,cap,dim,tile,cap_elems", [
    (70, 8, 96, 24, 1024, 1 << 28), (10000, 20, 800, 128, 1024, 1 << 28),
    (3, 4, 40, 16, 1024, 1 << 28), (512, 16, 64, 32, 64, 1 << 20),
])
def test_query_shapes_match_jax(nq, nprobe, cap, dim, tile, cap_elems):
    from mpi_knn_tpu.ivf.search import ivf_query_shapes as jax_shapes

    kw = dict(k=K, partitions=64, query_tile=tile, max_tile_elems=cap_elems)
    assert ivf_query_shapes(KNNConfig(**kw), nprobe, cap, dim, nq) == \
        jax_shapes(JaxConfig(**kw), nprobe, cap, dim, nq)


def test_query_shapes_refuse_a_row_past_the_cap():
    with pytest.raises(ValueError, match="exceeds"):
        ivf_query_shapes(KNNConfig(k=K, partitions=64, max_tile_elems=1000),
                         8, 100, 32, 10)


def test_build_from_a_serial_corpus_index():
    X, Q = _corpus()
    cfg = KNNConfig(k=K, partitions=8, nprobe=3, kmeans_iters=3)
    serve_idx = build_index(X[:1024], KNNConfig(k=K, backend="serial"),
                            device=CPU)
    a = build_ivf_index(serve_idx, cfg, device=CPU)
    b = build_ivf_index(X[:1024], cfg, device=CPU)
    assert torch.equal(a.bucket_ids, b.bucket_ids)
    assert torch.equal(a.buckets, b.buckets)
    np.testing.assert_array_equal(a.mu, b.mu)
    with pytest.raises(ValueError, match="serial-layout"):
        build_ivf_index(build_index(X[:256], KNNConfig(k=K, backend="pallas"),
                                    device=CPU), cfg, device=CPU)


# ---------------------------------------------------------------------------
# refusals (the JAX package's tests/test_ivf.py:339-449)


def test_compatible_cfg_refuses_corpus_side_changes():
    X = _clustered(np.random.default_rng(3), m=256, d=16)
    idx = build_ivf_index(X, KNNConfig(k=5, partitions=4, kmeans_iters=2),
                          device=CPU)
    for change in (dict(partitions=8), dict(ivf_seed=9), dict(dtype="int8")):
        with pytest.raises(ValueError, match="corpus-side"):
            idx.compatible_cfg(idx.cfg.replace(**change))
    assert idx.compatible_cfg(idx.cfg.replace(nprobe=2)).nprobe == 2
    assert idx.compatible_cfg(idx.cfg.replace(nprobe=None)).nprobe == \
        idx.nprobe
    for knob, value in (("topk_method", "approx"),
                        ("matmul_precision", "high"),
                        ("merge_schedule", "stream")):
        with pytest.raises(ValueError, match=knob):
            idx.compatible_cfg(idx.cfg.replace(**{knob: value}))
    with pytest.raises(ValueError, match="topk_method"):
        build_ivf_index(X, KNNConfig(k=5, partitions=4,
                                     topk_method="approx"), device=CPU)
    with pytest.raises(ValueError, match="index lives on"):
        search_ivf(idx, X[:4], device="meta")


def test_build_refusals():
    X = np.zeros((64, 8), np.float32)
    with pytest.raises(ValueError, match="partitions"):
        build_ivf_index(X, KNNConfig(k=3), device=CPU)
    with pytest.raises(ValueError, match="backend"):
        build_ivf_index(X, KNNConfig(k=3, partitions=4, backend="pallas"),
                        device=CPU)
    with pytest.raises(ValueError, match="metric"):
        KNNConfig(k=3, partitions=4, metric="cosine")
    with pytest.raises(ValueError, match="nprobe"):
        KNNConfig(k=3, partitions=4, nprobe=8)
    with pytest.raises(ValueError, match="nprobe"):
        KNNConfig(k=3, nprobe=2)
    with pytest.raises(ValueError, match="dtype"):
        build_ivf_index(X, KNNConfig(k=3, partitions=4, dtype="float64"),
                        device=CPU)
    with pytest.raises(ValueError, match="exceeds"):
        build_ivf_index(np.zeros((4, 8), np.float32),
                        KNNConfig(k=3, partitions=8), device=CPU)
    with pytest.raises(ValueError, match="ivf_shards must be >= 1"):
        KNNConfig(k=3, partitions=4, ivf_shards=0)


@pytest.fixture(scope="module")
def saved_index(tmp_path_factory):
    from mpi_knn_tpu_torch.ivf import cli as ivf_cli

    path = str(tmp_path_factory.mktemp("ivf") / "ok.npz")
    assert ivf_cli.main(["--data", "synthetic:256x16c4", "--partitions", "4",
                         "--k", "3", "--out", path, "-q", "--device",
                         CPU]) == 0
    return path


def _rc(main, argv) -> int:
    """A CLI's exit code, argparse's usage errors included."""
    try:
        return main(argv)
    except SystemExit as e:
        return e.code


@pytest.mark.parametrize("argv", [
    ["--metric", "cosine"], ["--backend", "pallas"], ["--nprobe", "9"],
    ["--dtype", "float64"], ["--kmeans-iters", "0"],
])
def test_build_index_cli_refusals_exit_2(argv, tmp_path):
    from mpi_knn_tpu_torch.ivf import cli as ivf_cli

    assert _rc(ivf_cli.main, ["--data", "synthetic:64x8c2", "--partitions",
                              "4", "--out", str(tmp_path / "x.npz"),
                              "--device", CPU, *argv]) == 2
    assert not (tmp_path / "x.npz").exists()


@pytest.mark.parametrize("argv,words", [
    (["--backend", "pallas"], "--backend pallas"),
    (["--backend", "ring-overlap"], "--backend ring-overlap"),
    (["--metric", "cosine"], "--metric cosine"),
    (["--nprobe", "99"], "nprobe"),
    (["--corpus-tile", "4096"], "--corpus-tile"),
    (["--ring-schedule", "bidir"], "--ring-schedule"),
    (["--ring-transfer-dtype", "int8"], "--ring-transfer-dtype"),
    (["--dtype", "bfloat16"], "--dtype bfloat16"),
    (["--devices", "2"], "--devices"),
    (["--route-cap", "8"], "--route-cap with --index-load requires"),
])
def test_query_cli_index_load_refusals_exit_2(saved_index, argv, words,
                                              capsys):
    from mpi_knn_tpu_torch.serve import cli as serve_cli

    assert serve_cli.main(["--data", "synthetic:256x16c4", "--index-load",
                           saved_index, "--synthetic", "8", "--device", CPU,
                           *argv]) == 2
    assert words in capsys.readouterr().err


def test_query_cli_refuses_nprobe_without_an_index(capsys):
    from mpi_knn_tpu_torch.serve import cli as serve_cli

    assert serve_cli.main(["--data", "synthetic:256x16c4", "--nprobe", "2",
                           "--synthetic", "8", "--device", CPU]) == 2
    assert "--nprobe requires --index-load" in capsys.readouterr().err
    assert serve_cli.main(["--data", "synthetic:256x8c4", "--index-load",
                           "absent.npz", "--synthetic", "8", "--device",
                           CPU]) == 2
    assert "cannot load index" in capsys.readouterr().err


def test_build_index_then_query_cli_round_trip(tmp_path, capsys):
    """``build-index`` → ``query --index-load`` on the CPU; the same file
    loads in the JAX package and searches to the same ids."""
    import json

    from mpi_knn_tpu_torch.cli import load_corpus, main

    path = str(tmp_path / "i.npz")
    assert main(["build-index", "--data", "synthetic:2048x32c8",
                 "--partitions", "8", "--out", path, "--device", CPU]) == 0
    assert "tuned nprobe=" in capsys.readouterr().out
    report = tmp_path / "r.json"
    assert main(["query", "--data", "synthetic:2048x32c8", "--index-load",
                 path, "--synthetic", "200", "--k", "10", "--device", CPU,
                 "--report", str(report)]) == 0
    summary = json.loads(report.read_text())
    assert summary["backend"] == "ivf" and summary["queries"] == 200
    assert summary["partitions"] == 8
    p = load_ivf_index(path, device=CPU)
    assert summary["at_rest"] == {
        "dtype": "float32", "resident_bytes": p.nbytes_resident,
        "probe_bytes_per_query": p.probe_bytes}
    X, _, _ = load_corpus("synthetic:2048x32c8")
    j = jivf.load_ivf_index(path)
    sample = np.arange(0, 2048, 9)
    _assert_same_search(p, X[sample],
                        search_ivf(p, X[sample], query_ids=sample, device=CPU),
                        jivf.search_ivf(j, X[sample], query_ids=sample))
