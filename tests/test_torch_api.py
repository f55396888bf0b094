"""End-to-end parity of the port's API (all_knn, KNNClassifier through
convert.py) with the JAX package on the CPU, and the settings the port
refuses."""

import dataclasses

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.convert import (
    classifier_from_reference,
    config_from_reference,
)
from tests.oracle import recall_against_oracle

PATHS = [("serial", "tiles"), ("pallas", "tiles"), ("pallas", "sweep")]
TILES = dict(query_tile=64, corpus_tile=128)


def _data(seed=0, m=300, d=24, offset=0.0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((m, d)) * 3.0 + offset).astype(np.float32)
    y = rng.integers(0, 4, m).astype(np.int32)
    return X, y


def _assert_same_knn(port, ref, k):
    gd, gi = port.dists.numpy(), port.ids.numpy()
    wd, wi = np.asarray(ref.dists), np.asarray(ref.ids)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)
    assert recall_against_oracle(gi, wd, wi, k) == 1.0


@pytest.mark.parametrize("backend,variant", PATHS)
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("center", [True, False])
def test_all_knn_all_pairs_matches_jax(backend, variant, metric, center):
    X, _ = _data(offset=5.0)
    kw = dict(k=7, backend=backend, pallas_variant=variant, metric=metric,
              center=center, **TILES)
    _assert_same_knn(all_knn(X, device="cpu", **kw), jax_pkg.all_knn(X, **kw), 7)


@pytest.mark.parametrize("backend,variant", PATHS)
def test_all_knn_query_ids_matches_jax(backend, variant):
    X, _ = _data(1)
    rows = np.arange(0, 300, 7)
    kw = dict(k=5, backend=backend, pallas_variant=variant, **TILES)
    port = all_knn(X, queries=X[rows], query_ids=rows, device="cpu", **kw)
    ref = jax_pkg.all_knn(X, queries=X[rows], query_ids=rows, **kw)
    _assert_same_knn(port, ref, 5)
    assert not (port.ids.numpy() == rows[:, None]).any()  # self excluded


@pytest.mark.parametrize("variant", ["tiles", "sweep"])
def test_cosine_zero_row_falls_back_to_serial_like_jax(variant):
    X, _ = _data(2, m=96, d=16)
    X[17] = 0.0
    kw = dict(k=5, backend="pallas", pallas_variant=variant, metric="cosine",
              query_tile=32, corpus_tile=64)
    port = all_knn(X, device="cpu", **kw)
    _assert_same_knn(port, jax_pkg.all_knn(X, **kw), 5)
    fused = all_knn(X, device="cpu", **{**kw, "backend": "serial"})
    np.testing.assert_array_equal(port.ids.numpy(), fused.ids.numpy())


@pytest.mark.parametrize("variant", ["tiles", "sweep"])
def test_k_exceeding_corpus_tile_routes_to_tiles(variant):
    X, _ = _data(3, m=300, d=8)
    kw = dict(k=150, backend="pallas", pallas_variant=variant,
              query_tile=32, corpus_tile=128)
    _assert_same_knn(all_knn(X, device="cpu", **kw), jax_pkg.all_knn(X, **kw),
                     150)


@pytest.mark.parametrize(
    "overrides",
    [dict(dtype="float64"), dict(dtype="bfloat16"),
     dict(merge_schedule="stream"), dict(topk_method="block", topk_block=16)],
)
def test_serial_policies_match_jax(overrides):
    X, _ = _data(4, m=200)
    kw = dict(k=6, backend="serial", **TILES, **overrides)
    port = all_knn(X, device="cpu", **kw)
    ref = jax_pkg.all_knn(X, **kw)
    rtol = 1e-2 if overrides.get("dtype") == "bfloat16" else 1e-5
    np.testing.assert_allclose(port.dists.numpy(), np.asarray(ref.dists),
                               rtol=rtol, atol=1e-3)
    assert recall_against_oracle(port.ids.numpy(), np.asarray(ref.dists),
                                 np.asarray(ref.ids), 6) == 1.0


@pytest.mark.parametrize("backend,variant", PATHS)
@pytest.mark.parametrize("tie_break", ["nearest", "quirk-serial"])
def test_loo_report_matches_jax_through_convert(backend, variant, tie_break):
    X, y = _data(5, m=256, d=16)
    ref_cfg = jax_pkg.KNNConfig(k=5, num_classes=4, backend=backend,
                                pallas_variant=variant, tie_break=tie_break,
                                **TILES)
    ref = jax_pkg.KNNClassifier(config=ref_cfg).fit(X, y).loo_report()
    port = classifier_from_reference(dataclasses.asdict(ref_cfg), X, y,
                                     device="cpu").loo_report()
    assert port.matches == ref.matches
    np.testing.assert_array_equal(port.classify.predictions.numpy(),
                                  np.asarray(ref.classify.predictions))


def test_default_config_dict_round_trips():
    d = dataclasses.asdict(jax_pkg.KNNConfig())
    assert dataclasses.asdict(config_from_reference(d)) == d


LIFTED = [dict(precision_policy="mixed"), dict(backend="ring"),
          dict(backend="ring-overlap"), dict(ring_schedule="bidir"),
          dict(ring_transfer_dtype="bfloat16")]


@pytest.mark.parametrize("setting", LIFTED)
def test_lifted_settings_run_and_match_jax(setting):
    """Settings the port refused before the ring and the mixed policy were
    ported now run on the CPU and agree with the JAX package (a ring of 4;
    ``auto`` resolves to the overlap ring on both sides)."""
    X, _ = _data(8, m=160)
    kw = dict(k=5, num_devices=4, query_tile=16, corpus_tile=32, **setting)
    _assert_same_knn(all_knn(X, device="cpu", **kw), jax_pkg.all_knn(X, **kw),
                     5)


@pytest.mark.parametrize(
    "setting",
    [dict(partitions=4), dict(partitions=16), dict(partitions=64)],
)
def test_refused_settings_name_themselves(setting):
    name = next(iter(setting))
    with pytest.raises(ValueError, match=f"{name}.*not yet ported"):
        KNNConfig(**setting)
    d = dataclasses.asdict(jax_pkg.KNNConfig(**setting))
    with pytest.raises(ValueError, match="not yet ported"):
        config_from_reference(d)


@pytest.mark.parametrize(
    "setting",
    [dict(precision_policy="mixed"), dict(backend="ring"),
     dict(backend="ring-overlap"), dict(ring_schedule="bidir"),
     dict(ring_transfer_dtype="bfloat16"), dict(ring_transfer_dtype="float32"),
     dict(ring_transfer_dtype="int8", precision_policy="mixed"),
     dict(ring_fusion="fused"), dict(num_devices=4, mesh_axis="r"),
     dict(ring_fusion="fused", ring_fused_rotation="grid")],
)
def test_ported_reference_configs_convert(setting):
    d = dataclasses.asdict(jax_pkg.KNNConfig(**setting))
    assert dataclasses.asdict(config_from_reference(d)) == d


@pytest.mark.parametrize(
    "setting,words",
    [(dict(ring_transfer_dtype="int8"), "requires precision_policy='mixed'"),
     (dict(ring_fusion="fused", metric="cosine"), "metric='l2' only"),
     (dict(ring_fusion="fused", dtype="bfloat16"), "dtype='float32'"),
     (dict(ring_fusion="fused", topk_method="block"), "topk_method='exact'"),
     (dict(precision_policy="mixed", dtype="float64"), "dtype='float32'"),
     (dict(precision_policy="mixed", matmul_precision="highest"),
      "matmul_precision must be None")],
)
def test_cross_field_rules_match_jax(setting, words):
    with pytest.raises(ValueError):
        jax_pkg.KNNConfig(**setting)
    with pytest.raises(ValueError, match=words):
        KNNConfig(**setting)


def test_auto_with_several_devices_runs_the_ring():
    X, _ = _data(6, m=64)
    kw = dict(k=3, num_devices=2, query_tile=16, corpus_tile=32)
    _assert_same_knn(all_knn(X, device="cpu", **kw), jax_pkg.all_knn(X, **kw),
                     3)
    assert all_knn(X, k=3, device="cpu").ids.shape == (64, 3)  # auto = serial


def test_unknown_reference_field_is_refused():
    d = dataclasses.asdict(jax_pkg.KNNConfig())
    d["no_such_knob"] = 1
    with pytest.raises(ValueError, match="no_such_knob"):
        config_from_reference(d)


def test_tensor_input_centers_in_place_of_the_host():
    X, _ = _data(7, m=128, offset=50.0)
    kw = dict(k=4, backend="pallas", **TILES)
    port = all_knn(torch.from_numpy(X), device="cpu", **kw)
    _assert_same_knn(port, jax_pkg.all_knn(X, **kw), 4)


@pytest.mark.parametrize("corpus_tensor", [False, True])
@pytest.mark.parametrize("queries_tensor", [False, True])
@pytest.mark.parametrize("center", [True, False])
def test_every_residency_pair_finds_the_host_pairs_ids(corpus_tensor,
                                                       queries_tensor, center):
    """A corpus and explicit queries, each a numpy array or a tensor: every
    pair runs and returns the ids of the numpy/numpy call, judged tie-aware
    by f64 distance against the oracle."""
    from tests.oracle import oracle_all_knn

    X, _ = _data(9, m=200, offset=20.0)
    Q = X[::3] + 0.5
    kw = dict(k=6, backend="pallas", center=center, **TILES)
    corpus = torch.from_numpy(X) if corpus_tensor else X
    queries = torch.from_numpy(Q) if queries_tensor else Q
    got = all_knn(corpus, queries=queries, device="cpu", **kw)
    host = all_knn(X, queries=Q, device="cpu", **kw)
    wd, wi = oracle_all_knn(X, 6, queries=Q)
    for res in (got, host):
        assert recall_against_oracle(res.ids.numpy(), wd, wi, 6) == 1.0
    np.testing.assert_allclose(got.dists.numpy(), host.dists.numpy(),
                               rtol=1e-5, atol=1e-3)
