"""The resumable drivers (``backends/ring_resumable.py``,
``backends/resumable.py``) and their checkpoints (``utils/checkpoint.py``)
against uninterrupted runs and against the JAX package's drivers.

A run stopped after some rounds (``stop_after_rounds``, or a progress
callback that raises) and resumed from its checkpoint must equal an
uninterrupted run bit for bit, and both must equal the JAX package's
resumable driver on the same small-integer data (centering off, so every
sum is exact). A checkpoint of another schedule, fusion or residency must
not resume; a torn checkpoint file restarts cleanly.
"""

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.backends.resumable import all_knn_resumable as jax_resumable
from mpi_knn_tpu.backends.ring_resumable import (
    all_knn_ring_resumable as jax_ring_resumable,
)
from mpi_knn_tpu_torch import KNNConfig
from mpi_knn_tpu_torch.backends.resumable import all_knn_resumable
from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
from mpi_knn_tpu_torch.utils import checkpoint


def _corpus(m=96, d=12, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.integers(-127, 128, (m, d)).astype(np.float32)
    X[np.arange(m), np.arange(m) % d] = 127.0
    X /= 16
    X[m // 6] = X[m // 2]
    return X


IDS = np.arange(96, dtype=np.int32)
RING = dict(num_devices=4, query_tile=8, corpus_tile=16, center=False)
FUSIONS = {  # name -> (ring_fusion, policy, k, wire)
    "exact_fused": ("fused", "exact", 5, None),
    "mixed_fused": ("fused", "mixed", 3, None),
    "mixed_fused_int8": ("fused", "mixed", 3, "int8"),
    "xla": ("xla", "exact", 5, None),
}


def _ring_cfgs(fusion, schedule):
    ring_fusion, policy, k, wire = FUSIONS[fusion]
    kw = dict(k=k, precision_policy=policy, ring_schedule=schedule,
              ring_transfer_dtype=wire, **RING)
    return (KNNConfig(ring_fusion=ring_fusion, **kw),
            jax_pkg.KNNConfig(ring_fusion="xla", **kw))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


@pytest.mark.parametrize("fusion", list(FUSIONS))
@pytest.mark.parametrize("schedule", ["uni", "bidir"])
@pytest.mark.parametrize("stop", [1, 2])
def test_ring_kill_and_resume_is_bitwise(tmp_path, fusion, schedule, stop):
    X = _corpus()
    cfg, jcfg = _ring_cfgs(fusion, schedule)
    whole = all_knn_ring_resumable(X, X, IDS, cfg, device="cpu")
    rounds = []
    all_knn_ring_resumable(X, X, IDS, cfg, checkpoint_dir=tmp_path,
                           stop_after_rounds=stop, device="cpu",
                           progress_cb=lambda done, total: rounds.append(done))
    assert rounds == list(range(1, stop + 1))
    resumed = all_knn_ring_resumable(
        X, X, IDS, cfg, checkpoint_dir=tmp_path, device="cpu",
        progress_cb=lambda done, total: rounds.append(done))
    total = 4 if schedule == "uni" else 3
    assert rounds == list(range(1, total + 1))  # resumed at round `stop`
    _same(resumed, whole)
    _same(whole, jax_ring_resumable(X, X, IDS, jcfg))


@pytest.mark.parametrize("save_every", [1, 3])
def test_serial_kill_and_resume_is_bitwise(tmp_path, save_every):
    X = _corpus()
    cfg = KNNConfig(k=5, query_tile=8, corpus_tile=16, center=False)
    whole = all_knn_resumable(X, X, IDS, cfg, device="cpu")

    def kill(done, total):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        all_knn_resumable(X, X, IDS, cfg, checkpoint_dir=tmp_path,
                          save_every=save_every, progress_cb=kill,
                          device="cpu")
    seen = []
    resumed = all_knn_resumable(
        X, X, IDS, cfg, checkpoint_dir=tmp_path, save_every=save_every,
        progress_cb=lambda done, total: seen.append(done), device="cpu")
    assert seen[0] == min(2 * save_every, 6)  # 96 rows in 6 tiles of 16
    _same(resumed, whole)
    want = jax_resumable(X, X, IDS, jax_pkg.KNNConfig(
        k=5, query_tile=8, corpus_tile=16, center=False), save_every=save_every)
    _same(whole, want)


def test_centered_resume_matches_jax_within_tolerance(tmp_path):
    X = _corpus() + 3.0
    cfg = KNNConfig(k=5, num_devices=3, query_tile=8, corpus_tile=16)
    all_knn_ring_resumable(X, X, IDS, cfg, checkpoint_dir=tmp_path,
                           stop_after_rounds=1, device="cpu")
    got = all_knn_ring_resumable(X, X, IDS, cfg, checkpoint_dir=tmp_path,
                                 device="cpu")
    want = jax_ring_resumable(X, X, IDS, jax_pkg.KNNConfig(
        k=5, num_devices=3, query_tile=8, corpus_tile=16))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("other", [
    dict(ring_schedule="bidir"), dict(ring_fusion="xla"), "tensor"])
def test_checkpoint_of_another_run_does_not_resume(tmp_path, other):
    """A uni fused run on a host corpus, stopped after 2 rounds; the same
    data under another schedule, another fusion, or on another residency
    (centered: a tensor is centered in f32, a host array in f64) must start
    from round 0."""
    X = _corpus()
    base = dict(k=5, ring_fusion="fused", num_devices=4, query_tile=8,
                corpus_tile=16)
    all_knn_ring_resumable(X, X, IDS, KNNConfig(**base),
                           checkpoint_dir=tmp_path, stop_after_rounds=2,
                           device="cpu")
    data = X
    if other == "tensor":
        data = torch.from_numpy(X)
        cfg = KNNConfig(**base)
    else:
        cfg = KNNConfig(**{**base, **other})
    seen = []
    all_knn_ring_resumable(data, data, IDS, cfg, checkpoint_dir=tmp_path,
                           device="cpu",
                           progress_cb=lambda done, total: seen.append(done))
    assert seen[0] == 1


def test_torn_checkpoint_restarts_cleanly(tmp_path):
    X = _corpus()
    cfg = KNNConfig(k=5, ring_fusion="fused", **RING)
    whole = all_knn_ring_resumable(X, X, IDS, cfg, device="cpu")
    all_knn_ring_resumable(X, X, IDS, cfg, checkpoint_dir=tmp_path,
                           stop_after_rounds=2, device="cpu")
    state = tmp_path / "knn_state.npz"
    state.write_bytes(state.read_bytes()[:100])  # torn mid-file
    seen = []
    got = all_knn_ring_resumable(
        X, X, IDS, cfg, checkpoint_dir=tmp_path, device="cpu",
        progress_cb=lambda done, total: seen.append(done))
    assert seen == [1, 2, 3, 4]
    _same(got, whole)


def test_fingerprint_is_residency_independent_and_data_sensitive():
    X = _corpus()
    cfg = KNNConfig(k=5)
    fp = checkpoint.fingerprint(X, X, cfg)
    assert checkpoint.fingerprint(torch.from_numpy(X), torch.from_numpy(X),
                                  cfg) == fp
    Y = X.copy()
    Y[-1, -1] += 1.0  # the strided sample covers the last element
    assert checkpoint.fingerprint(Y, Y, cfg) != fp
    assert checkpoint.fingerprint(X, X, cfg.replace(k=6)) != fp
    bf = torch.from_numpy(X).to(torch.bfloat16)
    assert checkpoint.fingerprint(bf, bf, cfg) != fp


def test_checkpoint_round_trip_and_clear(tmp_path):
    state = checkpoint.KNNCheckpoint(
        carry_d=np.ones((4, 2), np.float32), carry_i=np.zeros((4, 2), np.int32),
        tiles_done=3, fingerprint="abc")
    checkpoint.save_checkpoint(tmp_path, state)
    assert [p.name for p in tmp_path.iterdir()] == ["knn_state.npz"]
    got = checkpoint.load_checkpoint(tmp_path, "abc")
    assert got.tiles_done == 3 and (got.carry_d == 1).all()
    assert checkpoint.load_checkpoint(tmp_path, "other") is None
    checkpoint.clear_checkpoint(tmp_path)
    assert checkpoint.load_checkpoint(tmp_path, "abc") is None
