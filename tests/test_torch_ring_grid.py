"""K5, the whole rotation in one launch (``ops/fused_rotation.
fused_rotation_grid``), on the CPU through its plain version, and the
grid form's refusals, against the JAX package.

The plain version runs the P rounds rank by rank over two slots per rank;
it must equal the JAX ring (``ring_fusion="xla"`` on its virtual CPU mesh)
bit for bit on small-integer data. The refusals carry the JAX package's
words.
"""

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.backends.ring_resumable import (
    all_knn_ring_resumable as jax_ring_resumable,
)
from mpi_knn_tpu_torch import KNNConfig, all_knn
from mpi_knn_tpu_torch.backends import ring
from mpi_knn_tpu_torch.backends.ring_resumable import all_knn_ring_resumable
from mpi_knn_tpu_torch.ops import fused_rotation


def _corpus(m=96, d=12, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.integers(-127, 128, (m, d)).astype(np.float32)
    X[np.arange(m), np.arange(m) % d] = 127.0
    X /= 16
    X[m // 6] = X[m // 2]
    return X


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_grid_form_ring_equals_jax(P, wire):
    X = _corpus()
    kw = dict(k=3 if P % 2 == 0 else 5, num_devices=P, query_tile=8,
              corpus_tile=16, center=False, ring_transfer_dtype=wire)
    want = jax_pkg.all_knn(X, backend="ring-overlap", ring_fusion="xla", **kw)
    cfg = KNNConfig(backend="ring-overlap", ring_fusion="fused",
                    ring_fused_rotation="grid", **kw)
    d, i = ring.all_knn_ring(X, X, np.arange(96, dtype=np.int32), cfg,
                             device="cpu", form="grid")
    np.testing.assert_array_equal(i.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want.dists))


def test_grid_reference_streams_every_block_through_the_slots():
    """After the rotation each rank's slots hold the blocks of its last two
    rounds: rank i merged block i − P + 1 last, from slot (P − 1) % 2."""
    P, b, dim = 3, 16, 4
    rng = np.random.default_rng(0)
    blocks = [(torch.from_numpy(rng.standard_normal((b, dim)).astype(np.float32)),
               torch.arange(r * b, (r + 1) * b, dtype=torch.int32), None)
              for r in range(P)]
    slots = [fused_rotation.landing_slots(*blk) for blk in blocks]
    queries = [torch.zeros((8, dim)) for _ in range(P)]
    qids = [torch.full((8,), -1, dtype=torch.int32) for _ in range(P)]
    carries = [(torch.full((8, 2), float("inf")),
                torch.full((8, 2), -1, dtype=torch.int32)) for _ in range(P)]
    fused_rotation.fused_rotation_grid(
        fused_rotation.ring_transport(["cpu"] * P), queries, qids, blocks,
        carries, slots, c_tile=b)
    for i in range(P):
        last = (i - (P - 1)) % P
        assert torch.equal(slots[i][1][(P - 1) % 2], blocks[last][1])
        assert torch.equal(slots[i][0][(P - 1) % 2], blocks[last][0])


@pytest.mark.parametrize("setting", [
    dict(ring_transfer_dtype="int8", precision_policy="mixed"),
    dict(ring_schedule="bidir"),
    dict(precision_policy="mixed"),
])
def test_grid_refusals_match_jax(setting):
    kw = dict(ring_fusion="fused", ring_fused_rotation="grid", **setting)
    with pytest.raises(ValueError) as want:
        jax_pkg.KNNConfig(**kw)
    with pytest.raises(ValueError) as got:
        KNNConfig(**kw)
    assert str(got.value) == str(want.value)


def test_grid_on_a_cpu_mesh_raises_as_jax_does_off_the_tpu():
    X = _corpus()
    kw = dict(k=3, backend="ring-overlap", ring_fusion="fused",
              ring_fused_rotation="grid", num_devices=2, query_tile=8,
              corpus_tile=16)
    with pytest.raises(ValueError, match="'grid' runs the whole rotation as "
                       "one .*use ring_fused_rotation='round' off"):
        jax_pkg.all_knn(X, **kw)
    with pytest.raises(ValueError) as err:
        all_knn(X, device="cpu", **kw)
    assert str(err.value) == str(ring.grid_off_card_error())
    assert "CUDA card" in str(err.value)


def test_grid_wrapper_refuses_an_int8_block_in_jax_words():
    t = torch.zeros((16, 4), dtype=torch.int8)
    ids = torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="float wire formats only .*int8"):
        fused_rotation.fused_rotation_grid(
            fused_rotation.ring_transport(["cpu"]), [torch.zeros((8, 4))],
            [torch.zeros(8, dtype=torch.int32)],
            [(t, ids, torch.ones(16))], [(torch.zeros((8, 1)),
                                          torch.zeros((8, 1), dtype=torch.int32))],
            [fused_rotation.landing_slots(t, ids, torch.ones(16))], c_tile=16)


def test_resumable_ring_refuses_grid():
    X = _corpus()
    ids = np.arange(len(X), dtype=np.int32)
    kw = dict(k=3, ring_fusion="fused", ring_fused_rotation="grid",
              num_devices=2, query_tile=8, corpus_tile=16)
    with pytest.raises(ValueError) as want:
        jax_ring_resumable(X, X, ids, jax_pkg.KNNConfig(**kw))
    with pytest.raises(ValueError) as got:
        all_knn_ring_resumable(X, X, ids, KNNConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)
