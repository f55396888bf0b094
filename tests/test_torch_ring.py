"""The port's ring backends (``backends/ring.py``) against the JAX
package's ``all_knn`` on its virtual CPU mesh.

For every ring size P in {1, 2, 3, 4}, both schedules and the four
(policy, wire) pairs the config admits, the port's three ring forms —
blocking with the xla merge, overlap with the xla merge, overlap with the
fused block merge — must equal the JAX package's ``ring-overlap`` result
bit for bit, ids and distances. The JAX package itself asserts that its
fused and blocking forms equal that one bit for bit
(``tests/test_ring_fused.py``, ``tests/test_ring.py``). The data make every
sum exact: integers in [−127, 127] over 16 with one ±127/16 entry per row
(bf16-exact, int8-lossless), centering off, and a planted duplicate.
k alternates between 3 (the compress pass applies at corpus_tile 16) and 5
(4k >= 16: the mixed policy's degenerate tile).
"""

import dataclasses

import numpy as np
import pytest
import torch

import mpi_knn_tpu as jax_pkg
from mpi_knn_tpu.backends import ring as jax_ring
from mpi_knn_tpu_torch import KNNClassifier, KNNConfig, all_knn
from mpi_knn_tpu_torch.api import resolve_backend
from mpi_knn_tpu_torch.backends import ring
from mpi_knn_tpu_torch.convert import classifier_from_reference
from mpi_knn_tpu_torch.parallel.mesh import make_ring_mesh

POLICY_WIRE = [("exact", None), ("exact", "bfloat16"), ("mixed", None),
               ("mixed", "int8")]
PORT_FORMS = [("ring", "xla"), ("ring-overlap", "xla"),
              ("ring-overlap", "fused")]


def _corpus(m=96, d=12, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.integers(-127, 128, (m, d)).astype(np.float32)
    X[np.arange(m), np.arange(m) % d] = 127.0
    X /= 16
    X[m // 6] = X[m // 2]
    return X


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("schedule", ["uni", "bidir"])
@pytest.mark.parametrize("policy,wire", POLICY_WIRE)
def test_ring_forms_bitwise_equal_to_jax(P, schedule, policy, wire):
    X = _corpus()
    kw = dict(k=3 if P % 2 == 0 else 5, num_devices=P, query_tile=8,
              corpus_tile=16, center=False, ring_schedule=schedule,
              precision_policy=policy, ring_transfer_dtype=wire)
    want = jax_pkg.all_knn(X, backend="ring-overlap", ring_fusion="xla", **kw)
    for backend, fusion in PORT_FORMS:
        got = all_knn(X, backend=backend, ring_fusion=fusion, device="cpu",
                      **kw)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.dists.numpy(),
                                      np.asarray(want.dists))


def test_query_mode_with_ids_on_the_ring():
    X = _corpus(seed=4)
    rows = np.arange(0, 96, 5)
    kw = dict(k=4, num_devices=3, query_tile=8, corpus_tile=16, center=False,
              backend="ring-overlap")
    want = jax_pkg.all_knn(X, queries=X[rows], query_ids=rows, **kw)
    got = all_knn(X, queries=X[rows], query_ids=rows, ring_fusion="fused",
                  device="cpu", **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    assert not (got.ids.numpy() == rows[:, None]).any()


def test_loo_report_on_the_ring_matches_jax():
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((256, 16)) * 3.0).astype(np.float32)
    y = rng.integers(0, 4, 256).astype(np.int32)
    ref_cfg = jax_pkg.KNNConfig(k=5, num_classes=4, backend="ring-overlap",
                                num_devices=4, query_tile=16, corpus_tile=32)
    ref = jax_pkg.KNNClassifier(config=ref_cfg).fit(X, y).loo_report()
    d = dataclasses.asdict(ref_cfg)
    d["ring_fusion"] = "fused"
    port = classifier_from_reference(d, X, y, device="cpu").loo_report()
    assert port.matches == ref.matches
    np.testing.assert_array_equal(port.classify.predictions.numpy(),
                                  np.asarray(ref.classify.predictions))


def test_fused_under_blocking_is_refused_in_the_reference_words():
    X = _corpus()
    with pytest.raises(ValueError) as err:
        all_knn(X, k=3, backend="ring", ring_fusion="fused", num_devices=2,
                device="cpu")
    assert str(err.value) == str(jax_ring.fused_blocking_undefined_error())


def test_dp_by_ring_mesh_is_refused():
    """A dp×ring mesh runs under the overlap schedule (``tests/
    test_torch_mesh2d.py``); under the blocking one it is refused in the
    reference's words."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError) as err:
        all_knn(_corpus(), k=3, backend="ring",
                mesh=[[cpu, cpu], [cpu, cpu]], device="cpu")
    assert str(err.value) == str(
        jax_ring.blocking_undefined_on_mesh_error(("dp", "ring")))


def test_ring_mesh():
    mesh = make_ring_mesh(4, device="cpu")
    assert list(mesh) == [torch.device("cpu")] * 4 and mesh.axis_name == "ring"
    card = torch.device("cuda", 0)
    shared = make_ring_mesh(devices=[card] * 4, axis_name="r")
    assert len(shared) == 4 and shared.axis_name == "r"
    with pytest.raises(ValueError, match="requested 3 devices, only 2"):
        make_ring_mesh(3, devices=[card, card])
    # an explicit mesh sets the ring size
    X = _corpus()
    got = all_knn(X, k=3, backend="ring-overlap", mesh=mesh, device="cpu",
                  query_tile=8, corpus_tile=16, center=False)
    want = jax_pkg.all_knn(X, k=3, backend="ring-overlap", num_devices=4,
                           query_tile=8, corpus_tile=16, center=False)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))


@pytest.mark.parametrize("P", [1, 3, 4, 8])
def test_ring_plans_match_jax(P):
    assert ring.bidir_rounds(P) == jax_ring.bidir_rounds(P)
    for m, nq in ((96, 96), (60000, 60000), (1000, 37)):
        for qt, ct in ((8, 16), (1024, 2048)):
            jcfg = jax_pkg.KNNConfig(query_tile=qt, corpus_tile=ct)
            pcfg = KNNConfig(query_tile=qt, corpus_tile=ct)
            assert (ring.ring_tiles(pcfg, m, nq, 1, P)
                    == jax_ring.ring_tiles(jcfg, m, nq, 1, P))
    for kw in (dict(), dict(ring_transfer_dtype="bfloat16"),
               dict(ring_transfer_dtype="int8", precision_policy="mixed"),
               dict(ring_schedule="bidir")):
        assert (ring.ring_wire_bytes_per_batch(KNNConfig(**kw), 61440, 784, P)
                == jax_ring.ring_wire_bytes_per_batch(
                    jax_pkg.KNNConfig(**kw), 61440, 784, P))


def test_auto_resolves_to_the_ring_on_several_ranks():
    clf = KNNClassifier(k=3, num_devices=2, device="cpu")
    assert resolve_backend(clf.config, device="cpu") == "ring-overlap"
    assert resolve_backend(KNNConfig(), device="cpu") == "serial"


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("P", [1, 3, 4])
def test_nan_query_row_in_the_mixed_fused_ring_matches_jax(wire, P):
    """A NaN query row through the mixed fused ring (K3b, then the exact
    finish): its row and its neighbours' rows equal the JAX ring's, in
    query mode and in all-pairs mode (where the NaN row is also a corpus
    row every other query must pass over)."""
    X = _corpus()
    rows = np.arange(0, 96, 4)
    Q = X[rows].copy()
    Q[3] = np.nan
    kw = dict(k=3, num_devices=P, query_tile=8, corpus_tile=16, center=False,
              precision_policy="mixed", ring_transfer_dtype=wire,
              backend="ring-overlap")
    want = jax_pkg.all_knn(X, queries=Q, query_ids=rows, ring_fusion="xla",
                           **kw)
    got = all_knn(X, queries=Q, query_ids=rows, ring_fusion="fused",
                  device="cpu", **kw)
    for r in (2, 3, 4):
        np.testing.assert_array_equal(got.ids[r].numpy(),
                                      np.asarray(want.ids)[r])
        np.testing.assert_array_equal(got.dists[r].numpy(),
                                      np.asarray(want.dists)[r])
    assert (got.ids[3].numpy() == -1).all()
    Xn = X.copy()
    Xn[10] = np.nan
    want = jax_pkg.all_knn(Xn, ring_fusion="xla", **kw)
    got = all_knn(Xn, ring_fusion="fused", device="cpu", **kw)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))


def _run(form, P=3, k=3, **cfg_kw):
    """A RingRun of ``form`` over P logical CPU ranks of ``_corpus``."""
    from mpi_knn_tpu_torch.ops.topk import init_topk

    X = _corpus()
    cfg = KNNConfig(k=k, backend="ring-overlap", query_tile=8, corpus_tile=16,
                    center=False, **cfg_kw)
    devices = [torch.device("cpu")] * P
    q_tile, c_tile, q_sh, qid_sh, travelers = ring.ring_shards(
        cfg, X, X, np.arange(96, dtype=np.int32), devices)
    carries = [init_topk(q.shape[0], k) for q in q_sh]
    return ring.RingRun(cfg, devices, True, form, q_sh, qid_sh, travelers,
                        carries, q_tile, c_tile)


def test_round_form_stages_the_plain_split_of_each_block():
    """The dma form on the f32 wire stages each rank's block and queries
    through K4's prologue: on the CPU the plain split
    (stage_tf32_split_reference), planes and norms, once per call."""
    from mpi_knn_tpu_torch.ops.fused_knn import split_width, stage_tf32_split_reference

    run = _run("dma", ring_fusion="fused")
    for t, q, qn, (qh, ql) in zip(run.travelers[0], run.q_sh, run.q_norms,
                                  run.q_planes):
        blk, _, scl, norms, hi, lo = t
        assert scl is None
        want = stage_tf32_split_reference(blk, split_width(blk.shape[1]))
        for g, w in zip((hi, lo, norms), want):
            assert torch.equal(g, w)
        want_q = stage_tf32_split_reference(q, split_width(q.shape[1]))
        for g, w in zip((qh, ql, qn), want_q):
            assert torch.equal(g, w)
    # the landing slots have room for the planes
    assert all(s[4] is not None and s[5] is not None for s in run.slots)


@pytest.mark.parametrize("form,cfg_kw,planes", [
    ("dma", dict(ring_fusion="fused"), True),
    ("dma", dict(ring_fusion="fused", ring_transfer_dtype="bfloat16"), False),
    ("dma", dict(ring_fusion="fused", ring_transfer_dtype="int8",
                 precision_policy="mixed", k=5), False),
    ("driver", dict(ring_fusion="fused"), False),
    ("grid", dict(ring_fusion="fused"), False),
    ("driver", dict(ring_fusion="fused", precision_policy="mixed"), False),
    ("driver", dict(ring_fusion="xla"), False),
])
def test_round_form_stages_planes_only_for_exact_f32(form, cfg_kw, planes):
    """Planes (the traveler's fifth and sixth parts, and the queries') are
    staged for K4's wgmma tile only: the dma form, the exact merge, the
    f32 wire; everywhere else they are None."""
    run = _run(form, **cfg_kw)
    for t in run.travelers[0]:
        assert len(t) == 6
        assert (t[4] is not None) == planes and (t[5] is not None) == planes
    assert (run.q_planes is not None) == planes

