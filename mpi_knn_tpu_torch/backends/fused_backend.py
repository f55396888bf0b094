"""Fused-kernel backend (``backend="pallas"``): the routing of the JAX
package's ``backends/pallas_backend.py`` around the hand-written Hopper
kernels of ``ops/fused_knn.py``.

- ``pallas_variant="tiles"``: each corpus tile's k survivors from the
  kernel, then one ``smallest_k`` merge outside it (honors
  ``topk_method``);
- ``"sweep"``: the kernel merges the whole corpus itself and emits (Q, k).

Under ``precision_policy="mixed"`` (when the overfetch can drop anything)
the kernels run in compress mode and keep the overfetch width ``ov = 4k``
per list; the tiles variant first preselects the global ov of its n_c·ov
survivors by compressed key, then ``_mixed_exact_finish`` reranks the
survivors exactly, one query tile at a time.

Same observable semantics as the serial backend. Only float32 runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.ops.distance import _NORM_EPS, _l2_normalize, sq_norms
from mpi_knn_tpu_torch.ops.fused_knn import (
    _ZERO_RTOL,
    fused_knn_sweep,
    fused_knn_tiles,
)
from mpi_knn_tpu_torch.ops.rerank import (
    mixed_applies,
    overfetch_width,
    rerank_exact_topk,
)
from mpi_knn_tpu_torch.ops.topk import smallest_k
from mpi_knn_tpu_torch.parallel.partition import pad_rows_any, pad_to_multiple


def _mixed_exact_finish(queries, corpus, cand_i, cfg, q_tile, all_pairs):
    """Pass 2 of the mixed policy: gather each query tile's survivors
    (never a (Q, V, d) gather at once), rerank exactly, final top-k."""
    Q = queries.shape[0]
    out_d, out_i = [], []
    for r0 in range(0, Q, q_tile):
        ci = cand_i[r0:r0 + q_tile]
        q_ids = (torch.arange(r0, r0 + ci.shape[0], dtype=torch.int32,
                              device=ci.device) if all_pairs
                 else torch.full((ci.shape[0],), -1, dtype=torch.int32,
                                 device=ci.device))
        d, i = rerank_exact_topk(
            queries[r0:r0 + q_tile], q_ids, corpus[ci.clamp_min(0).long()],
            ci, cfg.k, metric="l2",
            exclude_self=cfg.exclude_self and all_pairs,
            exclude_zero=cfg.exclude_zero, zero_eps=cfg.zero_eps,
        )
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)


def fused_query_tile(cfg: KNNConfig, nq: int) -> int:
    """The fused backend's query tile for ``nq`` query rows."""
    return min(max(8, pad_to_multiple(cfg.query_tile, 8)), 512,
               pad_to_multiple(nq, 8))


def fused_corpus_tile(cfg: KNNConfig, m: int) -> int:
    """The fused backend's corpus tile for an ``m``-row corpus."""
    return min(max(128, pad_to_multiple(cfg.corpus_tile, 128)), 2048,
               pad_to_multiple(m, 128))


def resolve_variant(cfg: KNNConfig, c_tile: int) -> str:
    """``cfg.pallas_variant``, but k > c_tile routes to tiles, whose
    cross-tile merge tops up."""
    if cfg.pallas_variant == "sweep" and cfg.k > c_tile:
        return "tiles"
    return cfg.pallas_variant


def _fused_all_knn(queries, corpus, cfg, q_tile, c_tile, m_corpus,
                   all_pairs, variant, staged_corpus=None):
    if cfg.precision_policy == "mixed" and mixed_applies(cfg.k, c_tile):
        ov = overfetch_width(cfg.k, c_tile)
        common = dict(m_corpus=m_corpus, k=ov, q_tile=q_tile, c_tile=c_tile,
                      exclude_self=cfg.exclude_self,
                      exclude_zero=cfg.exclude_zero, all_pairs=all_pairs,
                      zero_eps=cfg.zero_eps, compress=True,
                      staged_corpus=staged_corpus)
        if variant == "sweep":
            _, cand_i = fused_knn_sweep(queries, corpus, **common)
        else:
            cand_d, cand_i = fused_knn_tiles(queries, corpus, **common)
            # n_c·ov survivors per query -> the global ov by compressed key
            if cand_i.shape[1] > ov:
                _, cand_i = smallest_k(cand_d, cand_i, ov, method="exact")
        return _mixed_exact_finish(queries, corpus, cand_i, cfg, q_tile,
                                   all_pairs)
    common = dict(
        m_corpus=m_corpus,
        q_tile=q_tile,
        c_tile=c_tile,
        exclude_self=cfg.exclude_self,
        exclude_zero=cfg.exclude_zero,
        all_pairs=all_pairs,
        zero_eps=cfg.zero_eps,
        staged_corpus=staged_corpus,
    )
    if variant == "sweep":
        # the in-kernel merge is exact; topk_method does not apply
        return fused_knn_sweep(queries, corpus, k=cfg.k, **common)
    outd, outi = fused_knn_tiles(queries, corpus, k=min(cfg.k, c_tile),
                                 **common)
    # cross-tile merge: k survivors per corpus tile -> final k
    return smallest_k(outd, outi, cfg.k, method=cfg.topk_method,
                      recall_target=cfg.recall_target, block=cfg.topk_block)


def all_knn_pallas(corpus, queries, query_ids, cfg: KNNConfig, device):
    if cfg.dtype != "float32":
        raise ValueError(
            f"the fused backend computes in float32; dtype={cfg.dtype!r} is "
            "not supported (use the serial backend for bf16/f64)"
        )
    m, _ = corpus.shape
    nq = queries.shape[0]

    # Cosine rides the L2 kernels on unit rows (d² = 2·d_cos), halved on
    # the way out; the zero-exclusion epsilon doubles into d² space.
    cosine = cfg.metric == "cosine"
    if cosine:
        all_pairs_same = queries is corpus
        corpus = torch.as_tensor(corpus, dtype=torch.float32).to(device)
        queries = corpus if all_pairs_same else torch.as_tensor(
            queries, dtype=torch.float32).to(device)
        # a row _l2_normalize would clamp (zero or sub-clamp norm) breaks
        # the identity: route the whole call to serial, decided from the
        # data before any launch
        any_zero = (sq_norms(corpus) <= _NORM_EPS).any()
        if not all_pairs_same:
            any_zero = any_zero | (sq_norms(queries) <= _NORM_EPS).any()
        if bool(any_zero):
            from mpi_knn_tpu_torch.backends.serial import all_knn_serial

            return all_knn_serial(corpus, queries, query_ids, cfg, device)
        corpus = _l2_normalize(corpus)
        queries = corpus if all_pairs_same else _l2_normalize(queries)
        zero_eps = 2.0 * (cfg.zero_eps if cfg.zero_eps > 0 else _ZERO_RTOL * 2.0)
        cfg = cfg.replace(zero_eps=zero_eps)
    # candidate/query ids come from position: all-pairs (query i is corpus
    # row i) or query mode (queries carry no corpus identity)
    all_pairs = bool(
        nq == m and np.array_equal(np.asarray(query_ids),
                                   np.arange(m, dtype=np.int32))
    )

    q_tile = fused_query_tile(cfg, nq)
    c_tile = fused_corpus_tile(cfg, m)
    corpus_p = pad_rows_any(corpus, pad_to_multiple(m, c_tile),
                            dtype=torch.float32, device=device)
    q_pad = pad_to_multiple(nq, q_tile)
    if queries is corpus and q_pad <= corpus_p.shape[0]:
        # all pairs: the queries are the padded corpus' first rows, so the
        # exact prologue stages them once with the corpus
        queries_p = corpus_p[:q_pad]
    else:
        queries_p = pad_rows_any(queries, q_pad, dtype=torch.float32,
                                 device=device)

    best_d, best_i = _fused_all_knn(queries_p, corpus_p, cfg, q_tile, c_tile,
                                    m, all_pairs, resolve_variant(cfg, c_tile))
    if cosine:
        best_d = best_d * 0.5
    return best_d[:nq], best_i[:nq]


def serve_batch_pallas(queries_p, corpus_p, staged_corpus, cfg: KNNConfig,
                       q_tile: int, c_tile: int, m_corpus: int):
    """One padded query batch against a resident padded corpus (the JAX
    package's ``serve/engine.py::_pallas_serve_fn``): ``all_knn``'s routing
    in query mode (mixed, the tiles merge, k > c_tile), with the corpus's
    prologue outputs ``staged_corpus`` staged once, so on the card only the
    queries are staged. Returns (q_pad, k) dists and ids."""
    return _fused_all_knn(queries_p, corpus_p, cfg, q_tile, c_tile, m_corpus,
                          False, resolve_variant(cfg, c_tile), staged_corpus)
