"""Resumable serial execution: the serial backend's corpus-tile stream
driven from the host in rounds, with the top-k carry checkpointed between
rounds (the JAX package's ``backends/resumable.py``).

The math is the serial backend's (``knn_chunk_update``), with the corpus
scan cut into host-visible chunks of ``save_every`` tiles, so a killed run
restarts from the last saved round. It runs no kernel. The CLI's
``--checkpoint-dir`` routes every non-ring backend here.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.backends.serial import (
    effective_tiles,
    knn_chunk_update,
    prepare_tiles,
)
from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.ops.topk import init_topk_tiles
from mpi_knn_tpu_torch.utils.checkpoint import (
    KNNCheckpoint,
    fingerprint,
    load_checkpoint,
    log,
    save_checkpoint,
)


def all_knn_resumable(corpus, queries, query_ids, cfg: KNNConfig,
                      checkpoint_dir=None, save_every: int = 8,
                      progress_cb=None, device=DEFAULT_DEVICE):
    """Serial all-kNN with host-driven rounds of ``save_every`` corpus tiles.

    If ``checkpoint_dir`` holds a state of this (data, config), the run
    resumes after the last completed round. Returns ((q, k) dists, ids) on
    ``device``.
    """
    dev = resolve_device(device)
    corpus = np.asarray(corpus)
    queries = np.asarray(queries)
    fp = fingerprint(corpus, queries, cfg)  # the data as the caller gave it
    all_pairs = queries is corpus or (
        queries.shape == corpus.shape and np.shares_memory(queries, corpus))
    if cfg.center and cfg.metric == "l2":
        from mpi_knn_tpu_torch.ops.distance import center_for_l2

        corpus, queries = center_for_l2(corpus, queries, all_pairs)

    nq = queries.shape[0]
    q_tile, c_tile = effective_tiles(cfg, corpus.shape[0], nq)
    q_tiles, qid_tiles, corpus_tiles, corpus_tile_ids, q_pad = prepare_tiles(
        corpus, queries, query_ids, cfg, q_tile, c_tile, dev)
    tiles = corpus_tiles.shape[0]
    acc = torch.float64 if q_tiles.dtype == torch.float64 else torch.float32
    start_tile = 0
    carry_d, carry_i = init_topk_tiles(q_pad // q_tile, q_tile, cfg.k,
                                       dtype=acc, device=dev)

    if checkpoint_dir is not None:
        state = load_checkpoint(checkpoint_dir, fp)
        if state is not None:
            start_tile = state.tiles_done
            carry_d = torch.as_tensor(state.carry_d, dtype=acc, device=dev)
            carry_i = torch.as_tensor(state.carry_i, device=dev)
            log.info("resuming serial stream at tile %d/%d from %s",
                     start_tile, tiles, checkpoint_dir)

    for t0 in range(start_tile, tiles, save_every):
        t1 = min(t0 + save_every, tiles)
        carry_d, carry_i = knn_chunk_update(
            q_tiles, qid_tiles, corpus_tiles[t0:t1], corpus_tile_ids[t0:t1],
            carry_d, carry_i, cfg)
        if checkpoint_dir is not None:
            save_checkpoint(checkpoint_dir, KNNCheckpoint(
                carry_d=carry_d.cpu().numpy(), carry_i=carry_i.cpu().numpy(),
                tiles_done=t1, fingerprint=fp))
        if progress_cb is not None:
            progress_cb(t1, tiles)

    return (carry_d.reshape(q_pad, cfg.k)[:nq],
            carry_i.reshape(q_pad, cfg.k)[:nq])
