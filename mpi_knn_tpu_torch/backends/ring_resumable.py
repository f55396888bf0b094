"""Resumable ring execution: the ring driven one round at a time from the
host, with the top-k carry checkpointed between rounds (the JAX package's
``backends/ring_resumable.py``).

Each round is a round of ``backends/ring.RingRun``, in the transport form
``ring_form`` picks: on cards an exact uni fused round is one K4 launch per
card, which moves the block as it merges. The last round moves nothing, as
in the reference, so it merges through the driver form's kernel (K3a); on
the f32 wire it takes the norms K4's prologue staged, which equal K3a's
own prologue's bit for bit.
A checkpoint is (carry, rounds_done, fingerprint): the rotating block needs
no saving, because after r rounds rank i holds corpus block (i − r) mod P,
rebuilt on resume by rolling the padded corpus r blocks forward before
sharding. Under ``ring_schedule="bidir"`` the same cursor rebuilds both
travelers (forward at i − r, backward at i + r), the loop runs ⌊P/2⌋+1
rounds, and the schedule, the overlap and the fusion are folded into the
fingerprint so carries of different round algebras never cross-resume.

``stop_after_rounds`` is the fault-injection hook: tests stop the run at
any round and check that the resumed result equals an uninterrupted one
bit for bit. The grid form has no round boundary and is refused. On a 2-D
(dp × ring) mesh every dp group's ring runs the same round at once, the
checkpoint holds every group's carry in (group, rank) order, and the
fingerprint names the grid (``ring{P}x{dp}``); the blocking schedule there
raises, as in ``all_knn_ring``. The JAX package's multi-host broadcast of
the checkpoint is not ported: the port runs single-controller.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.backends.ring import (
    RingRun,
    bidir_rounds,
    fused_blocking_undefined_error,
    gathered,
    grid_resumable_error,
    ring_form,
    ring_groups,
    ring_layout,
)
from mpi_knn_tpu_torch.backends.serial import torch_dtype
from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.ops.topk import init_topk
from mpi_knn_tpu_torch.utils.checkpoint import (
    KNNCheckpoint,
    fingerprint,
    load_checkpoint,
    log,
    save_checkpoint,
)


def all_knn_ring_resumable(corpus, queries, query_ids, cfg: KNNConfig,
                           mesh=None, overlap: bool = True,
                           checkpoint_dir=None, save_every: int = 1,
                           stop_after_rounds=None, progress_cb=None,
                           device=DEFAULT_DEVICE):
    """Ring all-kNN with host-driven rounds and carry checkpoints.

    Returns ((q, k) dists, (q, k) ids) on ``device``; with
    ``stop_after_rounds`` set, the partial carry after that many rounds (a
    later call with the same ``checkpoint_dir`` completes the run).
    """
    if cfg.ring_fusion == "fused" and cfg.ring_fused_rotation == "grid":
        raise grid_resumable_error()
    dev = resolve_device(device)
    groups = ring_groups(cfg, mesh, dev, overlap)
    if cfg.ring_fusion == "fused" and not overlap:
        raise fused_blocking_undefined_error()
    dp, P = len(groups), len(groups[0])
    bidir = cfg.ring_schedule == "bidir"
    rounds_total, bwd_limit = bidir_rounds(P) if bidir else (P, 0)

    on_card = isinstance(corpus, torch.Tensor)
    corpus = corpus if on_card else np.asarray(corpus)
    all_pairs = queries is corpus
    if not isinstance(queries, torch.Tensor):
        queries = corpus if all_pairs else np.asarray(queries)
    # run identity: data + config + ring layout; the schedule and fusion
    # ride the suffix too, since the same rounds_done means another merged
    # prefix under another schedule
    fp = (fingerprint(corpus, queries, cfg)
          + f":ring{P}x{dp}:{int(overlap)}:{cfg.ring_schedule}"
          + f":{cfg.ring_fusion}")
    if cfg.center and cfg.metric == "l2":
        # a tensor is centered in f32 where it lies, a host array in f64:
        # carries of the two residencies differ near ties, so the residency
        # is part of the run identity
        fp += f":ctr-{'dev' if on_card else 'host'}"
        from mpi_knn_tpu_torch.ops.distance import center_for_l2

        corpus, queries = center_for_l2(corpus, queries, all_pairs)

    acc = torch.float64 if torch_dtype(cfg.dtype) == torch.float64 else torch.float32
    start_round, saved = 0, None
    if checkpoint_dir is not None:
        state = load_checkpoint(checkpoint_dir, fp)
        if state is not None:
            start_round, saved = state.tiles_done, state  # rounds done
            log.info("resuming ring at round %d/%d from %s", start_round,
                     rounds_total, checkpoint_dir)

    q_tile, c_tile, parts = ring_layout(cfg, corpus, queries, query_ids,
                                        groups, start_round)
    ql = parts[0][0][0].shape[0]
    form = ring_form(cfg, groups[0])
    runs = []
    for g, (devices, (q_sh, qid_sh, travelers)) in enumerate(zip(groups, parts)):
        if saved is None:
            carries = [init_topk(ql, cfg.k, dtype=acc, device=d) for d in devices]
        else:
            cd = torch.as_tensor(saved.carry_d, dtype=acc)
            ci = torch.as_tensor(saved.carry_i)
            rows = [((g * P + r) * ql, (g * P + r + 1) * ql) for r in range(P)]
            carries = [(cd[a:b].to(d), ci[a:b].to(d))
                       for (a, b), d in zip(rows, devices)]
        runs.append(RingRun(cfg, devices, overlap, form, q_sh, qid_sh,
                            travelers, carries, q_tile, c_tile, group=g))

    total = rounds_total if stop_after_rounds is None else min(
        rounds_total, start_round + stop_after_rounds)
    for r in range(start_round, total):
        for run in runs:
            run.round(merge_bwd=1 <= r < bwd_limit, rotate=r + 1 < rounds_total)
        done = r + 1
        if checkpoint_dir is not None and (
                done % save_every == 0 or done == rounds_total):
            cd, ci = gathered(runs, "cpu", dp * P * ql)
            save_checkpoint(checkpoint_dir, KNNCheckpoint(
                carry_d=cd.numpy(), carry_i=ci.numpy(), tiles_done=done,
                fingerprint=fp))
        log.debug("ring round %d/%d done", done, rounds_total)
        if progress_cb is not None:
            progress_cb(done, rounds_total)

    return gathered(runs, dev, queries.shape[0])
