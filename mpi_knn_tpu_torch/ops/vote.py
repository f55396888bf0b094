"""Majority-vote classification: a one-hot histogram plus argmax, with the
correct nearest-neighbor tie-break by default and the two quirk modes that
replicate the C reference's winner scans (see the JAX package's
``ops/vote.py`` for the derivation of ``cmp_j``).

Class labels are 0-based ints in [0, num_classes).
"""

from __future__ import annotations

import torch

from mpi_knn_tpu_torch.types import ClassifyResult


def vote_counts(neigh_labels, valid, num_classes: int) -> torch.Tensor:
    """(q, k) 0-based labels + (q, k) validity -> (q, C) int32 histogram."""
    labels = torch.where(valid, neigh_labels, 0).long()
    onehot = torch.nn.functional.one_hot(labels, num_classes).to(torch.int32)
    onehot = onehot * valid[..., None].to(torch.int32)
    return torch.sum(onehot, dim=-2, dtype=torch.int32)


def _quirk_vote(counts: torch.Tensor, cmp_j: torch.Tensor) -> torch.Tensor:
    """The reference's winner scan, count and label conflated::

        most = 0;
        for (j = 0; j < C; j++)
          if (class[j] > most || (class[j] == most && j == cmp_j)) most = j+1;

    Returns 0-based predictions (−1 if the loop never assigned)."""
    most = torch.zeros(counts.shape[0], dtype=counts.dtype, device=counts.device)
    for j in range(counts.shape[-1]):
        cj = counts[:, j]
        take = (cj > most) | ((cj == most) & (cmp_j == j))
        most = torch.where(take, j + 1, most)
    return (most - 1).to(torch.int32)


def vote(neigh_labels, valid, num_classes: int, tie_break: str = "nearest"):
    """Classify each query by majority vote over its neighbors' labels.

    neigh_labels: (q, k) 0-based class of each neighbor, nearest first;
    valid: (q, k) bool; tie_break: nearest | lowest | quirk-serial |
    quirk-mpi.
    """
    counts = vote_counts(neigh_labels, valid, num_classes)
    nearest = torch.where(valid[:, 0], neigh_labels[:, 0], 0).to(torch.int32)
    any_valid = torch.any(valid, dim=-1)

    if tie_break == "quirk-serial":
        pred = _quirk_vote(counts, nearest)
    elif tie_break == "quirk-mpi":
        pred = _quirk_vote(counts, nearest - 1)
    elif tie_break in ("lowest", "nearest"):
        maxc = torch.max(counts, dim=-1, keepdim=True).values
        tied = counts == maxc
        # argmax returns the first maximal index: the lowest tied class
        lowest = torch.argmax(tied.to(torch.int32), dim=-1).to(torch.int32)
        if tie_break == "lowest":
            pred = lowest
        else:
            nearest_is_tied = torch.gather(tied, 1, nearest[:, None].long())[:, 0]
            pred = torch.where(nearest_is_tied, nearest, lowest)
    else:
        raise ValueError(f"unknown tie_break {tie_break!r}")

    # a query with no valid neighbor slot has no evidence: sentinel −1
    pred = torch.where(any_valid, pred, -1).to(torch.int32)
    return ClassifyResult(predictions=pred, counts=counts)


def classify_from_labels(ids, labels, num_classes: int,
                         tie_break: str = "nearest") -> ClassifyResult:
    """Gather neighbor labels from a global label vector and vote.

    ids: (q, k) 0-based global neighbor ids (−1 = invalid);
    labels: (m,) 0-based class per corpus point.
    """
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    neigh_labels = labels.to(torch.int32)[safe]
    return vote(neigh_labels, valid, num_classes, tie_break=tie_break)
