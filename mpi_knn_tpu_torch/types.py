"""Result containers on torch tensors (structure of arrays: distances and
0-based global ids in separate tensors, as in the JAX package)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

# Sentinel index used for padded / masked-out candidate rows.
INVALID_ID = -1


@dataclasses.dataclass(frozen=True)
class KNNResult:
    """Top-k nearest neighbors for a batch of queries.

    Attributes:
      dists: (q, k) float tensor in sortable space — squared L2 for ``l2``,
        ``1 − cosine`` for ``cosine``. Ascending along k.
      ids: (q, k) int32 tensor of 0-based global corpus ids; ``INVALID_ID``
        marks unfilled slots.
    """

    dists: torch.Tensor
    ids: torch.Tensor

    @property
    def k(self) -> int:
        return self.ids.shape[-1]

    def l2_dists(self) -> torch.Tensor:
        """True (non-squared) L2 distances."""
        return torch.sqrt(torch.clamp_min(self.dists, 0.0))

    def one_based(self) -> torch.Tensor:
        """1-based ids for parity with the C reference (invalid stays -1)."""
        return torch.where(self.ids >= 0, self.ids + 1, self.ids)

    def valid(self) -> torch.Tensor:
        return self.ids >= 0


@dataclasses.dataclass(frozen=True)
class ClassifyResult:
    """Output of kNN majority-vote classification."""

    predictions: torch.Tensor  # (q,) int32, 0-based class ids (-1: no vote)
    counts: torch.Tensor  # (q, num_classes) int32 vote histogram

    def matches(self, true_labels: Any) -> torch.Tensor:
        """Number of correct predictions (the reference's ``Matches:``)."""
        labels = torch.as_tensor(true_labels, device=self.predictions.device)
        return torch.sum(self.predictions == labels)
