"""KNNClassifier — brute-force kNN classification, the whole workload of
the C reference: fit a corpus, all-kNN, majority vote, matches.

A plain class: kNN has no parameters, so it is not an ``nn.Module``. Labels
are 0-based; pass ``one_based_labels=True`` for 1..C labels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.types import ClassifyResult, KNNResult


@dataclasses.dataclass
class LooReport:
    """Leave-one-out evaluation (the reference's ``Matches: %d``)."""

    matches: int
    total: int
    accuracy: float
    result: KNNResult
    classify: ClassifyResult


class KNNClassifier:
    """fit/predict wrapper over the functional API.

    Example::

        clf = KNNClassifier(k=10, backend="pallas", device="cuda")
        report = clf.fit(X, y).loo_report()
    """

    def __init__(self, k: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 config: Optional[KNNConfig] = None,
                 one_based_labels: bool = False, device=DEFAULT_DEVICE,
                 **overrides):
        if k is not None:
            overrides["k"] = k
        if num_classes is not None:
            overrides["num_classes"] = num_classes
        self.config = (config or KNNConfig()).replace(**overrides)
        self.one_based_labels = one_based_labels
        self.device = resolve_device(device)
        self._corpus: Optional[np.ndarray] = None
        self._labels: Optional[np.ndarray] = None

    def fit(self, X, y) -> KNNClassifier:
        X = np.asarray(X)
        y = np.asarray(y).astype(np.int32).reshape(-1)
        if self.one_based_labels:
            y = y - 1
        if y.min() < 0 or y.max() >= self.config.num_classes:
            raise ValueError(
                f"labels out of range [0, {self.config.num_classes}) after "
                f"{'1-based' if self.one_based_labels else '0-based'} mapping"
            )
        if X.shape[0] != y.shape[0]:
            raise ValueError(f"X has {X.shape[0]} rows, y has {y.shape[0]}")
        self._corpus = X
        self._labels = y
        return self

    def _require_fit(self):
        if self._corpus is None:
            raise RuntimeError("call fit(X, y) first")

    def kneighbors(self, queries=None) -> KNNResult:
        """Top-k neighbors; queries=None = all-pairs leave-one-out mode."""
        from mpi_knn_tpu_torch.api import all_knn

        self._require_fit()
        return all_knn(self._corpus, queries=queries, config=self.config,
                       device=self.device)

    def classify(self, result: KNNResult) -> ClassifyResult:
        from mpi_knn_tpu_torch.api import knn_classify

        self._require_fit()
        return knn_classify(result, self._labels,
                            num_classes=self.config.num_classes,
                            tie_break=self.config.tie_break)

    def predict(self, queries=None) -> np.ndarray:
        pred = self.classify(self.kneighbors(queries)).predictions.cpu().numpy()
        return pred + 1 if self.one_based_labels else pred

    def loo_report(self) -> LooReport:
        self._require_fit()
        result = self.kneighbors(None)
        cls = self.classify(result)
        matches = int(cls.matches(self._labels))
        total = int(self._labels.shape[0])
        return LooReport(matches=matches, total=total,
                         accuracy=matches / total, result=result,
                         classify=cls)
