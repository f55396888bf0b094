"""Carry state across from the JAX package.

kNN has no weights: its state is the config plus the fitted corpus and
labels. ``config_from_reference`` takes ``dataclasses.asdict`` of a JAX
``KNNConfig``; unknown fields and settings this port refuses raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.models.classifier import KNNClassifier


def config_from_reference(d: dict) -> KNNConfig:
    known = {f.name for f in dataclasses.fields(KNNConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown KNNConfig fields: {unknown}")
    return KNNConfig(**d)


def classifier_from_reference(config_dict: dict, X: np.ndarray,
                              y: np.ndarray, device) -> KNNClassifier:
    """A fitted port classifier with the reference's config and data."""
    cfg = config_from_reference(config_dict)
    return KNNClassifier(config=cfg, device=device).fit(X, y)
