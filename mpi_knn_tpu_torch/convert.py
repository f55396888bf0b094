"""Carry state across from the JAX package.

kNN has no weights: its state is the config plus the fitted corpus and
labels, or a trained clustered index. ``config_from_reference`` takes
``dataclasses.asdict`` of a JAX ``KNNConfig``; unknown fields and settings
this port refuses raise. ``ivf_index_from_reference`` carries a JAX
``IVFIndex`` across as host arrays.
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


def ivf_index_from_reference(state: dict, device):
    """The port's :class:`~mpi_knn_tpu_torch.ivf.index.IVFIndex` from a JAX
    ``IVFIndex`` given as host values: ``cfg`` (``dataclasses.asdict``),
    ``m``, ``dim``, ``partitions``, ``bucket_cap``, ``nprobe``,
    ``tuned_recall``, ``mu`` (or None) and the numpy arrays
    ``centroids``, ``centroid_sqs``, ``buckets`` (bfloat16 as numpy's
    ``bfloat16`` extension dtype or its uint16 view), ``bucket_ids``,
    ``bucket_sqs`` and ``bucket_scales`` (None for a float store). Every
    array is copied as is, so both packages search the same index."""
    import torch

    from mpi_knn_tpu_torch.ivf.index import IVFIndex
    from mpi_knn_tpu_torch.serve.index import canonical_device

    dev = canonical_device(device)
    cfg = config_from_reference(state["cfg"])

    def tensor(a):
        return torch.from_numpy(np.array(a)).to(dev)

    buckets = np.asarray(state["buckets"])
    if cfg.dtype == "bfloat16":
        buckets = tensor(buckets.view(np.int16)).view(torch.bfloat16)
    else:
        buckets = tensor(buckets)
    scales = state.get("bucket_scales")
    mu = state.get("mu")
    return IVFIndex(
        cfg=cfg, m=int(state["m"]), dim=int(state["dim"]),
        partitions=int(state["partitions"]),
        bucket_cap=int(state["bucket_cap"]), nprobe=int(state["nprobe"]),
        tuned_recall=state.get("tuned_recall"),
        mu=None if mu is None else np.array(mu, dtype=np.float64),
        device=dev, centroids=tensor(state["centroids"]),
        centroid_sqs=tensor(state["centroid_sqs"]), buckets=buckets,
        bucket_ids=tensor(state["bucket_ids"]),
        bucket_sqs=tensor(state["bucket_sqs"]),
        bucket_scales=None if scales is None else tensor(scales),
    )
