"""Clustered (IVF) index on one device: the k-means partitioner and the
recall-targeted two-stage search (the JAX package's ``mpi_knn_tpu.ivf``,
without the sharded index). Score the centroids, scan only the ``nprobe``
nearest partitions, finish exactly: the bytes a query reads are
nprobe/partitions of the corpus.

    from mpi_knn_tpu_torch import KNNConfig, query_knn
    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf

    idx = build_ivf_index(X, KNNConfig(k=10, partitions=64))  # nprobe tuned
    d, i = search_ivf(idx, Q)                  # one shot
    res = query_knn(Q, idx)                    # the serving engine

    save_ivf_index(idx, "corpus.ivf.npz")      # the JAX package's format
    idx = load_ivf_index("corpus.ivf.npz")

The command line is ``python -m mpi_knn_tpu_torch build-index``
(``ivf/cli.py``), then ``query --index-load``.
"""

from mpi_knn_tpu_torch.ivf.index import (
    IVFIndex,
    build_ivf_index,
    load_ivf_index,
    save_ivf_index,
    tune_nprobe,
)
from mpi_knn_tpu_torch.ivf.kmeans import KMeansResult, kmeans, lloyd
from mpi_knn_tpu_torch.ivf.search import ivf_query_tile, search_ivf

__all__ = [
    "IVFIndex",
    "KMeansResult",
    "build_ivf_index",
    "ivf_query_tile",
    "kmeans",
    "lloyd",
    "load_ivf_index",
    "save_ivf_index",
    "search_ivf",
    "tune_nprobe",
]
