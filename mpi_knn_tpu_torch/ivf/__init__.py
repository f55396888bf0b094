"""Clustered (IVF) index: the k-means partitioner and the
recall-targeted two-stage search (the JAX package's ``mpi_knn_tpu.ivf``).
Score the centroids, scan only the ``nprobe`` nearest partitions, finish
exactly: the bytes a query reads are nprobe/partitions of the corpus. The
sharded index (``ivf/sharded.py``) spreads the bucket store over a ring
mesh and routes each probe to the shard that holds it.

    from mpi_knn_tpu_torch import KNNConfig, query_knn
    from mpi_knn_tpu_torch.ivf import build_ivf_index, search_ivf

    idx = build_ivf_index(X, KNNConfig(k=10, partitions=64))  # nprobe tuned
    d, i = search_ivf(idx, Q)                  # one shot
    res = query_knn(Q, idx)                    # the serving engine

    save_ivf_index(idx, "corpus.ivf.npz")      # the JAX package's format
    idx = load_ivf_index("corpus.ivf.npz")

    sidx = shard_ivf_index(idx, shards=4)      # the layout is derived here
    d, i, stats = search_ivf_sharded(sidx, Q)  # stats: (S, 3) per shard

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
from mpi_knn_tpu_torch.ivf.sharded import (
    ShardedIVFIndex,
    build_sharded_ivf_index,
    search_ivf_sharded,
    shard_ivf_index,
    unshard_ivf_index,
)

__all__ = [
    "IVFIndex",
    "KMeansResult",
    "ShardedIVFIndex",
    "build_ivf_index",
    "build_sharded_ivf_index",
    "ivf_query_tile",
    "kmeans",
    "lloyd",
    "load_ivf_index",
    "save_ivf_index",
    "search_ivf",
    "search_ivf_sharded",
    "shard_ivf_index",
    "tune_nprobe",
    "unshard_ivf_index",
]
