"""Query serving on one device: a resident corpus index, bucketed
per-(bucket, config) state built once, and bounded dispatch-ahead::

    from mpi_knn_tpu_torch.serve import build_index, query_knn, ServeSession

    index = build_index(corpus, KNNConfig(k=10, backend="pallas"))
    res = query_knn(Q, index)              # one batch, results on the host

    session = ServeSession(index)          # streaming, dispatch-ahead
    for batch_result in session.stream(batches):
        use(batch_result.ids)

The CLI is ``python -m mpi_knn_tpu_torch query`` (``serve/cli.py``).
"""

from mpi_knn_tpu_torch.serve.engine import (
    BatchResult,
    ServeSession,
    bucket_rows,
    get_executable,
    query_knn,
    ring_query_shapes,
)
from mpi_knn_tpu_torch.serve.index import CorpusIndex, build_index

__all__ = [
    "BatchResult",
    "CorpusIndex",
    "ServeSession",
    "bucket_rows",
    "build_index",
    "get_executable",
    "query_knn",
    "ring_query_shapes",
]
