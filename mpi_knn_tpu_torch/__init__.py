"""PyTorch/CUDA port of mpi_knn_tpu for one NVIDIA H100.

Plain tensor code is PyTorch; the fused distance + top-k kernels are
hand-written CUDA for sm_90a (csrc/), built at first use. Entry points run
on "cuda" unless the caller passes device="cpu".
"""

from mpi_knn_tpu_torch.api import (
    all_knn,
    build_index,
    knn_classify,
    query_knn,
    resolve_backend,
)
from mpi_knn_tpu_torch.config import KNNConfig
from mpi_knn_tpu_torch.models.classifier import KNNClassifier, LooReport
from mpi_knn_tpu_torch.serve import ServeSession
from mpi_knn_tpu_torch.types import INVALID_ID, ClassifyResult, KNNResult

__all__ = [
    "INVALID_ID",
    "ClassifyResult",
    "KNNClassifier",
    "KNNConfig",
    "KNNResult",
    "LooReport",
    "ServeSession",
    "all_knn",
    "build_index",
    "knn_classify",
    "query_knn",
    "resolve_backend",
]
