"""PyTorch/CUDA port of mpi_knn_tpu for one NVIDIA H100.

Plain tensor code is PyTorch; the fused distance + top-k kernels are
hand-written CUDA for sm_90a (csrc/), built at first use. Entry points run
on "cuda" unless the caller passes device="cpu".

The names below load on first use: importing a torch-free part of the
package (``obs``, ``resilience``, the doctor's supervisor) imports no
torch.
"""

_EXPORTS = {
    "all_knn": "mpi_knn_tpu_torch.api",
    "build_index": "mpi_knn_tpu_torch.api",
    "knn_classify": "mpi_knn_tpu_torch.api",
    "query_knn": "mpi_knn_tpu_torch.api",
    "resolve_backend": "mpi_knn_tpu_torch.api",
    "KNNConfig": "mpi_knn_tpu_torch.config",
    "KNNClassifier": "mpi_knn_tpu_torch.models.classifier",
    "LooReport": "mpi_knn_tpu_torch.models.classifier",
    "ServeSession": "mpi_knn_tpu_torch.serve",
    "INVALID_ID": "mpi_knn_tpu_torch.types",
    "ClassifyResult": "mpi_knn_tpu_torch.types",
    "KNNResult": "mpi_knn_tpu_torch.types",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
