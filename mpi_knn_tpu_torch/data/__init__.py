from mpi_knn_tpu_torch.data.matfile import read_mat, write_mat
from mpi_knn_tpu_torch.data.synthetic import make_blobs
from mpi_knn_tpu_torch.data.mnist import load_mnist
from mpi_knn_tpu_torch.data.svd import svd_reduce
from mpi_knn_tpu_torch.data.vecs import read_vecs

__all__ = [
    "read_mat",
    "write_mat",
    "make_blobs",
    "load_mnist",
    "svd_reduce",
    "read_vecs",
]
