"""Corpus reduction to principal components on the device: the
``mnist_train_svd.mat`` configuration (the C reference names that file but
ships no code for it; the JAX package's ``data/svd.py`` computes it).

As in the JAX package, the d × d Gram matrix of the centered corpus is
formed by a matrix product and eigendecomposed, O(m·d² + d³), instead of a
full (m × d) SVD. Every product is ``torch.matmul`` in full f32 (TF32
off, the port's exact rule: a card with TF32 on raises). The Gram is
summed over row chunks in f64 and ``torch.linalg.eigh`` runs in f64 on the
d × d matrix: the f32 rounding stays inside each 4096-row chunk, so the
small kept eigenvalues keep their relative accuracy where the spectrum
spreads over orders of magnitude.
"""

from __future__ import annotations

import torch

from mpi_knn_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from mpi_knn_tpu_torch.ops.distance import _check_full_precision

_CHUNK_ROWS = 4096


def gram_eigh(x: torch.Tensor):
    """(eigenvalues descending (d,) f64, eigenvectors (d, d) f64 as
    columns, mean (d,) f32) of an (m, d) f32 tensor's centered Gram."""
    _check_full_precision(x)
    mu = torch.mean(x, dim=0)
    gram = torch.zeros((x.shape[1], x.shape[1]), dtype=torch.float64,
                       device=x.device)
    for lo in range(0, x.shape[0], _CHUNK_ROWS):
        xc = x[lo: lo + _CHUNK_ROWS] - mu
        gram += torch.matmul(xc.T, xc).double()
    vals, vecs = torch.linalg.eigh(gram)  # ascending
    return vals.flip(0), vecs.flip(1), mu


def svd_reduce(x, out_dim: int, device=DEFAULT_DEVICE):
    """Project (m, d) points onto their top ``out_dim`` principal
    components. Returns (reduced (m, out_dim) f32, components (d, out_dim)
    f32, mean (d,) f32), tensors on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    if not 1 <= out_dim <= x.shape[1]:
        raise ValueError(f"out_dim must be in [1, {x.shape[1]}], got {out_dim}")
    _, vecs, mu = gram_eigh(x)
    comps = vecs[:, :out_dim].float().contiguous()
    return torch.matmul(x - mu, comps), comps, mu
