"""Deterministic synthetic corpora (numpy, from a seed), identical to the
JAX package's generators of the same name."""

from __future__ import annotations

import numpy as np


def make_blobs(m: int, d: int, num_classes: int = 10, seed: int = 0,
               center_scale: float = 4.0, noise: float = 1.0,
               dtype=np.float32):
    """Gaussian class blobs: (X (m, d), labels (m,) 0-based int32)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((num_classes, d)) * center_scale
    y = rng.integers(0, num_classes, size=m).astype(np.int32)
    X = (centers[y] + rng.standard_normal((m, d)) * noise).astype(dtype)
    return X, y


def make_sift_like(m: int = 1_000_000, d: int = 128, seed: int = 0,
                   chunk: int = 100_000):
    """SIFT1M-shaped surrogate: non-negative integer-valued descriptor
    rows in [0, 255], generated chunk by chunk to bound host memory."""
    rng = np.random.default_rng(seed)
    centers = rng.random((256, d)) * 140.0
    out = np.empty((m, d), dtype=np.float32)
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        which = rng.integers(0, centers.shape[0], size=hi - lo)
        block = centers[which] + rng.standard_normal((hi - lo, d)) * 30.0
        out[lo:hi] = np.clip(np.rint(block), 0.0, 255.0).astype(np.float32)
    return out


def make_mnist_like(m: int = 60000, d: int = 784, seed: int = 0):
    """MNIST-shaped surrogate: 10 classes, integer pixel values in
    [0, 255], used where the real MNIST file is absent."""
    rng = np.random.default_rng(seed)
    centers = rng.random((10, d)) * 255.0
    y = rng.integers(0, 10, size=m).astype(np.int32)
    X = centers[y] + rng.standard_normal((m, d)) * 25.0
    return np.clip(np.rint(X), 0.0, 255.0).astype(np.float32), y
