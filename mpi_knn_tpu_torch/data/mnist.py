"""MNIST corpus loading: the C reference's ``mnist_train.mat`` layout
(``train_X``, 1-based ``train_labels``) through ``data/matfile.py``, raw
IDX files, else the deterministic synthetic surrogate. Labels are returned
0-based.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from mpi_knn_tpu_torch.data.matfile import load_corpus_mat
from mpi_knn_tpu_torch.data.synthetic import make_mnist_like

_SEARCH_PATHS = [
    "mnist_train.mat",
    "data/mnist_train.mat",
    "/root/data/mnist_train.mat",
]
_IMAGES = ("train-images-idx3-ubyte", "train-images-idx3-ubyte.gz")
_LABELS = ("train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz")


def _open(path: Path):
    return gzip.open(path, "rb") if path.suffix == ".gz" else open(path, "rb")


def _load_idx_images(path: Path) -> np.ndarray:
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows * cols).astype(np.float32)


def _load_idx_labels(path: Path) -> np.ndarray:
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)


def _first(directory: Path, names) -> Optional[Path]:
    return next((directory / n for n in names if (directory / n).exists()),
                None)


def load_mnist(path: Optional[str] = None, synthetic_ok: bool = True,
               m: int = 60000) -> Tuple[np.ndarray, np.ndarray, str]:
    """Returns (X (m, 784) float32, labels (m,) int32 0-based, source),
    source in {"mat", "idx", "synthetic"}. ``path`` (or ``$TKNN_MNIST``)
    names a ``.mat`` file or a directory holding the IDX files; ``m`` cuts
    the rows."""
    candidates = [path, os.environ.get("TKNN_MNIST"), *_SEARCH_PATHS]
    for cand in filter(None, candidates):
        p = Path(cand)
        if p.suffix == ".mat" and p.exists():
            X, labels = load_corpus_mat(p, limit=m)
            if labels is None:
                raise ValueError(f"{p}: expected a train_labels variable")
            return X, labels, "mat"
        if p.is_dir():
            img, lab = _first(p, _IMAGES), _first(p, _LABELS)
            if img and lab:
                return _load_idx_images(img)[:m], _load_idx_labels(lab)[:m], "idx"
    if not synthetic_ok:
        raise FileNotFoundError(
            "MNIST not found (no .mat file or IDX directory); pass path= "
            "or set $TKNN_MNIST"
        )
    X, y = make_mnist_like(m=m)
    return X, y, "synthetic"
