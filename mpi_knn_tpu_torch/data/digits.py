"""Real handwritten digits, offline: the UCI set bundled with scikit-learn
(1797 × 64, classes 0-9), the genuine-data stand-in for MNIST, which is
not in the repository. Needs scikit-learn."""

from __future__ import annotations

import numpy as np


def load_digits() -> tuple[np.ndarray, np.ndarray]:
    """Returns (X float32 (1797, 64), labels int32 0-9)."""
    try:
        from sklearn.datasets import load_digits as _sk_load
    except ImportError as e:
        raise RuntimeError(
            "the 'digits' data source needs scikit-learn (not installed)"
        ) from e
    d = _sk_load()
    return d.data.astype(np.float32), d.target.astype(np.int32)
