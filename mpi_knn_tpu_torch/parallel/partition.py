"""Padding to tile multiples: sentinel rows (id −1) that the top-k masks
force to +inf distance."""

from __future__ import annotations

import numpy as np
import torch

from mpi_knn_tpu_torch.shapes import pad_to_multiple  # noqa: F401 (re-exported)
from mpi_knn_tpu_torch.types import INVALID_ID


def pad_rows_any(x, target_rows: int, fill=0.0, dtype=None, device=None):
    """Pad a (m, ...) array or tensor with ``fill`` rows up to target_rows
    and return a tensor on ``device`` (default: the tensor's own, or the
    CPU for numpy). A tensor is padded where it lies; a numpy array is
    padded on the host and moved once, after the cast, so its values are
    rounded exactly as the JAX package rounds them."""
    if isinstance(x, torch.Tensor):
        out = x.to(device=device or x.device, dtype=dtype or x.dtype)
    else:
        out = torch.from_numpy(np.ascontiguousarray(x)).to(dtype=dtype)
        out = out.to(device or "cpu")
    extra = target_rows - out.shape[0]
    if extra < 0:
        raise ValueError(f"target_rows {target_rows} < rows {out.shape[0]}")
    if extra:
        pad = torch.full(
            (extra,) + tuple(out.shape[1:]), fill, dtype=out.dtype,
            device=out.device,
        )
        out = torch.cat([out, pad])
    return out.contiguous()


def make_global_ids(m: int, padded: int) -> np.ndarray:
    """0-based global ids for m real rows, INVALID_ID for padding rows."""
    ids = np.full(padded, INVALID_ID, dtype=np.int32)
    ids[:m] = np.arange(m, dtype=np.int32)
    return ids
