"""Reader for TexMex ``*.fvecs`` / ``*.bvecs`` / ``*.ivecs`` files, the
on-disk form of the SIFT1M / GIST1M corpora: the repository's streaming
C++ reader (``native/vecsio.cpp``, through ctypes) with a numpy reader
beside it that succeeds and fails on the same inputs.

Per vector: a little-endian int32 dimension d, then d components (float32,
uint8 or int32). Every row has the same d. fvecs and bvecs load as float32
(bvecs widened), ivecs (ground-truth ids) as int32.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from mpi_knn_tpu_torch.data._native import load_native

_KINDS = {".fvecs": "f", ".bvecs": "b", ".ivecs": "i"}


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.tknn_vecs_read.restype = p
    lib.tknn_vecs_read.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int64]
    lib.tknn_vecs_error.restype = ctypes.c_char_p
    lib.tknn_vecs_error.argtypes = [p]
    lib.tknn_vecs_rows.restype = ctypes.c_int64
    lib.tknn_vecs_rows.argtypes = [p]
    lib.tknn_vecs_dim.restype = ctypes.c_int64
    lib.tknn_vecs_dim.argtypes = [p]
    lib.tknn_vecs_copy.restype = None
    lib.tknn_vecs_copy.argtypes = [p, p]
    lib.tknn_vecs_close.restype = None
    lib.tknn_vecs_close.argtypes = [p]


def load_native_lib():
    """The C++ vecs reader (built if needed), or None if unavailable."""
    return load_native("libtknn_vecsio.so", _bind)


def _kind_for(path: Path) -> str:
    try:
        return _KINDS[path.suffix]
    except KeyError:
        raise ValueError(f"{path}: not a .fvecs/.bvecs/.ivecs file") from None


def read_vecs_native(path, limit: Optional[int] = None) -> Optional[np.ndarray]:
    """The native read, or None if the library is unavailable. Raises
    ValueError on a malformed file (a truncated row, a changing d)."""
    lib = load_native_lib()
    if lib is None:
        return None
    path = Path(path)
    kind = _kind_for(path)
    h = lib.tknn_vecs_read(str(path).encode(), kind.encode(),
                           -1 if limit is None else limit)
    try:
        err = lib.tknn_vecs_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        rows, dim = lib.tknn_vecs_rows(h), lib.tknn_vecs_dim(h)
        out = np.empty((rows, dim), np.int32 if kind == "i" else np.float32)
        if rows:
            lib.tknn_vecs_copy(h, out.ctypes.data_as(ctypes.c_void_p))
        return out
    finally:
        lib.tknn_vecs_close(h)


def read_vecs_numpy(path, limit: Optional[int] = None) -> np.ndarray:
    """The numpy read. Like the native reader it validates only the first
    ``limit`` rows: a clean end at a row boundary is fine, a row cut short
    inside the requested range raises."""
    path = Path(path)
    kind = _kind_for(path)
    out_dtype = np.int32 if kind == "i" else np.float32
    with open(path, "rb") as f:
        head = f.read(4)
    if len(head) == 0 or limit == 0:
        return np.empty((0, 0), out_dtype)
    if len(head) < 4:
        raise ValueError(f"{path}: truncated dimension field at row 0")
    d = int(np.frombuffer(head, np.int32)[0])
    if d <= 0 or d > (1 << 24):
        raise ValueError(f"{path}: implausible dimension {d} at row 0")
    stride = 4 + d * (1 if kind == "b" else 4)
    # read only what the limit needs
    raw = np.fromfile(path, dtype=np.uint8,
                      count=-1 if limit is None else limit * stride)
    full_rows = raw.size // stride
    rows = full_rows if limit is None else min(limit, full_rows)
    if (limit is None or full_rows < limit) and raw.size % stride:
        raise ValueError(
            f"{path}: truncated row {full_rows} (size {raw.size} not a "
            f"multiple of row stride {stride})"
        )
    mat = raw[: rows * stride].reshape(rows, stride)
    dims = mat[:, :4].copy().view(np.int32).reshape(rows)
    if not (dims == d).all():
        bad = int(np.argmax(dims != d))
        raise ValueError(
            f"{path}: inconsistent dimension ({int(dims[bad])} vs {d}) at "
            f"row {bad}"
        )
    body = np.ascontiguousarray(mat[:, 4:])
    if kind == "b":
        return body.astype(np.float32)
    return body.view(out_dtype)


def write_vecs(path, X: np.ndarray):
    """Write rows as .fvecs (float32), .bvecs (uint8) or .ivecs (int32),
    by the file's suffix."""
    path = Path(path)
    dtype = {"f": np.float32, "b": np.uint8, "i": np.int32}[_kind_for(path)]
    X = np.ascontiguousarray(X, dtype=dtype)
    rows = np.empty((X.shape[0], 4 + X.shape[1] * X.itemsize), np.uint8)
    rows[:, :4] = np.full((X.shape[0], 1), X.shape[1], np.int32).view(np.uint8)
    rows[:, 4:] = X.view(np.uint8).reshape(X.shape[0], -1)
    rows.tofile(path)


def read_vecs(path, limit: Optional[int] = None) -> np.ndarray:
    """(n, d) rows of a .fvecs/.bvecs/.ivecs file: the native reader when
    it builds, numpy otherwise; the same output either way."""
    out = read_vecs_native(path, limit=limit)
    return read_vecs_numpy(path, limit=limit) if out is None else out
