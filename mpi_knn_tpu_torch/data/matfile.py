"""MAT v5 file I/O: the C reference's data layer (``train_X`` /
``train_labels`` read through MATLAB's libmat) without MATLAB.

Two readers with the same semantics, as in the JAX package:

- **native**: ``native/matio.cpp`` (the repository's C++ parser of the
  public MAT-File Level 5 format, zlib ``miCOMPRESSED`` included), built on
  demand by ``data/_native.py`` and bound through ctypes;
- **numpy**: a Python parser of the same format, used when the native
  library cannot be built (no compiler, or no zlib headers).

``reader_name()`` says which one ``read_mat`` uses, so a run can report it.
Plus a writer. Every variable is a 2-D numeric array, column-major on disk;
values come back as float64, as ``mxGetPr`` yields them.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from mpi_knn_tpu_torch.data._native import load_native

# MAT v5 data-type tags
_MI_INT8, _MI_UINT8, _MI_INT16, _MI_UINT16 = 1, 2, 3, 4
_MI_INT32, _MI_UINT32, _MI_SINGLE, _MI_DOUBLE = 5, 6, 7, 9
_MI_INT64, _MI_UINT64, _MI_MATRIX, _MI_COMPRESSED = 12, 13, 14, 15

_MI_DTYPES = {
    _MI_INT8: np.int8, _MI_UINT8: np.uint8, _MI_INT16: np.int16,
    _MI_UINT16: np.uint16, _MI_INT32: np.int32, _MI_UINT32: np.uint32,
    _MI_SINGLE: np.float32, _MI_DOUBLE: np.float64, _MI_INT64: np.int64,
    _MI_UINT64: np.uint64,
}

# numpy dtype -> (array class, data-type tag)
_CLASS_FOR_DTYPE = {
    np.dtype(np.float64): (6, _MI_DOUBLE),
    np.dtype(np.float32): (7, _MI_SINGLE),
    np.dtype(np.int8): (8, _MI_INT8),
    np.dtype(np.uint8): (9, _MI_UINT8),
    np.dtype(np.int16): (10, _MI_INT16),
    np.dtype(np.uint16): (11, _MI_UINT16),
    np.dtype(np.int32): (12, _MI_INT32),
    np.dtype(np.uint32): (13, _MI_UINT32),
    np.dtype(np.int64): (14, _MI_INT64),
    np.dtype(np.uint64): (15, _MI_UINT64),
}


# ---------------------------------------------------------------- writer


def _element(mi_type: int, payload: bytes) -> bytes:
    """A tagged element, padded to 8 bytes, except ``miCOMPRESSED``, which
    is written unpadded (readers advance by its exact byte count)."""
    pad = 0 if mi_type == _MI_COMPRESSED else (-len(payload)) % 8
    return struct.pack("<II", mi_type, len(payload)) + payload + b"\0" * pad


def write_mat(path, variables: Dict[str, np.ndarray], compress: bool = True):
    """Write 1-D/2-D numeric arrays as a MAT v5 file (column-major)."""
    with open(path, "wb") as f:
        text = b"MATLAB 5.0 MAT-file, written by mpi_knn_tpu_torch"
        f.write(text + b" " * (116 - len(text)) + b"\0" * 8)
        f.write(struct.pack("<HH", 0x0100, 0x4D49))  # version, 'IM'
        for name, arr in variables.items():
            arr = np.asarray(arr)
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.ndim != 2:
                raise ValueError(f"{name}: only 1-D/2-D arrays supported")
            if arr.dtype not in _CLASS_FOR_DTYPE:
                raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
            cls, mi_type = _CLASS_FOR_DTYPE[arr.dtype]
            head = (_element(_MI_UINT32, struct.pack("<II", cls, 0))
                    + _element(_MI_INT32, struct.pack("<ii", *arr.shape))
                    + _element(_MI_INT8, name.encode()))
            body = arr.T.tobytes()  # column-major
            pad = b"\0" * ((-len(body)) % 8)
            data = struct.pack("<II", mi_type, len(body))
            inner_len = len(head) + 8 + len(body) + len(pad)
            if compress:
                matrix = (struct.pack("<II", _MI_MATRIX, inner_len) + head
                          + data + body + pad)
                f.write(_element(_MI_COMPRESSED, zlib.compress(matrix)))
            else:
                # written piece by piece: a full-size corpus is not copied
                # into one more buffer
                f.write(struct.pack("<II", _MI_MATRIX, inner_len))
                f.write(head + data)
                f.write(body)
                f.write(pad)


# ---------------------------------------------------------------- numpy reader


def _read_tag(buf: memoryview, off: int):
    """(mi_type, nbytes, data_off, next_off), the packed small-element form
    (payload of at most 4 bytes inside the tag) included."""
    (w0,) = struct.unpack_from("<I", buf, off)
    if w0 >> 16:
        return w0 & 0xFFFF, w0 >> 16, off + 4, off + 8
    (nbytes,) = struct.unpack_from("<I", buf, off + 4)
    data_off = off + 8
    if w0 == _MI_COMPRESSED:
        next_off = data_off + nbytes  # never padded
    else:
        next_off = data_off + ((nbytes + 7) & ~7)
        if next_off > len(buf):  # the last element may omit its padding
            next_off = data_off + nbytes
    return w0, nbytes, data_off, next_off


def _parse_matrix(buf: memoryview) -> Optional[tuple]:
    mi, nb, doff, off = _read_tag(buf, 0)
    if mi != _MI_UINT32 or nb < 8:
        return None
    (flags,) = struct.unpack_from("<I", buf, doff)
    if not 6 <= (flags & 0xFF) <= 15:
        return None  # not numeric (cell, struct, char, sparse)
    mi, nb, doff, off = _read_tag(buf, off)
    if mi != _MI_INT32:
        return None
    dims = np.frombuffer(buf, np.int32, count=nb // 4, offset=doff)
    mi, nb, doff, off = _read_tag(buf, off)
    if mi != _MI_INT8:
        return None
    name = bytes(buf[doff: doff + nb]).decode()
    mi, nb, doff, off = _read_tag(buf, off)
    if mi not in _MI_DTYPES:
        return None
    dt = np.dtype(_MI_DTYPES[mi])
    raw = np.frombuffer(buf, dt, count=nb // dt.itemsize, offset=doff)
    return name, raw.astype(np.float64).reshape(tuple(dims), order="F")


def read_mat_numpy(path) -> Dict[str, np.ndarray]:
    buf = memoryview(Path(path).read_bytes())
    if len(buf) < 128:
        raise ValueError(f"{path}: not a MAT v5 file (too short)")
    (endian,) = struct.unpack_from("<H", buf, 126)
    if endian != 0x4D49:
        raise ValueError(f"{path}: big-endian MAT files unsupported")
    out: Dict[str, np.ndarray] = {}
    off = 128
    while off + 8 <= len(buf):
        mi, nb, doff, off = _read_tag(buf, off)
        parsed = None
        if mi == _MI_COMPRESSED:
            inner = memoryview(zlib.decompress(buf[doff: doff + nb]))
            imi, inb, idoff, _ = _read_tag(inner, 0)
            if imi == _MI_MATRIX:
                parsed = _parse_matrix(inner[idoff: idoff + inb])
        elif mi == _MI_MATRIX:
            parsed = _parse_matrix(buf[doff: doff + nb])
        if parsed:
            out[parsed[0]] = parsed[1]
    return out


# ---------------------------------------------------------------- native reader


def _bind(lib: ctypes.CDLL) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tknn_mat_open.restype = p
    lib.tknn_mat_open.argtypes = [ctypes.c_char_p]
    lib.tknn_mat_error.restype = ctypes.c_char_p
    lib.tknn_mat_error.argtypes = [p]
    lib.tknn_mat_num_vars.restype = ctypes.c_int
    lib.tknn_mat_num_vars.argtypes = [p]
    lib.tknn_mat_var_name.restype = ctypes.c_char_p
    lib.tknn_mat_var_name.argtypes = [p, ctypes.c_int]
    lib.tknn_mat_var_shape.restype = ctypes.c_int
    lib.tknn_mat_var_shape.argtypes = [p, ctypes.c_char_p,
                                       ctypes.POINTER(i64), ctypes.c_int]
    lib.tknn_mat_read_f64.restype = i64
    lib.tknn_mat_read_f64.argtypes = [p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_double)]
    lib.tknn_mat_close.restype = None
    lib.tknn_mat_close.argtypes = [p]


def load_native_lib():
    """The C++ MAT reader (built if needed), or None if unavailable."""
    return load_native("libtknn_matio.so", _bind)


def read_mat_native(path) -> Dict[str, np.ndarray]:
    lib = load_native_lib()
    if lib is None:
        raise RuntimeError("native MAT reader unavailable (build failed?)")
    h = lib.tknn_mat_open(str(path).encode())
    try:
        err = lib.tknn_mat_error(h).decode()
        if err:
            raise ValueError(f"{path}: {err}")
        out: Dict[str, np.ndarray] = {}
        for i in range(lib.tknn_mat_num_vars(h)):
            name = lib.tknn_mat_var_name(h, i).decode()
            dims = (ctypes.c_int64 * 8)()
            nd = lib.tknn_mat_var_shape(h, name.encode(), dims, 8)
            if nd > 8:  # the C API fills at most 8 of the full rank
                raise ValueError(f"{path}: variable {name!r} has {nd} dims (max 8)")
            shape = tuple(dims[j] for j in range(nd))
            buf = np.empty(int(np.prod(shape)) if shape else 0, np.float64)
            n = lib.tknn_mat_read_f64(
                h, name.encode(),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            if n != buf.size:
                raise ValueError(f"{path}: size mismatch reading {name!r}")
            out[name] = buf.reshape(shape, order="F")
        return out
    finally:
        lib.tknn_mat_close(h)


def reader_name() -> str:
    """"native" or "numpy": the reader ``read_mat`` uses in this process."""
    return "native" if load_native_lib() is not None else "numpy"


def read_mat(path) -> Dict[str, np.ndarray]:
    """Every numeric 2-D variable of a MAT v5 file, as float64 arrays."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if reader_name() == "native":
        return read_mat_native(path)
    return read_mat_numpy(path)


def load_corpus_mat(path, limit: Optional[int] = None):
    """A corpus in the C reference's layout: ``train_X`` (m × d) and an
    optional ``train_labels`` (m × 1, 1-based as in MATLAB) mapped to
    0-based int32. Returns (X float32, labels int32 or None), cut to the
    first ``limit`` rows."""
    data = read_mat(path)
    if "train_X" not in data:
        raise ValueError(f"{path}: no train_X variable (found: {sorted(data)})")
    X = data["train_X"].astype(np.float32)
    labels = None
    if "train_labels" in data:
        labels = data["train_labels"].reshape(-1).astype(np.int32)
        if labels.min() >= 1:  # the reference's files are 1-based
            labels = labels - 1
    if limit is not None:
        X = X[:limit]
        labels = labels[:limit] if labels is not None else None
    return X, labels
