"""Zero-copy reads of ``.npz`` index artifacts (the JAX package's
``utils/npz_mmap.py``).

``np.load`` on an ``.npz`` decompress-copies every member into fresh host
memory before the first byte reaches the device: for a multi-GB bucket
store that is a full extra corpus copy and a fully serialized read.
``np.savez`` (the index writer, ``ivf/index.py``) stores members
UNCOMPRESSED, so each member's ``.npy`` payload sits contiguous inside
the zip: this module locates it (zip local-file header + npy header
parsing) and hands back an ``np.memmap`` view straight into the file.
Nothing is read until someone touches the pages, which is the copy to the
device during index load, so the disk read and the host-to-device copy
are one pass. After the copy the device owns its own buffer and the
mapping is dropped; the file can be replaced at any time (the index
save's atomic rename keeps even that safe).

Strictness: a member this module cannot map (compressed by
``savez_compressed``, object dtype, malformed headers) raises
``ValueError`` rather than quietly falling back to a hidden full read;
the CALLER (``load_ivf_index``) owns the loud fallback to ``np.load``.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

# zip local-file-header layout (PKZIP appnote 4.3.7): fixed 30 bytes,
# then filename and extra field — the extra field here may differ from
# the central directory's, so the data offset MUST come from this header
_LOCAL_HEADER_LEN = 30
_LOCAL_MAGIC = b"PK\x03\x04"


def mmap_npz(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """Read-only memmapped views of every ``*.npy`` member of an
    UNCOMPRESSED ``.npz`` archive, keyed like ``np.load``'s NpzFile.
    Zero-size members come back as ordinary empty arrays (an empty
    mapping is meaningless to mmap(2))."""
    path = os.fspath(path)
    arrays: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        with zipfile.ZipFile(f) as zf:
            members = zf.infolist()
        for info in members:
            if not info.filename.endswith(".npy"):
                continue
            key = info.filename[:-4]
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"member {info.filename!r} of {path!r} is compressed "
                    "(savez_compressed?): a compressed member has no "
                    "byte-addressable payload to map"
                )
            f.seek(info.header_offset)
            hdr = f.read(_LOCAL_HEADER_LEN)
            if len(hdr) != _LOCAL_HEADER_LEN or hdr[:4] != _LOCAL_MAGIC:
                raise ValueError(
                    f"malformed zip local header for {info.filename!r} "
                    f"in {path!r}"
                )
            name_len = int.from_bytes(hdr[26:28], "little")
            extra_len = int.from_bytes(hdr[28:30], "little")
            f.seek(info.header_offset + _LOCAL_HEADER_LEN + name_len
                   + extra_len)
            shape, fortran, dtype = _read_npy_header(f, info.filename)
            if dtype.hasobject:
                raise ValueError(
                    f"member {info.filename!r} has object dtype — not a "
                    "mappable flat buffer"
                )
            if int(np.prod(shape)) == 0:
                arrays[key] = np.empty(shape, dtype=dtype)
                continue
            arrays[key] = np.memmap(
                path, mode="r", dtype=dtype, shape=shape,
                offset=f.tell(), order="F" if fortran else "C",
            )
    return arrays


def _read_npy_header(f, member: str):
    """(shape, fortran_order, dtype) of the npy payload starting at the
    file's current position; leaves the position at the first data byte."""
    try:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            return np.lib.format.read_array_header_1_0(f)
        if version == (2, 0):
            return np.lib.format.read_array_header_2_0(f)
        raise ValueError(f"unsupported npy format version {version}")
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 — normalize parser errors
        raise ValueError(
            f"malformed npy header in member {member!r}: {e}"
        ) from e
