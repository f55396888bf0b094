"""Build and load the repository's native C++ data readers
(``native/*.cpp``: the MAT v5 reader and the vecs reader) through ctypes.

The sources and the Makefile are the top-level ``native/`` (part of
neither package). A missing library is built once with that Makefile into
the port's own build directory, ``mpi_knn_tpu_torch/_build/native/``: each
process builds into a directory of its own and renames the result into
place, so a process never loads a library another is still writing. A
failed build is remembered per library, and the caller then uses its
numpy reader.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build" / "native"

_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def _build(so_name: str) -> bool:
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    try:
        # only the one library: another's rule (matio needs zlib's
        # headers) must not block this one
        subprocess.run(["make", "-C", str(NATIVE_DIR), f"BUILD={tmp}",
                        str(tmp / so_name)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp / so_name, BUILD_DIR / so_name)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_native(so_name: str,
                bind: Callable[[ctypes.CDLL], None]) -> Optional[ctypes.CDLL]:
    """``<so_name>`` from the port's build directory, bound by ``bind``,
    built first if it is absent; None when it cannot be built or loaded."""
    if so_name in _cache:
        return _cache[so_name]
    lib_path = BUILD_DIR / so_name
    if not lib_path.exists() and not _build(so_name):
        _cache[so_name] = None
        return None
    lib = ctypes.CDLL(str(lib_path))
    bind(lib)
    _cache[so_name] = lib
    return lib
