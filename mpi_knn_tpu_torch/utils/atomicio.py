"""Atomic file publication: the one temp file + ``os.replace`` helper the
port's writers of shared artifacts go through (the JAX package's
``utils/atomicio.py``).

A bare ``open(path, "w")`` publishes a zero-length, then half-written,
file to every concurrent reader; ``os.replace`` of a fully written temp
file in the SAME directory publishes either the old content or the new,
never a torn state. A saved clustered index is read while another process
may rewrite it (``ivf/index.save_ivf_index``), so it is written here.

The temp file lives next to the target (``os.replace`` must not cross
filesystems) and carries pid and thread id in its name, so concurrent
writers to one path race benignly: the last full write wins.
"""

from __future__ import annotations

import os
import threading


def _tmp_path(path: str) -> str:
    d, base = os.path.split(os.path.abspath(path))
    return os.path.join(
        d or ".",
        f".{base}.{os.getpid()}.{threading.get_ident()}.tmp",
    )


def atomic_write_bytes(path: str | os.PathLike[str], data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: temp file in the target's
    directory, then ``os.replace``. Readers see the old file or the new
    one, never a truncated or half-written state."""
    path = os.fspath(path)
    tmp = _tmp_path(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(
    path: str | os.PathLike[str], text: str, encoding: str = "utf-8"
) -> None:
    """:func:`atomic_write_bytes` for text content."""
    atomic_write_bytes(path, text.encode(encoding))
