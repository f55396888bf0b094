"""CUDA IPC between the processes of one host: the grid form's (K5's)
transport across an "ipc" link.

K5 (``ops/fused_rotation.fused_rotation_grid``) runs the whole rotation
in one launch a card, so a block cannot wait for the process group at a
round boundary. Its cross-card protocol already stores into the
successor's landing slot through a raw pointer and signals through the
successor's flag words with system-scope atomics
(``csrc/fused_ring_dma.cu``). Across processes those pointers come from
here: each process exports its first rank's two landing slots and the
flag words of its first and last ranks, sends the handles to its ring
neighbours through the process group, and maps theirs once per transport
and layout.

Memory. What is exported is allocated by ``cudaMalloc`` in the kernel
library (:func:`alloc`), not by PyTorch's caching allocator: a handle
names a whole allocation, and one of the caching allocator's blocks may
share a segment with other tensors (or, under ``expandable_segments``,
not be exportable at all). The allocation is seen by PyTorch as a uint8
tensor through ``__cuda_array_interface__``, which borrows the memory and
never frees it. Each mapping is opened once per handle
(``cudaIpcOpenMemHandle`` maps the whole allocation and costs
milliseconds), into the card of the rank that writes through it, with
peer access enabled lazily where that is another card.

Teardown (``parallel/distributed.shutdown``): every process synchronizes
its cards and meets the others at a barrier, closes its mappings, meets
them again, and only then frees what it exported, so no process frees
memory another still maps.

Which transport K5 uses on each link across processes is decided once,
from the pod's hostnames (``Pod.hosts``), by the link rule stated in
``parallel/hostlink.link_kind``: CUDA IPC reaches only the cards of one
machine, so a link whose neighbouring process runs on this host is
``"ipc"`` (this module) and one whose neighbour runs on another host is
``"proxy"`` (``parallel/hostlink.py``: the kernel's stores and flag adds
go to buffers of the process's own, and a host proxy moves each hop over
gloo during the launch). A proxy link opens no mapping and exports
nothing.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_EXPORTS: dict = {}   # base pointer -> (card index, bytes): this process's
_MAPPINGS: dict = {}  # handle bytes -> (card index, mapped base pointer)
_RECORD = 8           # a record: the handle, then its int64 byte offset


def active() -> bool:
    """Whether this process exports or maps anything."""
    return bool(_EXPORTS or _MAPPINGS)


@functools.cache
def _lib():
    from mpi_knn_tpu_torch.ops.fused_rotation import _lib as kernel_lib

    lib = kernel_lib()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ring_ipc_alloc.argtypes = [i32, ctypes.c_longlong, ctypes.POINTER(ptr)]
    lib.ring_ipc_free.argtypes = [i32, ptr]
    lib.ring_ipc_handle.argtypes = [ptr, ctypes.c_char_p]
    lib.ring_ipc_open.argtypes = [i32, ctypes.c_char_p, ctypes.POINTER(ptr)]
    lib.ring_ipc_close.argtypes = [i32, ptr]
    for name in ("ring_ipc_alloc", "ring_ipc_free", "ring_ipc_handle",
                 "ring_ipc_open", "ring_ipc_close", "ring_ipc_handle_bytes"):
        getattr(lib, name).restype = i32
    return lib


def handle_bytes() -> int:
    return _lib().ring_ipc_handle_bytes()


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"CUDA IPC: {what} failed: cudaError {rc}")


class _Borrowed:
    """A device allocation as ``__cuda_array_interface__`` (version 2):
    PyTorch borrows it and never frees it."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2, "strides": None}


def alloc(card: torch.device, nbytes: int) -> torch.Tensor:
    """A (nbytes,) uint8 tensor on ``card`` over an allocation of its own
    that this process may export; it lives until :func:`free_exports`."""
    ptr = ctypes.c_void_p()
    _check(_lib().ring_ipc_alloc(card.index, nbytes, ctypes.byref(ptr)),
           f"cudaMalloc of {nbytes} bytes on {card}")
    _EXPORTS[ptr.value] = (card.index, nbytes)
    return torch.as_tensor(_Borrowed(ptr.value, nbytes), device=card)


def carve(buf: torch.Tensor, parts) -> list:
    """Tensors of ``parts`` ((shape, dtype) each) laid out in ``buf`` one
    after another, each at a 256-byte aligned offset; :func:`carved_bytes`
    gives the size."""
    out, off = [], 0
    for shape, dtype in parts:
        n = int(np.prod(shape)) * dtype.itemsize
        out.append(buf[off:off + n].view(dtype).view(shape))
        off += -(-n // 256) * 256
    return out


def carved_bytes(parts) -> int:
    return sum(-(-int(np.prod(s)) * d.itemsize // 256) * 256 for s, d in parts)


def record(t: torch.Tensor) -> bytes:
    """The handle of the exported allocation that holds ``t`` and ``t``'s
    byte offset in it."""
    p = t.data_ptr()
    for base, (_, nbytes) in _EXPORTS.items():
        if base <= p < base + nbytes:
            buf = ctypes.create_string_buffer(handle_bytes())
            _check(_lib().ring_ipc_handle(base, buf), "cudaIpcGetMemHandle")
            return buf.raw + int(p - base).to_bytes(_RECORD, "little", signed=True)
    raise ValueError("the tensor lies in no allocation this process exported")


def pack(tensors) -> torch.Tensor:
    """The records of ``tensors`` as one host uint8 tensor to send."""
    return torch.frombuffer(bytearray(b"".join(record(t) for t in tensors)),
                            dtype=torch.uint8)


def empty_records(n: int) -> torch.Tensor:
    """A host buffer for ``n`` received records."""
    return torch.zeros(n * (handle_bytes() + _RECORD), dtype=torch.uint8)


def open_records(buf: torch.Tensor, card: torch.device) -> list:
    """The device pointers the records in ``buf`` name, mapped into
    ``card`` (each handle opened once in this process)."""
    raw, size = bytes(buf.numpy()), handle_bytes() + _RECORD
    out = []
    for i in range(0, len(raw), size):
        h = raw[i:i + handle_bytes()]
        off = int.from_bytes(raw[i + handle_bytes():i + size], "little", signed=True)
        if h not in _MAPPINGS:
            ptr = ctypes.c_void_p()
            _check(_lib().ring_ipc_open(card.index, h, ctypes.byref(ptr)),
                   f"cudaIpcOpenMemHandle on {card}")
            _MAPPINGS[h] = (card.index, ptr.value)
        out.append(_MAPPINGS[h][1] + off)
    return out


def close_mappings() -> None:
    """Close every mapping of another process's memory."""
    lib = _lib() if _MAPPINGS else None
    for dev, ptr in _MAPPINGS.values():
        lib.ring_ipc_close(dev, ptr)
    _MAPPINGS.clear()


def free_exports() -> None:
    """Drop the transports that hold this process's exported memory, then
    free it (after every process closed its mappings)."""
    if not _EXPORTS:
        return
    from mpi_knn_tpu_torch.ops.fused_rotation import drop_process_transports

    drop_process_transports()
    lib = _lib()
    for ptr, (dev, _) in _EXPORTS.items():
        lib.ring_ipc_free(dev, ptr)
    _EXPORTS.clear()
