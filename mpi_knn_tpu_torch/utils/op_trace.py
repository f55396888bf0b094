"""A recorded eager run: the port's counterpart of the JAX package's
``utils/hlo_graph.py``, the graph the lint's rules (``analysis/rules.py``)
read.

The JAX package's rules read the XLA program a configuration compiles to.
Eager PyTorch compiles no program, so the port records the one that runs:
:func:`record` calls a function under a ``TorchDispatchMode`` and returns
a :class:`Trace` of

- **every aten op**, with the shapes, dtypes and devices of its inputs and
  outputs and the storages it read and wrote. A storage is numbered when
  the trace first sees it (a storage reused at the same address after a
  free gets a new number), so def-use goes by storage and a rule can slice
  backwards from an op (:meth:`Trace.backward_slice`), as ``hlo_graph``
  slices by tuple element. A view reads its base's storage, writes none
  and counts no new bytes.
- **the live bytes**: each storage an op makes adds its bytes, and a weak
  reference finalizer on every tensor that holds it takes them off when
  the last one goes. The peak stands in for the JAX package's liveness
  analysis (R7). Storages that existed before the call (the inputs, a
  resident index) are not counted.
- **the product FLOPs** (mm, bmm, addmm, baddbmm) per op, and in all as
  ``torch.utils.flop_counter.FlopCounterMode`` counts them when the call
  runs under it too (the CPU lint; on the card the per-op counts stand,
  which the CPU tests hold equal to it).
- **a kernel side-band**. The hand kernels are ctypes calls, which
  dispatch never sees; each wrapper reports one record through
  :func:`note_launch` at the line that counts its launch: its name, its
  operands, its precision form, its logical FLOPs (the product the closed
  form counts, not the ×3 passes of TF32×3), the bytes it moves and, for
  the kernels that move a ring's blocks themselves, their wire bytes. The
  record's outputs are the storages the kernel wrote, so a slice passes
  through a kernel as through an op.
- **a transport log**: the ring's driver transport, the sharded index's
  exchange and the process group append one event a copy or exchange
  (:func:`note_transfer`), and the ring one a merge, in the order issued.
  On the CPU the copies are synchronous and are logged all the same.

With no trace open, :func:`note_launch` and :func:`note_transfer` cost
one branch. Torch is imported by :func:`record` only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import weakref

from mpi_knn_tpu_torch.analysis.memory import alloc

_TRACE = None  # the open Trace, if any (one at a time, per process)

# the products FlopCounterMode counts, the only ones R8 counts
PRODUCT_OPS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    shape: tuple
    dtype: str
    device: str
    sid: int  # storage number (-1: an empty storage)
    nbytes: int  # the tensor's own bytes (numel · itemsize)


@dataclasses.dataclass
class OpRecord:
    """One aten op (``kind`` "op") or one kernel launch (``kind``
    "kernel", ``name`` the launch counter's)."""

    index: int
    name: str
    kind: str
    inputs: list
    outputs: list
    reads: tuple
    writes: tuple
    new_bytes: int = 0  # bytes of the storages this op made
    flops: int = 0
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def is_product(self) -> bool:
        return self.kind == "op" and self.base in PRODUCT_OPS

    @property
    def base(self) -> str:
        """"aten.mm" of "aten.mm.default"."""
        return self.name.rsplit(".", 1)[0] if self.name.count(".") > 1 else self.name


class Trace:
    """What :func:`record` saw (see the module docstring)."""

    def __init__(self, device_type: str | None = None):
        # the live bytes count the storages on this device type (None: all)
        self.device_type = device_type
        self.ops: list[OpRecord] = []
        self.transport: list[dict] = []
        # sid -> nbytes, key, made (by an op of the call, "op" its index),
        # external (not counted live: an input, or on another device)
        self.storages: dict[int, dict] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.peak_at = -1  # the op after which the peak was reached
        # the same, each storage rounded as the caching allocator counts it
        self.live_alloc = 0
        self.peak_alloc = 0
        # FlopCounterMode's totals by op, where the call ran under it
        self.flop_counts: dict[str, int] | None = None
        # on a card: the caching allocator's peak growth over the call
        self.allocator_growth: int | None = None
        self._keys: dict[tuple, int] = {}  # (device, ptr) -> sid
        self._refs: dict[int, int] = {}  # tracked tensors a storage
        self._tensors: dict[int, int] = {}  # id of a tracked tensor -> sid
        self._writer: dict[int, int] = {}  # sid -> last op that wrote it
        self._deps: list[tuple] = []  # per op: the ops it read from
        self.closed = False

    # ------------------------------------------------------------ storages

    def _key(self, t):
        st = t.untyped_storage()
        if st.nbytes() == 0:
            return None, 0
        return (str(t.device), st.data_ptr()), st.nbytes()

    def sid_of(self, t, *, external: bool = True) -> int:
        """The storage number of ``t``; a storage first seen here is an
        input of the call (``external``) and is not counted live."""
        key, nbytes = self._key(t)
        if key is None:
            return -1
        sid = self._keys.get(key)
        if sid is None:
            sid = len(self.storages)
            self._keys[key] = sid
            counted = (self.device_type is None
                       or t.device.type == self.device_type)
            self.storages[sid] = {"nbytes": nbytes, "op": -1,
                                  "external": external or not counted,
                                  "made": False, "key": key}
        self._track(t, sid)
        return sid

    def _track(self, t, sid: int) -> None:
        """Hold ``sid`` while ``t`` lives: when the last tensor the trace
        saw on a storage goes, the storage's address may be reused by a
        new one, which must get a new number."""
        if sid < 0 or self._tensors.get(id(t)) == sid:
            return
        self._tensors[id(t)] = sid
        self._refs[sid] = self._refs.get(sid, 0) + 1
        weakref.finalize(t, self._release, sid, id(t))

    def _release(self, sid: int, tid: int) -> None:
        if self._tensors.get(tid) == sid:
            del self._tensors[tid]
        n = self._refs.get(sid, 0) - 1
        if n > 0:
            self._refs[sid] = n
            return
        self._refs.pop(sid, None)
        st = self.storages[sid]
        if not self.closed and not st["external"]:
            self.live_bytes -= st["nbytes"]
            self.live_alloc -= alloc(st["nbytes"])
        if self._keys.get(st["key"]) == sid:
            del self._keys[st["key"]]

    def _info(self, t, sid: int) -> TensorInfo:
        return TensorInfo(tuple(t.shape), str(t.dtype).replace("torch.", ""),
                          str(t.device), sid, t.numel() * t.element_size())

    # ---------------------------------------------------------------- ops

    def add_op(self, name, in_ts, written, out_ts, flops: int = 0) -> OpRecord:
        inputs = [self._info(t, self.sid_of(t)) for t in in_ts]
        new_bytes, outputs, made = 0, [], set()
        for t in out_ts:
            key, nbytes = self._key(t)
            fresh = key is not None and key not in self._keys
            sid = self.sid_of(t, external=False) if key is not None else -1
            if fresh:
                st = self.storages[sid]
                st["op"], st["made"] = len(self.ops), True
                made.add(sid)
                if not st["external"]:
                    new_bytes += nbytes
            outputs.append(self._info(t, sid))
        # a view writes nothing: its storage's writer stays the op that
        # made or last wrote it
        writes = tuple(sorted(made | {self.sid_of(t) for t in written}))
        return self._append(OpRecord(
            len(self.ops), name, "op", inputs, outputs,
            tuple(sorted({i.sid for i in inputs if i.sid >= 0})), writes,
            new_bytes, flops), new_bytes)

    def add_kernel(self, name: str, info: dict) -> OpRecord:
        operands = [t for t in info.pop("operands", ()) if t is not None]
        outs = [t for t in info.pop("outputs", ()) if t is not None]
        inputs = [self._info(t, self.sid_of(t)) for t in operands]
        outputs = [self._info(t, self.sid_of(t)) for t in outs]
        return self._append(OpRecord(
            len(self.ops), name, "kernel", inputs, outputs,
            tuple(sorted({i.sid for i in inputs if i.sid >= 0})),
            tuple(sorted({o.sid for o in outputs if o.sid >= 0})),
            0, int(info.get("flops", 0)), info), 0)

    def _append(self, rec: OpRecord, new_bytes: int) -> OpRecord:
        self._deps.append(tuple(sorted({self._writer[s] for s in rec.reads
                                        if s in self._writer})))
        for s in rec.writes:
            self._writer[s] = rec.index
        self.ops.append(rec)
        self.live_bytes += new_bytes
        self.live_alloc += sum(alloc(self.storages[s]["nbytes"])
                               for s in rec.writes
                               if self.storages[s]["op"] == rec.index
                               and not self.storages[s]["external"])
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes, self.peak_at = self.live_bytes, rec.index
        self.peak_alloc = max(self.peak_alloc, self.live_alloc)
        return rec

    # ------------------------------------------------------------ queries

    def producers(self, index: int) -> tuple:
        """The ops that last wrote a storage op ``index`` read."""
        return self._deps[index]

    def backward_slice(self, index: int) -> set:
        """Every op op ``index`` depends on through the storages it read
        (itself excluded)."""
        seen, stack = set(), list(self._deps[index])
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            stack.extend(self._deps[i])
        return seen

    def kernels(self) -> list:
        return [o for o in self.ops if o.kind == "kernel"]

    def products(self) -> list:
        return [o for o in self.ops if o.is_product]

    def counted_flops(self) -> int:
        """The products' FLOPs (FlopCounterMode's, where it ran) plus the
        kernels' logical FLOPs."""
        ops = (sum(o.flops for o in self.products()) if self.flop_counts is None
               else sum(v for k, v in self.flop_counts.items()
                        if k in PRODUCT_OPS))
        return ops + sum(o.flops for o in self.kernels())

    def allocations(self) -> list:
        """(op, nbytes) of every storage the call made, on any device, in
        order."""
        return [(self.ops[s["op"]], s["nbytes"]) for s in self.storages.values()
                if s["made"]]

    def events(self, *kinds) -> list:
        return [e for e in self.transport if not kinds or e["kind"] in kinds]


def note_launch(counts: dict, name: str, info=None) -> None:
    """Count one launch of kernel ``name`` in ``counts`` and, with a trace
    open, record it: ``info()`` returns the record's fields (``operands``,
    ``outputs``: tensors; ``flops``, ``bytes``, ``precision``,
    ``wire_bytes``)."""
    counts[name] += 1
    if _TRACE is not None:
        _TRACE.add_kernel(name, dict(info()) if info is not None else {})


def note_transfer(kind: str, **event) -> None:
    """Log one transport event (``kind``: "send", "wait", "merge",
    "round", "exchange", "collective") with a trace open."""
    if _TRACE is not None:
        event["kind"] = kind
        event["at"] = len(_TRACE.ops)
        _TRACE.transport.append(event)


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _product_flops(base: str, args, out) -> int:
    """2·m·k·n of one product (the counts FlopCounterMode gives)."""
    if base == "aten.mm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if base == "aten.addmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if base == "aten.bmm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if base == "aten.baddbmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 0


def _mode_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Recorder(TorchDispatchMode):
        def __init__(self, trace: Trace):
            super().__init__()
            self.trace = trace

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            in_ts = [t for t in tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor)]
            written = []
            for arg, val in zip(func._schema.arguments, args):
                info = arg.alias_info
                if info is not None and info.is_write and isinstance(val, torch.Tensor):
                    written.append(val)
            for name, val in kwargs.items():
                if name == "out" and isinstance(val, torch.Tensor):
                    written.append(val)
            out_ts = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            name = str(func)  # "aten.mm.default"
            base = "aten." + func._schema.name.split("::")[-1]
            flops = (_product_flops(base, args, out) if base in PRODUCT_OPS
                     else 0)
            self.trace.add_op(name, in_ts, written, out_ts, flops)
            return out

    return _Recorder


@functools.cache
def _warm_mode() -> None:
    """Run one product under a mode, once a process: its first run imports
    code on the way and leaves frames in reference cycles, which would hold
    the caller's tensors alive in the first recorded call."""
    import torch

    with _mode_class()(Trace()):
        torch.mm(torch.zeros(2, 2), torch.zeros(2, 2))
    gc.collect()


def record(fn, device_type: str | None = None, flop_counter: bool = True):
    """Run ``fn()`` under the recorder: ``(fn's result, Trace)``. With
    ``device_type`` the live bytes count that device's storages only (a
    card's memory, not the host's staging buffers). ``flop_counter``: run
    ``FlopCounterMode`` beside the recorder (it costs a third of the
    recorded call's host time)."""
    global _TRACE
    from torch.utils.flop_counter import FlopCounterMode

    if _TRACE is not None:
        raise RuntimeError("op_trace.record does not nest")
    _warm_mode()
    trace = Trace(device_type)
    counter = (FlopCounterMode(display=False) if flop_counter
               else contextlib.nullcontext())
    # the cycle collector off: a tensor held in a reference cycle is freed
    # when the program drops the cycle's last outside reference or never
    # in the call, not whenever a collection happens to run
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    _TRACE = trace
    try:
        with _mode_class()(trace), counter:
            result = fn()
    finally:
        _TRACE = None
        trace.closed = True
        if was_enabled:
            gc.enable()
    if flop_counter:
        trace.flop_counts = {str(k): int(v) for k, v in
                             counter.get_flop_counts().get("Global", {}).items()}
    return result, trace
