"""The grid form's (K5's) link across hosts: a host proxy at each process
boundary whose neighbour runs on another machine.

K5 (``ops/fused_rotation.fused_rotation_grid``) runs the whole rotation in
one launch a card. Across processes its last rank stores its outgoing
block, ids and norms into the next process's first landing slot and adds
to that process's flag words (``csrc/fused_ring_dma.cu``, enum Word):
``G_FROM_PRED`` once a call (the barrier), ``G_LANDED`` ``COPY_CTAS``
times a hop; going back, the first rank adds ``G_FROM_SUCC`` once a call
and ``G_FREE`` once a round it releases a slot. Between the processes of
one host those stores go through CUDA IPC mappings (``parallel/ipc.py``).
A link to another host (``"proxy"``) points them at buffers of this
process's own instead, and this module carries each hop while the kernel
runs:

- the last rank's block, ids and norms go into an ``outbox`` of two slots
  on its card, and its adds to the successor's words into a ``mirror``
  row there (``G_FROM_PRED``, ``G_LANDED``);
- the first rank's adds to the predecessor's words go into a mirror row
  on its card (``G_FROM_SUCC``, ``G_FREE``), and its landing slots are the
  caller's, in device memory this process allocated.

The proxy, one thread a process, is started before the launch and joined
after the kernel's stream has synchronized. Per call it forwards the
barrier both ways (a call count each, which must be the same on both
sides of the link); per hop the sending side waits for the outbox slot's
``COPY_CTAS`` landed adds in the mirror, copies the slot to a pinned host
buffer and sends it over the pod's gloo group, and the receiving side
copies what arrived into the first rank's landing slot once its own
first rank has released that slot (its mirror's ``G_FREE``), then raises
the first rank's ``G_LANDED`` by ``COPY_CTAS``. The last rank's
``G_FREE`` (the outbox slot is free) is raised once the proxy has copied
that slot out. Flag words only count up, so the proxy writes absolute
counts.

Hazards, and what answers each:

- no SM-based collective while K5 runs (its cooperative grid holds every
  SM's register file): bytes move by the copy engines, on a side stream
  of each card (non-blocking), and by gloo over TCP; nothing here launches
  a kernel, on four cards (backend ``nccl+gloo``) too;
- no atomics on mapped host memory: the mirror rows are device memory,
  read by a copy on the side stream;
- ordering at the receiver (K5 reads a slot with ``__ldcg`` after an
  acquire of ``G_LANDED``): the data's copy is synchronized before the
  flag's copy is issued.

Every wait is bounded by the call's timeout (``TIMEOUT_S`` of
``ops/fused_rotation.py``). A timeout or a gloo error sets each card's
error word (the kernel leaves at its next round, or when its own bounded
wait ends) and is raised by the caller once the card has synchronized:
every process of the pod fails. On the CPU the same proxy runs beside
``fused_rotation_grid_proxy_reference``, the plain stand-in for the
kernel's side of this protocol, on CPU tensors.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import threading
import time

import torch
import torch.distributed as dist

from mpi_knn_tpu_torch.ops.fused_rotation import (
    COPY_CTAS,
    ERR_PROXY,
    G_FREE,
    G_FROM_PRED,
    G_FROM_SUCC,
    G_LANDED,
    NWORDS,
    W_ERR,
)

_TAG_BARRIER_FWD, _TAG_BARRIER_BACK, _TAG_HOP = 900, 901, 1000
_POLL_S = 5e-5

# this process's proxy traffic: hops and bytes each way (the parts of what
# was sent), and host seconds by part: waiting for the kernel's words,
# copy out (device to pinned host), gloo (send and receive), copy in (host
# to the landing slot) and the flag's write
PROXY = {"calls": 0, "hops_sent": 0, "hops_received": 0, "bytes_sent": 0,
         "bytes_received": 0, "block_bytes": 0, "ids_bytes": 0,
         "norms_bytes": 0, "wait_s": 0.0, "copy_out_s": 0.0, "gloo_s": 0.0,
         "copy_in_s": 0.0, "flag_s": 0.0}


def reset_proxy_stats() -> None:
    for name, v in PROXY.items():
        PROXY[name] = type(v)(0)


def link_kind(hosts, me: int, other: int) -> str:
    """The link rule, stated once: ``"ipc"`` where the neighbouring
    process runs on this process's host, ``"proxy"`` where it does not
    (``Pod.hosts``, gathered at start-up)."""
    return "ipc" if hosts[other] == hosts[me] else "proxy"


class ProxyFailed(RuntimeError):
    """A wait of the proxy timed out, or a gloo operation failed."""


class _Card:
    """One card's side of the proxy: a non-blocking side stream and pinned
    host words (or, on the CPU, plain copies)."""

    def __init__(self, dev: torch.device):
        cuda = dev.type == "cuda"
        self.stream = torch.cuda.Stream(dev) if cuda else None
        self.words = torch.zeros(NWORDS, dtype=torch.int32, pin_memory=cuda)
        self.word = torch.zeros(1, dtype=torch.int32, pin_memory=cuda)

    def ctx(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def sync(self):
        if self.stream is not None:
            self.stream.synchronize()

    def read(self, row: torch.Tensor, word: int) -> int:
        with self.ctx():
            self.words.copy_(row, non_blocking=True)
        self.sync()
        return int(self.words[word])

    def write(self, row: torch.Tensor, word: int, value: int) -> None:
        self.word[0] = value
        with self.ctx():
            row[word:word + 1].copy_(self.word, non_blocking=True)
        self.sync()


class HostProxy:
    """The proxy of one K5 call (see the module's docstring).

    ``nxt`` / ``prv``: the processes past the last rank and before the
    first, each None where that link is not a proxy link. ``outbox``: the
    last rank's two slots (block, ids, norms), ``landing``: the first
    rank's (the caller's). ``mirror``: (next side, previous side) rows.
    ``last_row`` / ``first_row``: the flag rows the proxy raises (the
    mirror rows lie on their cards). ``err_words``: the row of each card
    that holds its error word. ``G`` is the call count, ``P``
    the ring's size."""

    def __init__(self, *, nxt, prv, outbox, landing, mirror, last_row,
                 first_row, err_words, G: int, P: int, timeout_s: float,
                 where: str):
        self.nxt, self.prv = nxt, prv
        self.outbox, self.landing = outbox, landing
        self.mirror = mirror
        self.last_row, self.first_row = last_row, first_row
        self.err_words = err_words
        self.G, self.P, self.timeout_s = G, P, timeout_s
        self.where = where
        self.error = None
        self.stop = threading.Event()
        self.cards = {d: _Card(d) for d in dict.fromkeys(
            t.device for t in (last_row, first_row, *err_words))}
        # each copy runs on the side stream of the card its device tensor
        # lies on: a copy of another card's tensor would run on that card's
        # default stream, behind its kernel
        if outbox is not None and any(t.device != last_row.device for t in outbox):
            raise ValueError("the outbox must lie on the last rank's card")
        if landing is not None and any(t.device != first_row.device for t in landing):
            raise ValueError("the landing slots must lie on the first rank's card")
        parts = outbox if outbox is not None else landing
        self.layout = [(tuple(t.shape[1:]), t.dtype) for t in parts]
        nbytes = [math.prod(s) * d.itemsize for s, d in self.layout]
        self.part_bytes = nbytes
        pin = any(d.type == "cuda" for d in self.cards)
        self.send_buf = (torch.empty(sum(nbytes), dtype=torch.uint8, pin_memory=pin)
                         if nxt is not None else None)
        self.recv_buf = (torch.empty(sum(nbytes), dtype=torch.uint8, pin_memory=pin)
                         if prv is not None else None)
        self.thread = threading.Thread(target=self._run, name="k5-host-proxy",
                                       daemon=True)

    # -- the thread ---------------------------------------------------------

    def start(self) -> "HostProxy":
        self.thread.start()
        return self

    def finish(self) -> None:
        """Join the thread (the caller synchronized the cards first) and
        raise what it failed with."""
        self.thread.join()
        if self.error is not None:
            raise ProxyFailed(f"the host proxy of {self.where} failed: "
                              f"{self.error}") from self.error

    def abort(self) -> None:
        """Stop the thread at its next poll (a launch that failed)."""
        self.stop.set()
        if self.thread.is_alive():
            self.thread.join()

    def _run(self):
        try:
            self._call()
        except BaseException as e:  # noqa: BLE001 -- raised by finish()
            self.error = e
            for row in self.err_words:
                try:
                    self.cards[row.device].write(row, W_ERR, ERR_PROXY)
                except Exception:  # the card's own wait ends the kernel
                    pass

    def _wait_word(self, row, word: int, target: int, what: str) -> None:
        t0 = time.perf_counter()
        end = t0 + self.timeout_s
        card = self.cards[row.device]
        while card.read(row, word) < target:
            if self.stop.is_set():
                raise ProxyFailed(f"stopped while waiting for {what}")
            if time.perf_counter() > end:
                raise ProxyFailed(f"timed out after {self.timeout_s} s waiting "
                                  f"for {what} (word {word} >= {target})")
            time.sleep(_POLL_S)
        PROXY["wait_s"] += time.perf_counter() - t0

    def _wait_work(self, work, what: str) -> None:
        try:
            work.wait(datetime.timedelta(seconds=self.timeout_s))
        except Exception as e:
            raise ProxyFailed(f"gloo {what} failed within {self.timeout_s} s: "
                              f"{type(e).__name__}: {e}") from e

    def _call(self):
        G, P = self.G, self.P
        hops = P - 1
        frees = max(P - 2, 0)
        landed0 = (G - 1) * hops * COPY_CTAS
        free0 = (G - 1) * frees
        m_next, m_prev = self.mirror
        last_card = self.cards[self.last_row.device] if self.nxt is not None else None
        first_card = self.cards[self.first_row.device] if self.prv is not None else None
        PROXY["calls"] += 1

        # the call's barrier, both ways: the local rank entered the call,
        # then its neighbour's count arrives
        from_next = torch.zeros(1, dtype=torch.int64)
        from_prev = torch.zeros(1, dtype=torch.int64)
        rw_next = rw_prev = None
        if self.nxt is not None:
            rw_next = dist.irecv(from_next, self.nxt, tag=_TAG_BARRIER_BACK)
        if self.prv is not None:
            rw_prev = dist.irecv(from_prev, self.prv, tag=_TAG_BARRIER_FWD)
        count = torch.tensor([G], dtype=torch.int64)
        sends = []
        if self.nxt is not None:
            self._wait_word(m_next, G_FROM_PRED, G, "the last rank's barrier add")
            sends.append(dist.isend(count, self.nxt, tag=_TAG_BARRIER_FWD))
        if self.prv is not None:
            self._wait_word(m_prev, G_FROM_SUCC, G, "the first rank's barrier add")
            sends.append(dist.isend(count, self.prv, tag=_TAG_BARRIER_BACK))
        for w in sends:
            self._wait_work(w, "barrier send")
        if self.nxt is not None:
            self._wait_work(rw_next, f"barrier from process {self.nxt}")
            _same_call(int(from_next[0]), G, self.nxt)
            last_card.write(self.last_row, G_FROM_SUCC, G)
            if frees >= 1:  # the outbox's slot 0 is free for round 1
                last_card.write(self.last_row, G_FREE, free0 + 1)
        if self.prv is not None:
            self._wait_work(rw_prev, f"barrier from process {self.prv}")
            _same_call(int(from_prev[0]), G, self.prv)
            first_card.write(self.first_row, G_FROM_PRED, G)

        for h in range(hops):
            nxt_slot = (h + 1) % 2
            tag = _TAG_HOP + h
            rw = None
            if self.prv is not None:
                rw = dist.irecv(self.recv_buf, self.prv, tag=tag)
            if self.nxt is not None:
                self._wait_word(m_next, G_LANDED, landed0 + (h + 1) * COPY_CTAS,
                                f"hop {h}'s outbox stores")
                t0 = time.perf_counter()
                with last_card.ctx():
                    for view, src in zip(self._views(self.send_buf),
                                         (t[nxt_slot] for t in self.outbox)):
                        view.copy_(src, non_blocking=True)
                last_card.sync()
                PROXY["copy_out_s"] += time.perf_counter() - t0
                if h + 2 <= frees:  # the slot hop h + 2 rewrites is copied out
                    last_card.write(self.last_row, G_FREE, free0 + h + 2)
                t0 = time.perf_counter()
                sw = dist.isend(self.send_buf, self.nxt, tag=tag)
                self._wait_work(sw, f"hop {h} to process {self.nxt}")
                PROXY["gloo_s"] += time.perf_counter() - t0
                PROXY["hops_sent"] += 1
                PROXY["bytes_sent"] += self.send_buf.numel()
                for name, n in zip(("block_bytes", "ids_bytes", "norms_bytes"),
                                   self.part_bytes):
                    PROXY[name] += n
            if self.prv is not None:
                t0 = time.perf_counter()
                self._wait_work(rw, f"hop {h} from process {self.prv}")
                PROXY["gloo_s"] += time.perf_counter() - t0
                PROXY["hops_received"] += 1
                PROXY["bytes_received"] += self.recv_buf.numel()
                if h >= 1:  # the first rank has released the slot
                    self._wait_word(m_prev, G_FREE, free0 + h,
                                    f"the first rank's release of slot {nxt_slot}")
                t0 = time.perf_counter()
                with first_card.ctx():
                    for view, dst in zip(self._views(self.recv_buf),
                                         (t[nxt_slot] for t in self.landing)):
                        dst.copy_(view, non_blocking=True)
                first_card.sync()  # the data before the flag
                t1 = time.perf_counter()
                PROXY["copy_in_s"] += t1 - t0
                first_card.write(self.first_row, G_LANDED,
                                 landed0 + (h + 1) * COPY_CTAS)
                PROXY["flag_s"] += time.perf_counter() - t1

    def _views(self, buf):
        out, off = [], 0
        for (shape, dtype), n in zip(self.layout, self.part_bytes):
            out.append(buf[off:off + n].view(dtype).view(shape))
            off += n
        return out


def _same_call(got: int, want: int, process: int) -> None:
    if got != want:
        raise ProxyFailed(f"process {process} is at call {got} of the grid "
                          f"form where this process is at call {want}")
