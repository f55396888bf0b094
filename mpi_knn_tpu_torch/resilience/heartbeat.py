"""The heartbeat protocol between a supervised worker and its supervisor
(the JAX package's ``resilience/heartbeat.py``).

Why beats and not wall-clock: a whole-process watchdog cannot tell "the
card is wedged" from "the first nvcc build is slow today", so it has to
be generous, and when it finally fires every result is gone. A worker
that writes monotonic progress lets the supervisor kill on beat
starvation (no progress for T seconds) instead: a wedged launch stops the
beats at once, while a slow but live build keeps them flowing (the port's
``ops/_build.py`` beats between polls of nvcc). Wall-clock stays as the
outer bound, not the diagnostic.

Protocol: the worker overwrites one small JSON file (atomic temp +
rename) with ``{"seq": n, "label": ..., "pid": ...}``, ``seq`` strictly
increasing. The supervisor polls the file and tracks, on its own clock,
when it last observed a new ``seq`` (two processes' monotonic clocks are
not comparable, so the child never writes a deadline: it writes
progress, and the supervisor judges it). A missing or torn file reads as
"no beat yet": the file is the signal, never a crash source.

Workers find the beat file through the ``TKNN_HEARTBEAT_FILE`` env var
the supervisor sets; :func:`maybe_beat` is a no-op outside supervision,
so instrumented code (the doctor probe, the compactor, the serving
session, nvcc builds) needs no mode flag.

No torch import in this module.
"""

from __future__ import annotations

import json
import os

from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

HEARTBEAT_ENV = "TKNN_HEARTBEAT_FILE"


class HeartbeatWriter:
    """Worker side: atomically overwrite the beat file with an increasing
    sequence number. One writer per process; ``beat`` is cheap enough to
    call per rep / per batch."""

    def __init__(self, path: str):
        self.path = path
        self.seq = 0

    def beat(self, label: str = "") -> int:
        self.seq += 1
        doc = {"seq": self.seq, "label": label, "pid": os.getpid()}
        # atomic temp + replace (utils.atomicio): the supervisor polls
        # this file mid-overwrite, and must read the previous beat or
        # this one, never a torn line
        atomic_write_text(self.path, json.dumps(doc))
        return self.seq


_writer: HeartbeatWriter | None = None


def maybe_beat(label: str = "") -> int | None:
    """Beat iff this process runs under a supervisor (env var set);
    silently a no-op otherwise, so instrumented code is unconditional.
    Every beat is mirrored into the span flight recorder (when one is
    active) so the trace timeline carries the same progress marks the
    supervisor judged: a killed worker's record shows which beat was its
    last."""
    global _writer
    seq = None
    path = os.environ.get(HEARTBEAT_ENV)
    if path:
        if _writer is None or _writer.path != path:
            _writer = HeartbeatWriter(path)
        seq = _writer.beat(label)
    # obs.spans is as torch-free as this module; event() no-ops without
    # an active recorder, mirroring the beat no-op above
    from mpi_knn_tpu_torch.obs.spans import event as _flight_event

    _flight_event("beat", cat="heartbeat", label=label,
                  **({"seq": seq} if seq is not None else {}))
    return seq


def read_beat(path: str) -> dict | None:
    """Supervisor side: the latest beat, or None (missing / torn file —
    a beat in the middle of its atomic rename reads as the previous one,
    never as garbage)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) and "seq" in doc else None
