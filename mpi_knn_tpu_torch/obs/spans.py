"""Span flight recorder: structured trace spans written incrementally to
an append-only JSONL ring file (the JAX package's ``obs/spans.py``; the
record schema is the reference's, so either package's
:func:`validate_flight` accepts the other's file).

Why incremental append: a trace held in memory dies with its process.
Every record (span begin, span end, instant event) is one JSON line,
written and flushed the moment it happens, so a SIGKILLed worker leaves a
readable flight record up to the instant of death: an OPEN ``batch`` span
in the file is the diagnosis ("killed mid-batch 7, rung=full, after 2
retries"). The supervisor (``resilience.worker.run_supervised``) reads
the record back and banks it beside the structured failure line.

Why a ring: a long-lived server must not grow an unbounded trace file.
When the file exceeds ``max_bytes`` it is rotated once (``path`` →
``path.1``) and writing restarts; readers see the previous generation
plus the current one, so at least ``max_bytes`` of recent history always
survives, and disk use is bounded at ~2×``max_bytes``.

Record schema (one JSON object per line):

- begin:   ``{"ev": "B", "span": id, "parent": id|null, "name": str,
  "cat": str, "ts": epoch_s, "pid": int, "tid": int[, "attrs": {...}]}``
- end:     ``{"ev": "E", "span": id, "ts": epoch_s, "dur_s": float
  [, "attrs": {...}]}`` (``dur_s`` measured on ``perf_counter``, never
  by subtracting epoch stamps)
- instant: ``{"ev": "I", "name": str, "cat": str, "ts": epoch_s,
  "pid": int[, "attrs": {...}]}``
- ring marker: ``{"ev": "R", "gen": n, "ts": epoch_s}``, the first record
  of every post-rotation generation. When a reader's FIRST retained
  record is a marker, the generation before it was dropped by the ring
  (two rotations happened), so ends/parents referencing the truncated
  prefix are expected, not corruption.

:func:`validate_flight` checks exactly this schema (finite non-negative
times, every end matching an open begin, parent references to known
spans, both relaxed for records predating a truncated ring prefix).
:func:`to_chrome_trace` exports the record as Chrome trace-event JSON
loadable in Perfetto.

Writers are serialized by one lock per recorder, and each record is one
``write`` of a whole line followed by a flush: the dispatch thread, the
compactor and warm threads append to one file without tearing a line.

Instrumented code uses the module-level :func:`span`/:func:`event`/
:func:`begin_span`/:func:`end_span` helpers, which no-op unless a
recorder is active: installed explicitly (:func:`set_recorder`) or
inherited from a supervisor via the ``TKNN_FLIGHT_RECORD`` env var.

No torch import in this module.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time

RECORDER_ENV = "TKNN_FLIGHT_RECORD"

SPAN_CATEGORIES = (
    "serve", "index", "compile", "bench", "retry", "heartbeat", "profile",
    "frontend",
)


class FlightRecorder:
    """One append-only JSONL ring file; thread-safe; every record
    flushed on write (kernel-buffered data survives SIGKILL of the
    writer — only a machine crash loses it, and fsync-per-span would
    tax the serving hot path for a failure mode supervision cannot see
    anyway)."""

    def __init__(self, path: str, max_bytes: int = 8 << 20,
                 fresh: bool = False):
        if max_bytes < 4096:
            raise ValueError(f"max_bytes too small to be useful: {max_bytes}")
        self.path = str(path)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._f = None
        self._gen = 0
        self._ids = itertools.count(1)
        self._open_t0: dict[int, float] = {}  # span id -> perf_counter
        self._stack = threading.local()
        if fresh:
            for p in (self.path, self.path + ".1"):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    # -- io ---------------------------------------------------------------

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        with self._lock:
            if self._f is None:
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "a", encoding="utf-8")
            if self._f.tell() + len(line) > self.max_bytes:
                # rotate exactly one generation: bounded disk, and the
                # most recent max_bytes of history always survives
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self._f = open(self.path, "a", encoding="utf-8")
                self._gen += 1
                # generation marker: when this is a reader's FIRST
                # retained record, the prefix before it rotated away —
                # validate_flight tolerates dangling ends/parents then
                self._f.write(json.dumps(
                    {"ev": "R", "gen": self._gen, "ts": time.time()},
                    separators=(",", ":"),
                ) + "\n")
            self._f.write(line)
            self._f.flush()  # the incremental-survival property

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # -- span api ---------------------------------------------------------

    def _top(self):
        stack = getattr(self._stack, "v", None)
        return stack[-1] if stack else None

    def begin(self, name: str, cat: str = "", parent: int | None = None,
              **attrs) -> int:
        sid = next(self._ids)
        rec = {
            "ev": "B",
            "span": sid,
            "parent": self._top() if parent is None else parent,
            "name": name,
            "cat": cat,
            "ts": time.time(),
            "pid": os.getpid(),
            "tid": threading.get_ident(),
        }
        if attrs:
            rec["attrs"] = attrs
        with self._lock:
            # under the recorder lock: begin/end run on every serving
            # thread, and the pop in end() may run on another
            self._open_t0[sid] = time.perf_counter()
        self._write(rec)
        return sid

    def end(self, sid: int, **attrs) -> None:
        with self._lock:
            t0 = self._open_t0.pop(sid, None)
        rec = {
            "ev": "E",
            "span": sid,
            "ts": time.time(),
            "dur_s": 0.0 if t0 is None else time.perf_counter() - t0,
        }
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)

    def event(self, name: str, cat: str = "", **attrs) -> None:
        rec = {
            "ev": "I",
            "name": name,
            "cat": cat,
            "ts": time.time(),
            "pid": os.getpid(),
        }
        if attrs:
            rec["attrs"] = attrs
        self._write(rec)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "", **attrs):
        sid = self.begin(name, cat=cat, **attrs)
        stack = getattr(self._stack, "v", None)
        if stack is None:
            stack = self._stack.v = []
        stack.append(sid)
        try:
            yield sid
        except BaseException as e:
            stack.pop()
            self.end(sid, error=type(e).__name__)
            raise
        else:
            stack.pop()
            self.end(sid)


# ---------------------------------------------------------------------------
# process-level recorder (explicit install wins over the env var)

# module lock for the recorder globals: get_recorder runs on every
# instrumented thread (dispatch, compactor, warm pool), and an unguarded
# lazy construction could open two FlightRecorder handles onto one path
_reclock = threading.Lock()
_recorder: FlightRecorder | None = None
_env_recorder: FlightRecorder | None = None


def set_recorder(rec: FlightRecorder | None) -> None:
    """Install (or clear) the process recorder explicitly: the query
    CLI's ``--flight-record`` path. Overrides ``TKNN_FLIGHT_RECORD``."""
    global _recorder
    with _reclock:
        prev, _recorder = _recorder, rec
    if prev is not None and prev is not rec:
        prev.close()


def get_recorder() -> FlightRecorder | None:
    """The active recorder: the explicitly installed one, else one bound
    to ``TKNN_FLIGHT_RECORD`` (cached per path — supervisors point each
    worker at a fresh file), else None."""
    global _env_recorder
    with _reclock:
        if _recorder is not None:
            return _recorder
        path = os.environ.get(RECORDER_ENV)
        if not path:
            return None
        if _env_recorder is None or _env_recorder.path != path:
            _env_recorder = FlightRecorder(path)
        return _env_recorder


def begin_span(name: str, cat: str = "", **attrs) -> int | None:
    """Begin a span that will be ended by a *different* call site
    (e.g. serve dispatch → retire); no-op without a recorder."""
    rec = get_recorder()
    return None if rec is None else rec.begin(name, cat=cat, **attrs)


def end_span(sid: int | None, **attrs) -> None:
    rec = get_recorder()
    if rec is not None and sid is not None:
        rec.end(sid, **attrs)


def event(name: str, cat: str = "", **attrs) -> None:
    rec = get_recorder()
    if rec is not None:
        rec.event(name, cat=cat, **attrs)


@contextlib.contextmanager
def span(name: str, cat: str = "", **attrs):
    rec = get_recorder()
    if rec is None:
        yield None
        return
    with rec.span(name, cat=cat, **attrs) as sid:
        yield sid


# ---------------------------------------------------------------------------
# reading / validation / export


def read_flight(path: str) -> list[dict]:
    """Every record of a flight file (previous ring generation first).
    A torn final line — the one a SIGKILL can produce mid-write — is
    skipped; a torn line anywhere else is impossible under the
    write+flush protocol and therefore *reported* by validate_flight,
    not silently dropped here (unparseable interior lines are kept as
    ``{"ev": "?", "raw": ...}`` markers)."""
    out: list[dict] = []
    for p in (path + ".1", path):
        try:
            with open(p, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
            except ValueError:
                if p == path and i == len(lines) - 1:
                    continue  # torn tail: the kill landed mid-write
                doc = {"ev": "?", "raw": line[:200]}
            out.append(doc if isinstance(doc, dict)
                       else {"ev": "?", "raw": str(doc)[:200]})
    return out


def reconstruct_spans(records: list[dict]) -> tuple[list[dict], list[dict]]:
    """(spans, events): each span dict carries ``name/cat/ts/pid/attrs``
    from its begin record plus ``dur_s``/``end_attrs`` when closed
    (``dur_s`` is None for spans still open at the end of the record —
    the kill diagnosis). Span identity is (pid, span id): records from
    a supervisor and several workers may share one file."""
    spans: dict[tuple, dict] = {}
    # span id -> stack of still-open keys with that id: E records carry
    # no pid, and matching the newest open candidate this way keeps the
    # whole pass O(records) (a large ring file holds ~100k spans)
    open_by_sid: dict[int, list[tuple]] = {}
    events: list[dict] = []
    for rec in records:
        ev = rec.get("ev")
        if ev == "B":
            key = (rec.get("pid"), rec.get("span"))
            spans[key] = {
                "span": rec.get("span"),
                "parent": rec.get("parent"),
                "name": rec.get("name"),
                "cat": rec.get("cat", ""),
                "ts": rec.get("ts"),
                "pid": rec.get("pid"),
                "attrs": rec.get("attrs", {}),
                "dur_s": None,
                "end_attrs": None,
            }
            open_by_sid.setdefault(rec.get("span"), []).append(key)
        elif ev == "E":
            stack = open_by_sid.get(rec.get("span"))
            if stack:
                key = stack.pop()
                spans[key]["dur_s"] = rec.get("dur_s")
                spans[key]["end_attrs"] = rec.get("attrs", {})
        elif ev == "I":
            events.append(rec)
    return list(spans.values()), events


def _finite_nonneg(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v) and v >= 0


def validate_flight(records: list[dict]) -> list[str]:
    """Schema problems in a flight record, empty when clean — the CI
    gate's checker. Checks per record: known ``ev`` kind, required
    fields, finite non-negative timestamps and durations (NaN/negative
    durations are exactly the corruption a misparsed trace produces),
    every end matching a begun-and-still-open span, and parent
    references pointing at spans already begun (well-formed nesting).

    When the FIRST retained record is a ring marker (``ev: "R"``), the
    generation before it was dropped by the ring — a healthy long-lived
    server, not corruption — so ends and parent references that point
    into the truncated prefix are tolerated rather than reported."""
    problems: list[str] = []
    begun: dict[tuple, bool] = {}  # (pid, span) -> still open
    open_by_sid: dict[int, list[tuple]] = {}  # O(records), as above
    truncated = bool(records) and records[0].get("ev") == "R"
    for i, rec in enumerate(records):
        where = f"record {i}"
        ev = rec.get("ev")
        if ev == "?":
            problems.append(f"{where}: unparseable line {rec.get('raw')!r}")
            continue
        if ev not in ("B", "E", "I", "R"):
            problems.append(f"{where}: unknown ev {ev!r}")
            continue
        if not _finite_nonneg(rec.get("ts")):
            problems.append(f"{where}: bad ts {rec.get('ts')!r}")
        if ev == "R":
            gen = rec.get("gen")
            if not isinstance(gen, int) or gen < 1:
                problems.append(f"{where}: ring marker with bad gen {gen!r}")
        elif ev == "B":
            if not rec.get("name"):
                problems.append(f"{where}: begin without name")
            sid, pid = rec.get("span"), rec.get("pid")
            if not isinstance(sid, int):
                problems.append(f"{where}: begin without span id")
                continue
            if begun.get((pid, sid)) is not None:
                problems.append(f"{where}: duplicate span id {sid} (pid {pid})")
            parent = rec.get("parent")
            if parent is not None and (pid, parent) not in begun \
                    and not truncated:
                problems.append(
                    f"{where}: parent {parent} of span {sid} never began"
                )
            begun[(pid, sid)] = True
            open_by_sid.setdefault(sid, []).append((pid, sid))
        elif ev == "E":
            sid = rec.get("span")
            stack = open_by_sid.get(sid)
            if stack:
                begun[stack.pop()] = False
            elif not truncated:
                problems.append(
                    f"{where}: end for span {sid!r} that is not open"
                )
            if not _finite_nonneg(rec.get("dur_s")):
                problems.append(
                    f"{where}: bad dur_s {rec.get('dur_s')!r} "
                    f"for span {sid!r}"
                )
        else:  # I
            if not rec.get("name"):
                problems.append(f"{where}: event without name")
    return problems


def summarize_flight(records: list[dict], tail: int = 3) -> dict | None:
    """The compact form a supervisor banks next to a failure line:
    record/span/event counts, the names of spans left OPEN at death
    (the diagnosis), and the last few raw records. None when the worker
    recorded nothing."""
    if not records:
        return None
    spans, events = reconstruct_spans(records)
    open_spans = [s for s in spans if s["dur_s"] is None]
    return {
        "records": len(records),
        "spans_complete": len(spans) - len(open_spans),
        "events": len(events),
        "open_spans": [
            {"name": s["name"], "cat": s["cat"], "attrs": s["attrs"]}
            for s in open_spans
        ],
        "last": records[-tail:],
    }


def to_chrome_trace(records: list[dict]) -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` array form) loadable
    in Perfetto / chrome://tracing. Closed spans become complete ``X``
    events; spans still open at the end of the record become dangling
    ``B`` events — Perfetto renders them to the end of the trace, which
    is exactly the right picture of a killed worker."""
    trace: list[dict] = []
    spans, events = reconstruct_spans(records)
    for s in spans:
        base = {
            "name": s["name"],
            "cat": s["cat"] or "default",
            "pid": s["pid"] or 0,
            "tid": 0,
            "ts": (s["ts"] or 0.0) * 1e6,
            "args": s["attrs"] or {},
        }
        if s["dur_s"] is None:
            trace.append({**base, "ph": "B"})
        else:
            args = dict(base["args"])
            if s["end_attrs"]:
                args.update(s["end_attrs"])
            trace.append(
                {**base, "ph": "X", "dur": s["dur_s"] * 1e6, "args": args}
            )
    for e in events:
        trace.append({
            "name": e.get("name"),
            "cat": e.get("cat") or "default",
            "pid": e.get("pid") or 0,
            "tid": 0,
            "ts": (e.get("ts") or 0.0) * 1e6,
            "ph": "i",
            "s": "p",
            "args": e.get("attrs", {}),
        })
    trace.sort(key=lambda r: r["ts"])
    return {"traceEvents": trace, "displayTimeUnit": "ms"}
