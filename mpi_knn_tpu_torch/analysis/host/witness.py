"""Runtime race witnesses — the dynamic twin of the static host lint,
armed in tests only.

The static rules (H1/H2) prove properties of the SOURCE; this module
observes the same properties at RUNTIME so every rule ships with a
counterexample that actually executes: a lock-order inversion the H2
graph flags statically is reproduced with two real threads and shows up
in :meth:`WitnessLog.inversions`, and an unguarded attribute access the
H1 map flags shows up in :meth:`WitnessLog.guard_violations`.

Mechanics: :class:`InstrumentedLock` wraps a real ``threading.Lock``
and records every acquisition with the witness-lock set the acquiring
thread already holds — the classic lock-order witness. Production
objects keep their own plain locks; tests swap an instance's lock attrs
for instrumented ones (:func:`instrument`) or build fixtures directly.
Nothing in this module is imported by production code paths.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Iterator
from types import TracebackType


@dataclasses.dataclass(frozen=True)
class AcquireEvent:
    lock: str
    held_before: tuple[str, ...]
    thread: str


@dataclasses.dataclass(frozen=True)
class AccessEvent:
    name: str
    kind: str  # "read" | "write"
    held: tuple[str, ...]
    thread: str


class WitnessLog:
    """Thread-safe record of lock acquisitions and guarded accesses."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acquires: list[AcquireEvent] = []
        self._accesses: list[AccessEvent] = []
        self._held = threading.local()

    # -- bookkeeping (called by InstrumentedLock) -------------------------

    def _held_stack(self) -> list[str]:
        stack = getattr(self._held, "v", None)
        if stack is None:
            stack = self._held.v = []
        return stack

    def note_acquire(self, name: str) -> None:
        stack = self._held_stack()
        ev = AcquireEvent(
            lock=name,
            held_before=tuple(stack),
            thread=threading.current_thread().name,
        )
        with self._lock:
            self._acquires.append(ev)
        stack.append(name)

    def note_release(self, name: str) -> None:
        stack = self._held_stack()
        if name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()

    def note_access(self, name: str, kind: str = "read") -> None:
        """Record one access to a witness-guarded attribute with the
        instrumented locks currently held by this thread."""
        ev = AccessEvent(
            name=name,
            kind=kind,
            held=tuple(self._held_stack()),
            thread=threading.current_thread().name,
        )
        with self._lock:
            self._accesses.append(ev)

    # -- verdicts ---------------------------------------------------------

    @property
    def acquires(self) -> list[AcquireEvent]:
        with self._lock:
            return list(self._acquires)

    @property
    def accesses(self) -> list[AccessEvent]:
        with self._lock:
            return list(self._accesses)

    def ordered_pairs(self) -> set[tuple[str, str]]:
        """(outer, inner) pairs actually observed: inner acquired while
        outer was held."""
        pairs: set[tuple[str, str]] = set()
        for ev in self.acquires:
            for outer in ev.held_before:
                if outer != ev.lock:
                    pairs.add((outer, ev.lock))
        return pairs

    def inversions(self) -> set[tuple[str, str]]:
        """Lock pairs observed in BOTH orders — the runtime witness of
        an H2 lock-order cycle (a real interleaving of these two
        threads deadlocks)."""
        pairs = self.ordered_pairs()
        return {(a, b) for (a, b) in pairs if (b, a) in pairs and a < b}

    def guard_violations(self, guard_map: dict[str, str]) -> list[AccessEvent]:
        """Accesses that did not hold their declared lock — the runtime
        witness of an H1 guard breach. ``guard_map`` maps access name →
        required instrumented-lock name."""
        out = []
        for ev in self.accesses:
            lock = guard_map.get(ev.name)
            if lock is not None and lock not in ev.held:
                out.append(ev)
        return out


class InstrumentedLock:
    """A ``threading.Lock`` work-alike that reports every acquisition
    (with the holder's current witness-lock set) to a
    :class:`WitnessLog`. Drop-in for ``with obj._lock:`` call sites —
    supports the context manager protocol plus bare
    ``acquire``/``release``."""

    def __init__(self, name: str, log: WitnessLog,
                 lock: threading.Lock | None = None) -> None:
        self.name = name
        self.log = log
        self._inner = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self.log.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self.log.note_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc: BaseException | None,
        tb: TracebackType | None,
    ) -> None:
        self.release()


@contextlib.contextmanager
def instrument(
    obj: object, log: WitnessLog, *attrs: str, prefix: str = ""
) -> Iterator[WitnessLog]:
    """Temporarily replace ``obj``'s named lock attributes with
    instrumented wrappers around the SAME underlying locks, so
    production code paths driven by a test report their acquisition
    order into ``log`` — armed in tests only, restored on exit."""
    saved = {}
    for attr in attrs:
        inner = getattr(obj, attr)
        saved[attr] = inner
        name = f"{prefix}{type(obj).__name__}.{attr}"
        setattr(
            obj, attr,
            InstrumentedLock(name, log, lock=inner),
        )
    try:
        yield log
    finally:
        for attr, inner in saved.items():
            setattr(obj, attr, inner)
