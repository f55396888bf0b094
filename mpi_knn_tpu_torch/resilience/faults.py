"""Fault injection: every resilience path exercised on the CPU, not
trusted (the JAX package's ``resilience/faults.py``).

The failure handling (heartbeat kills, retry and backoff, the NaN
sentinel, the degradation ladder) exists for failures that a wedged card
or transport produces naturally. This module makes them producible on
demand, on the CPU: instrumented call sites ask :func:`fault_point`
whether a fault is armed for them, and armed faults act (hang / raise /
sleep); the serving session calls :func:`poison_topk` to inject a NaN
into a batch's result.

Faults are armed two ways, equally expressive:

- the ``TKNN_FAULTS`` environment variable, for subprocess tests and
  operators: comma-separated ``site=kind[:arg]`` specs::

      TKNN_FAULTS="doctor-probe=hang"
      TKNN_FAULTS="serve-batch=transient:2,serve-nan=nan"
      TKNN_FAULTS="serve-batch=slow:0.2"

- the :class:`install_faults` context manager, for in-process tests.

Kinds:

- ``hang``: block forever (a killable sleep loop), the wedged-transport
  stand-in; ``hang:N`` lets the first N−1 hits of the site pass and
  hangs on the N-th (worked-then-wedged);
- ``transient:N``: raise :class:`TransientFault` on the first N hits of
  the site, then succeed (the retry path's success after N);
- ``slow:S``: sleep S seconds (deadline-breach injection);
- ``nan``: :func:`poison_topk` writes NaN into element [0, 0] of the
  batch's top-k distances, on the card in the device tensor before the
  copy to the host.

No torch import: the supervisors import this in processes that must
never touch the card.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time


class TransientFault(RuntimeError):
    """An injected failure that succeeds on retry (the model of a
    recoverable transport error)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str  # "hang" | "transient" | "slow" | "nan"
    arg: float = 0.0  # transient: remaining-failure count; slow: seconds


_VALID_KINDS = ("hang", "transient", "slow", "nan")

_lock = threading.Lock()
_installed: dict[str, FaultSpec] | None = None  # in-process overrides
_hit_counts: dict[str, int] = {}


def parse_fault_env(value: str) -> dict[str, FaultSpec]:
    """Parse a ``TKNN_FAULTS`` value into site → spec. Malformed specs
    raise ValueError loudly — a typo'd fault silently not firing would
    make a resilience test vacuously green."""
    out: dict[str, FaultSpec] = {}
    for item in value.split(","):
        item = item.strip()
        if not item:
            continue
        site, _, kindspec = item.partition("=")
        kind, _, arg = kindspec.partition(":")
        if not site or kind not in _VALID_KINDS:
            raise ValueError(
                f"bad TKNN_FAULTS entry {item!r}: want site=kind[:arg] "
                f"with kind in {_VALID_KINDS}"
            )
        out[site] = FaultSpec(site, kind, float(arg) if arg else 0.0)
    return out


def active_faults() -> dict[str, FaultSpec]:
    """The armed fault set: in-process installs win over the env var
    (re-read every call — cheap, and subprocess-env tests rely on it)."""
    if _installed is not None:
        return _installed
    env = os.environ.get("TKNN_FAULTS")
    return parse_fault_env(env) if env else {}


class install_faults:
    """Context manager arming faults in-process::

        with install_faults({"serve-batch": ("transient", 2)}):
            ...

    Values are ``FaultSpec`` or ``(kind, arg)`` / ``kind`` shorthands.
    Hit counters reset on entry AND exit so tests cannot leak state.
    """

    def __init__(self, faults: dict):
        self.faults = {
            site: (
                spec
                if isinstance(spec, FaultSpec)
                else FaultSpec(site, *(
                    (spec, 0.0) if isinstance(spec, str)
                    else (spec[0], float(spec[1]))
                ))
            )
            for site, spec in faults.items()
        }

    def __enter__(self):
        global _installed
        reset_fault_state()
        _installed = self.faults
        return self

    def __exit__(self, *exc):
        global _installed
        _installed = None
        reset_fault_state()
        return False


def reset_fault_state() -> None:
    """Clear per-site hit counters (transient-fault bookkeeping)."""
    with _lock:
        _hit_counts.clear()


def _hit(site: str) -> int:
    with _lock:
        _hit_counts[site] = _hit_counts.get(site, 0) + 1
        return _hit_counts[site]


def fault_point(site: str) -> None:
    """Instrumented call site: act on the fault armed for ``site``.

    - hang: never returns (the supervisor's beat-starvation kill is the
      only way out — exactly the wedged-transport shape); ``hang:N``
      passes the first N−1 hits and hangs on the N-th — the
      "worked-then-wedged" shape the flight-recorder tests need (a few
      clean batch spans, then an open one at the kill);
    - transient:N: raises :class:`TransientFault` for the first N hits;
    - slow:S: sleeps S seconds, then returns;
    - nan: no-op here (value faults act at :func:`poison_topk`).
    """
    spec = active_faults().get(site)
    if spec is None:
        return
    if spec.kind == "hang":
        if spec.arg and _hit(site) < int(spec.arg):
            return
        while True:  # killable sleep loop, not one unbounded syscall
            time.sleep(0.25)
    if spec.kind == "transient":
        n = _hit(site)
        if n <= int(spec.arg):
            raise TransientFault(
                f"injected transient fault at {site!r} "
                f"(hit {n}/{int(spec.arg)})"
            )
        return
    if spec.kind == "slow":
        time.sleep(spec.arg)
        return
    # "nan" faults act at poison_topk


def poison_topk(dists, site: str = "serve-nan"):
    """Write NaN into element [0, 0] of a batch's top-k distance tensor
    when a ``nan`` fault is armed for ``site``: the stand-in for a NaN
    born in a distance tile. The write is in place, on the current stream,
    so on a card it lands in the device result before that result's copy
    to the host is enqueued. Returns ``dists`` (untouched when unarmed: a
    dict lookup, no device work)."""
    spec = active_faults().get(site)
    if spec is None or spec.kind != "nan":
        return dists
    dists[(0,) * dists.ndim] = float("nan")
    return dists
