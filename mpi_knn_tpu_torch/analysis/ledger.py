"""Shared ledger machinery for the lint's drift gates (the JAX package's
``analysis/ledger.py``, in the port's own copy).

Two rules bank per-cell numbers into committed JSON ledgers — R7's peak-HBM
ledger and R8's static cost ledger — and both need the same lifecycle:
atomic merge-aware writes, a schema gate on load, vanished-cell detection
on full-matrix sweeps, and a tolerance-banded drift check where growth is a
regression naming a culprit and shrinkage is a stale ledger hiding a banked
win. That lifecycle lives HERE, once, so the two gates cannot diverge: a
semantics fix (e.g. the environment-skipped-cell carve-out) lands in both
ledgers by construction. Each client declares a :class:`LedgerSpec` — the
schema version, the regeneration command its messages prescribe, the
tolerance band, and the metric(s) compared — and delegates; R7's public
gates in ``memory.py`` and ``cost.py`` declare theirs.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One scalar a ledger certifies per cell.

    ``key`` reads the value from the cell entry dict; ``noun``/``unit``
    render the drift messages ("peak grew … bytes"); ``culprit`` (given
    the CURRENT cell entry) names what to blame on growth — the largest
    temp for R7, the hottest dot for R8 — appended after an em-dash.
    """

    key: str
    noun: str
    unit: str = "bytes"
    culprit: Callable[[dict], str] | None = None


@dataclasses.dataclass(frozen=True)
class LedgerSpec:
    """What distinguishes one ledger from another: everything else is
    shared lifecycle. ``regen_cmd`` is the exact CLI the drift messages
    prescribe (stale ledgers must name their own remedy)."""

    kind: str  # "memory" / "cost" — message prefix on load errors
    schema_version: int
    source: str  # doc provenance field
    regen_cmd: str  # e.g. "python -m mpi_knn_tpu_torch lint --memory"
    tol_rel: float
    tol_abs: int
    metrics: tuple[MetricSpec, ...]


def load_ledger(path, spec: LedgerSpec) -> dict | None:
    """The committed ledger doc, ``None`` when absent, ``ValueError``
    when the schema is not the one this build writes (a stale artifact
    must be regenerated, not half-read)."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    doc = json.loads(path.read_text())
    if doc.get("schema_version") != spec.schema_version:
        raise ValueError(
            f"{spec.kind} ledger {path} has schema "
            f"{doc.get('schema_version')!r}, expected "
            f"{spec.schema_version} (regenerate with "
            f"`{spec.regen_cmd}`)"
        )
    return doc


def save_ledger(path, cells: dict, spec: LedgerSpec,
                merge_into: dict | None = None, platform: str = "cpu"):
    """Write the ledger (atomically — lint may run concurrently with a
    serve process reading it). ``merge_into``: an existing ledger doc
    whose cells this run did not run again are preserved, so a filtered
    sweep refreshes only what it measured."""
    import torch

    from mpi_knn_tpu_torch.utils.atomicio import atomic_write_text

    path = pathlib.Path(path)
    merged = dict(merge_into.get("cells", {})) if merge_into else {}
    merged.update(cells)
    doc = {
        "schema_version": spec.schema_version,
        "source": spec.source,
        "torch_version": torch.__version__,
        "platform": platform,
        "tolerance": {"rel": spec.tol_rel, "abs_bytes": spec.tol_abs},
        "cells": {k: merged[k] for k in sorted(merged)},
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(path, json.dumps(doc, indent=1) + "\n")
    return doc


def merge_base_for(
    committed: dict | None, *, full_matrix: bool,
    skipped_labels: frozenset | set = frozenset(),
) -> dict | None:
    """What a ledger WRITE should merge the fresh cells into. A filtered
    sweep refreshes only what it ran again, so the committed ledger is
    preserved wholesale. A FULL-matrix regeneration must PURGE vanished
    cells — otherwise the drift gate's prescribed remedy (regenerate
    after deleting a cell on purpose) would re-import the dead entry
    forever — while cells whose run was environment-skipped THIS
    run (not a dropped certification) keep their
    committed entries."""
    if committed is None:
        return None
    if not full_matrix:
        return committed
    preserved = {
        k: v for k, v in committed.get("cells", {}).items()
        if k in skipped_labels
    }
    return {"cells": preserved} if preserved else None


def ledger_drift(
    committed: dict, current: dict, spec: LedgerSpec, *,
    full_matrix: bool, skipped_labels: frozenset | set = frozenset(),
) -> list[str]:
    """Why the current per-cell numbers fail the committed ledger
    (empty = green). Growth beyond tolerance is a regression; shrinkage
    beyond tolerance is a stale ledger hiding a banked win — both fail.
    A NEW cell (current, not committed) extends the ledger and is not a
    finding; a VANISHED cell (committed, not current) is one — but only
    on full-matrix runs, where absence means the certification was
    dropped rather than filtered out, and never for a cell in
    ``skipped_labels`` (skipped this run, a coverage gap, not a
    regression)."""
    out = []
    committed_cells = committed.get("cells", {})
    for label in sorted(set(committed_cells) | set(current)):
        old = committed_cells.get(label)
        new = current.get(label)
        if old is None:
            continue  # new cell: extends the ledger
        if new is None:
            if full_matrix and label not in skipped_labels:
                out.append(
                    f"{label}: cell vanished from the matrix but is "
                    "still in the committed ledger — a dropped "
                    "certification (regenerate the ledger if the cell "
                    "was removed on purpose)"
                )
            continue
        for metric in spec.metrics:
            was, now = old[metric.key], new[metric.key]
            tol = max(spec.tol_abs, was * spec.tol_rel)
            if now > was + tol:
                blame = (
                    f" — {metric.culprit(new)}" if metric.culprit else ""
                )
                out.append(
                    f"{label}: {metric.noun} grew {was} → {now} "
                    f"{metric.unit} (+{now - was}, tolerance "
                    f"{int(tol)}){blame}"
                )
            elif now < was - tol:
                out.append(
                    f"{label}: {metric.noun} shrank {was} → {now} "
                    f"{metric.unit} beyond tolerance — the committed "
                    "ledger is stale; regenerate with "
                    f"`{spec.regen_cmd}` to bank the improvement"
                )
    return out
