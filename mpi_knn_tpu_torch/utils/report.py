"""Structured run reports: the JAX package's ``utils/report.py`` for the
port (recall against a baseline, and one JSON document per run), with the
environment taken from torch instead of jax."""

from __future__ import annotations

import dataclasses
import json
import platform
from typing import Any, Dict, Optional

import numpy as np
import torch


def recall_at_k(got_ids, want_ids) -> float:
    """Fraction of baseline neighbors recovered (ignores order; ignores
    invalid (-1) baseline slots), in 4096-row chunks of a (q, k, k)
    broadcast."""
    got_ids = np.asarray(got_ids)
    want_ids = np.asarray(want_ids)
    hits, total = 0, 0
    for s in range(0, len(want_ids), 4096):
        g = got_ids[s: s + 4096]
        w = want_ids[s: s + 4096]
        valid = w >= 0
        found = (w[:, :, None] == g[:, None, :]).any(axis=-1) & valid
        hits += int(found.sum())
        total += int(valid.sum())
    return hits / total if total else 1.0


@dataclasses.dataclass
class RunReport:
    """One all-kNN run, serializable to a single JSON object."""

    config: Dict[str, Any]
    data_source: str
    shape: tuple
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    matches: Optional[int] = None
    total: Optional[int] = None
    accuracy: Optional[float] = None
    recall_vs_baseline: Optional[float] = None
    backend: Optional[str] = None
    num_devices: int = 1
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def finalize(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        d["environment"] = {
            "torch_version": torch.__version__,
            "platform": "gpu" if cards else "cpu",
            "devices": [torch.cuda.get_device_name(i) for i in range(cards)]
            or ["cpu"],
            "host": platform.node(),
        }
        return d

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.finalize(), indent=indent, default=str)

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())
