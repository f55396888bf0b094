"""The port's analysis layer (the JAX package's ``analysis/``): the rule
engine R1–R8 over the port's recorded runs (:mod:`~mpi_knn_tpu_torch.
analysis.engine`, ``rules``, ``lowering``, ``ledger``; the recorder is
``utils/op_trace.py``), the host concurrency lint
(:mod:`~mpi_knn_tpu_torch.analysis.host`), the device profiles,
closed-form FLOPs and roofline (:mod:`~mpi_knn_tpu_torch.analysis.cost`)
and the memory model of the port's layouts
(:mod:`~mpi_knn_tpu_torch.analysis.memory`) the capacity planner
(``mpi_knn_tpu_torch/plan.py``) reads.

Nothing here imports torch at import time; the names below load on first
use.
"""

from __future__ import annotations

_EXPORTS = {
    # cost: device profiles, closed forms, roofline
    "DEFAULT_PROFILE": "mpi_knn_tpu_torch.analysis.cost",
    "H100_PROFILE": "mpi_knn_tpu_torch.analysis.cost",
    "analytical_mxu_flops": "mpi_knn_tpu_torch.analysis.cost",
    "detected_profile": "mpi_knn_tpu_torch.analysis.cost",
    "get_profile": "mpi_knn_tpu_torch.analysis.cost",
    "load_profiles": "mpi_knn_tpu_torch.analysis.cost",
    "profile_for_device": "mpi_knn_tpu_torch.analysis.cost",
    "roofline": "mpi_knn_tpu_torch.analysis.cost",
    # the rule engine over recorded runs
    "Finding": "mpi_knn_tpu_torch.analysis.rules",
    "LintContext": "mpi_knn_tpu_torch.analysis.engine",
    "LintReport": "mpi_knn_tpu_torch.analysis.engine",
    "LintTarget": "mpi_knn_tpu_torch.analysis.lowering",
    "RULES": "mpi_knn_tpu_torch.analysis.rules",
    "TargetResult": "mpi_knn_tpu_torch.analysis.engine",
    "UnsupportedTarget": "mpi_knn_tpu_torch.analysis.lowering",
    "default_targets": "mpi_knn_tpu_torch.analysis.lowering",
    "lint_target": "mpi_knn_tpu_torch.analysis.engine",
    "lower_target": "mpi_knn_tpu_torch.analysis.lowering",
    "run_matrix": "mpi_knn_tpu_torch.analysis.engine",
    "run_rules": "mpi_knn_tpu_torch.analysis.engine",
    # host lint
    "run_host_lint": "mpi_knn_tpu_torch.analysis.host.engine",
    "HostReport": "mpi_knn_tpu_torch.analysis.host.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
