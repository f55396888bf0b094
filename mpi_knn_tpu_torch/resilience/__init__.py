"""Resilient execution (the JAX package's ``resilience/``).

A serving stack is production-shaped when hangs, transient faults and
overload degrade gracefully instead of wedging the process: failures
bounded and observable, not fatal. Four pieces, each importable without
touching the card:

- :mod:`~mpi_knn_tpu_torch.resilience.heartbeat`: the progress-beat
  protocol between a supervised worker subprocess and its supervisor;
- :mod:`~mpi_knn_tpu_torch.resilience.worker`: the isolated worker
  runner: one unit of work per subprocess, killed on beat starvation
  (wall-clock as the outer bound), always returning a structured
  ``ok`` / ``timeout`` / ``crashed`` result with captured output;
- :mod:`~mpi_knn_tpu_torch.resilience.faults`: env- or context-driven
  fault injection (hang, transient exception with recovery, NaN poison,
  slow batch), so every resilience path is exercised on the CPU;
- :mod:`~mpi_knn_tpu_torch.resilience.retry` and
  :mod:`~mpi_knn_tpu_torch.resilience.ladder`: bounded exponential-backoff
  retry and the serving degradation ladder (smaller ``nprobe`` →
  ``precision_policy="mixed"`` → smaller bucket) that
  :class:`~mpi_knn_tpu_torch.serve.engine.ServeSession` walks under
  repeated deadline breach.

``python -m mpi_knn_tpu_torch doctor``
(:mod:`~mpi_knn_tpu_torch.resilience.doctor`) is the operator-facing
preflight built on the worker runner.

Nothing here imports torch at module load: the doctor's supervisor runs
it in a process that must never initialize CUDA.
"""

from mpi_knn_tpu_torch.resilience.faults import (
    TransientFault,
    fault_point,
    install_faults,
    poison_topk,
    reset_fault_state,
)
from mpi_knn_tpu_torch.resilience.heartbeat import (
    HEARTBEAT_ENV,
    HeartbeatWriter,
    maybe_beat,
    read_beat,
)
from mpi_knn_tpu_torch.resilience.ladder import (
    PoisonedResultError,
    ResiliencePolicy,
    build_ladder,
)
from mpi_knn_tpu_torch.resilience.retry import (
    RetryExhausted,
    RetryOutcome,
    backoff_schedule,
    retry_with_backoff,
)
from mpi_knn_tpu_torch.resilience.worker import WorkerResult, run_supervised

__all__ = [
    "HEARTBEAT_ENV",
    "HeartbeatWriter",
    "PoisonedResultError",
    "ResiliencePolicy",
    "RetryExhausted",
    "RetryOutcome",
    "TransientFault",
    "WorkerResult",
    "backoff_schedule",
    "build_ladder",
    "fault_point",
    "install_faults",
    "maybe_beat",
    "poison_topk",
    "read_beat",
    "reset_fault_state",
    "retry_with_backoff",
    "run_supervised",
]
