"""The serving degradation ladder and its policy knobs (the JAX
package's ``resilience/ladder.py``, rung for rung).

Under sustained per-batch deadline breach a serving session sheds load
down an explicit ladder instead of wedging or silently missing its
deadline. Each rung changes one query-side knob, in the order of how much
recall it is licensed to spend:

1. ``nprobe/2`` (clustered index only): probe half as many partitions;
   the rung's bar is the configured ``recall_target``, the bar the
   nprobe tuner gates on.
2. ``mixed``: switch ``precision_policy`` to the compress-and-rerank
   pipeline (bf16 pass, exact f64 rerank of 4k candidates); its bar is
   the ≥ 0.999 recall@10 gate.
3. ``bucket/2``: halve the row bucket, shrinking the padded batch. Bit
   for bit per row (bucket size never changes answers); it sheds latency
   by shrinking the unit of work, not by approximating it.

Rungs the index cannot honor (mixed over a bf16-at-rest index, nprobe on
a dense index, a bucket already at the floor) are skipped at ladder
construction, validated through the index's own contract, so the ladder
never promises a config the engine would refuse. Every rung is an
ordinary (bucket, config) entry of the engine, built by ``warm`` before
traffic like any other.

Two things walk the ladder down (``ServeSession.shed_rung``): the
session's own deadline machinery (``degrade_after`` consecutive
breaches) and, in the reference, its serving front end's scheduler; only
the front end walks it back up (``ServeSession.restore_rung``). Both
directions land in the metrics registry (``serve_degradations_total``,
``serve_restorations_total``, the ``serve_ladder_rung`` gauge) and the
flight record (``degrade`` / ``restore`` events with their reason).

``retryable`` stays ``(TransientFault,)``: a CUDA error (an illegal
address, a device-side assert) poisons the process's context, and a
retry would hand back garbage as an answer, so it propagates at once.

No torch import (supervisors use the policy types too).
"""

from __future__ import annotations

import dataclasses

from mpi_knn_tpu_torch.resilience.faults import TransientFault


class PoisonedResultError(RuntimeError):
    """The NaN/inf sentinel tripped on a served batch — raised loudly
    with full batch provenance; a poisoned top-k must never be returned
    as an answer or silently dropped."""

    def __init__(self, message: str, *, batch_seq: int, bucket: int,
                 rung: str, rows: int):
        super().__init__(message)
        self.batch_seq = batch_seq
        self.bucket = bucket
        self.rung = rung
        self.rows = rows


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Resilience knobs for one :class:`~mpi_knn_tpu_torch.serve.engine.
    ServeSession` (session state, not ``KNNConfig``: nothing here reaches
    a batch's computation, so nothing here may perturb the engine's entry
    keys)."""

    # per-batch deadline, measured dispatch → device_sync at retire time
    # (the honest latency the session already reports); None disables
    batch_deadline_s: float | None = None
    # bounded retry of a batch dispatch on retryable (transient) failures
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    retryable: tuple = (TransientFault,)
    # consecutive deadline breaches before shedding one ladder rung
    degrade_after: int = 2
    # NaN/all-inf sentinel on every retired batch's top-k
    nan_sentinel: bool = True
    # the bucket/2 rung never shrinks below this (tiny buckets trade
    # entries built for nothing)
    min_bucket: int = 16

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if self.degrade_after < 1:
            raise ValueError(
                f"degrade_after must be >= 1, got {self.degrade_after}"
            )
        if self.min_bucket < 1:
            raise ValueError(
                f"min_bucket must be >= 1, got {self.min_bucket}"
            )
        if self.batch_deadline_s is not None and self.batch_deadline_s < 0:
            raise ValueError(
                "batch_deadline_s must be >= 0 (or None to disable), "
                f"got {self.batch_deadline_s}"
            )


FULL_RUNG = "full"


def _try_rung(index, cfg):
    """Validate a candidate rung against the index's own contract;
    returns the validated cfg or None (rung skipped). A dense index
    validates it as it will be once the corpus part the rung reads is
    staged (``CorpusIndex.stageable_cfg``): a session that adopts the
    ladder stages every rung's part before traffic
    (``CorpusIndex.stage_for``), so an exact pallas index keeps the
    reference's ``mixed`` rung."""
    check = getattr(index, "stageable_cfg", None) or index.compatible_cfg
    try:
        return check(cfg)
    except ValueError:
        return None


def build_ladder(index, cfg, policy: ResiliencePolicy):
    """The session's degradation ladder: ``[(label, cfg), ...]`` starting
    at the configured rung. Rungs are CUMULATIVE — each extends the
    previous one — so the bottom rung is the cheapest program the ladder
    is licensed to serve. ``cfg`` must already be index-validated."""
    rungs = [(FULL_RUNG, cfg)]
    cur = cfg

    # rung: probe half as many partitions (clustered index only; the
    # reference's sharded form shares it)
    if (
        getattr(index, "backend", None) in ("ivf", "ivf-sharded")
        and cur.nprobe is not None
        and cur.nprobe > 1
    ):
        cand = _try_rung(index, cur.replace(nprobe=max(1, cur.nprobe // 2)))
        if cand is not None:
            rungs.append((f"nprobe/{cand.nprobe}", cand))
            cur = cand

    # rung: compress-and-rerank distance pipeline
    if cur.precision_policy == "exact":
        try:
            cand = cur.replace(precision_policy="mixed")
        except ValueError:
            # config-level refusal (non-f32 dtype, explicit matmul
            # precision): the rung does not exist for this session
            cand = None
        if cand is not None:
            cand = _try_rung(index, cand)
        if cand is not None:
            rungs.append(("mixed", cand))
            cur = cand

    # rung: halve the row bucket (floor: policy.min_bucket)
    half = cur.query_bucket // 2
    if half >= policy.min_bucket:
        cand = _try_rung(index, cur.replace(query_bucket=half))
        if cand is not None:
            rungs.append((f"bucket/{half}", cand))

    return rungs
