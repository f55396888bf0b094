"""Bounded exponential-backoff retry for transient failures (the JAX
package's ``resilience/retry.py``).

Deliberately deterministic (no jitter): the backoff sequence of a policy
is a fixed, assertable artifact, and a served batch carries the backoffs
it actually slept so an operator can read the retry story off the
record. Jitter buys nothing on a single-host serving loop and would make
the records fuzzy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from mpi_knn_tpu_torch.resilience.faults import TransientFault


class RetryExhausted(RuntimeError):
    """All retries spent; carries the last underlying failure as
    ``__cause__`` and the attempt count."""

    def __init__(self, attempts: int, last: BaseException):
        super().__init__(
            f"retry exhausted after {attempts} attempt(s): {last}"
        )
        self.attempts = attempts


@dataclasses.dataclass
class RetryOutcome:
    """A successful retried call: the value plus the retry story."""

    value: object
    attempts: int  # total calls made (1 = first try succeeded)
    backoffs: tuple  # seconds slept between attempts, in order


def backoff_schedule(
    retries: int, base_s: float, max_s: float
) -> tuple[float, ...]:
    """The full (deterministic) backoff sequence a policy allows:
    base·2^i capped at max_s, one entry per retry."""
    return tuple(min(base_s * (2.0**i), max_s) for i in range(retries))


def retry_with_backoff(
    fn: Callable[[], object],
    *,
    retries: int = 2,
    base_s: float = 0.05,
    max_s: float = 2.0,
    retryable: Sequence[type] = (TransientFault,),
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
) -> RetryOutcome:
    """Call ``fn`` with up to ``retries`` retries on ``retryable``
    exceptions, sleeping the :func:`backoff_schedule` between attempts.

    Non-retryable exceptions propagate untouched on the spot — a retry
    loop that swallows programming errors converts bugs into latency.
    Exhaustion raises :class:`RetryExhausted` (cause = the last failure)
    rather than returning a sentinel: the caller must decide loudly.
    """
    schedule = backoff_schedule(retries, base_s, max_s)
    slept: list[float] = []
    attempts = 0
    while True:
        attempts += 1
        try:
            value = fn()
        except tuple(retryable) as e:
            if attempts > retries:
                raise RetryExhausted(attempts, e) from e
            delay = schedule[attempts - 1]
            if on_retry is not None:
                on_retry(attempts, e, delay)
            sleep(delay)
            slept.append(delay)
            continue
        return RetryOutcome(
            value=value, attempts=attempts, backoffs=tuple(slept)
        )
