"""The isolated worker runner: one unit of work per subprocess (the JAX
package's ``resilience/worker.py``).

Supervision contract: a unit of work (the doctor's probe, a cold-start
child) runs in its own subprocess, so a wedged card can never take down
the caller; the supervisor kills on beat starvation (see
:mod:`~mpi_knn_tpu_torch.resilience.heartbeat`) with wall-clock as the
outer bound only; and a structured result (``ok`` / ``timeout`` /
``crashed`` plus the tails of the captured output) is always returned,
never an exception for a child-side failure. The caller decides what a
dead worker means; the runner only guarantees it finds out.

Child stdout/stderr go to temp files, not pipes: a supervisor blocked on
a pipe read from a wedged child would be the deadlock this module exists
to prevent. Children start in their own session, so the kill escalation
(SIGTERM, grace, SIGKILL) reaches grandchildren (an nvcc the child
started) too.

No torch import: the supervising process never touches the card
(``torch.cuda.is_initialized()`` stays False there; only the child
initializes CUDA).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import tempfile
import time

from mpi_knn_tpu_torch.obs.spans import RECORDER_ENV, read_flight, summarize_flight
from mpi_knn_tpu_torch.resilience.heartbeat import HEARTBEAT_ENV, read_beat

_GRACE_S = 2.0  # SIGTERM → SIGKILL escalation window


@dataclasses.dataclass
class WorkerResult:
    """What the supervisor learns about one unit of work — always
    populated, whatever happened to the child."""

    status: str  # "ok" | "timeout" | "crashed"
    returncode: int | None  # None only if the kill itself failed to reap
    stdout: str
    stderr_tail: str
    beats: int  # last heartbeat seq observed
    last_beat_label: str
    duration_s: float
    reason: str | None = None  # kill reason for "timeout", else None
    # the banked flight record (obs.spans.summarize_flight): span/event
    # counts plus the names of spans left OPEN at death — the incremental
    # JSONL write means this survives a SIGKILLed child. None when the
    # child recorded nothing.
    flight: dict | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


def _read_tail(path: str, tail_bytes: int) -> str:
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if size > tail_bytes:
                f.seek(size - tail_bytes)
            return f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""


def _kill_tree(proc: subprocess.Popen) -> None:
    """SIGTERM the child's session, grace, then SIGKILL — reaping is the
    supervisor's job; a zombie would hold the temp files open."""
    try:
        pgid = os.getpgid(proc.pid)
    except OSError:
        pgid = None

    def _signal(sig):
        try:
            if pgid is not None:
                os.killpg(pgid, sig)
            else:
                proc.send_signal(sig)
        except (OSError, ProcessLookupError):
            pass

    _signal(signal.SIGTERM)
    deadline = time.monotonic() + _GRACE_S
    while proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
    if proc.poll() is None:
        _signal(signal.SIGKILL)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def run_supervised(
    argv: list[str],
    *,
    env: dict | None = None,
    beat_timeout_s: float | None = 240.0,
    wall_timeout_s: float | None = None,
    tail_bytes: int = 8192,
    stdout_bytes: int = 1 << 20,
    poll_s: float = 0.05,
    cwd: str | None = None,
    flight_path: str | None = None,
) -> WorkerResult:
    """Run ``argv`` as a supervised worker subprocess.

    The child gets ``TKNN_HEARTBEAT_FILE`` pointing at a fresh beat file;
    it is killed when no NEW beat sequence has been observed for
    ``beat_timeout_s`` (measured on the supervisor's clock from process
    start or the last observed progress — child clocks are never
    trusted), or when ``wall_timeout_s`` elapses, whichever first. Either
    timeout yields ``status="timeout"`` with the reason recorded; a child
    that exits non-zero by itself is ``"crashed"``; rc 0 is ``"ok"``.
    ``None`` disables the corresponding bound.

    The child also gets ``TKNN_FLIGHT_RECORD`` pointing at a span flight
    file, so anything it traces (serve batches, builds, beats)
    survives its death; the record is read back and banked on
    ``WorkerResult.flight``. Pass ``flight_path`` to keep the raw JSONL
    on disk (a caller-owned path is never deleted); the default temp
    file is summarized and removed.
    """
    child_env = dict(os.environ if env is None else env)
    fd, beat_path = tempfile.mkstemp(prefix="tknn-beat-")
    os.close(fd)
    os.unlink(beat_path)  # the worker's first beat creates it
    child_env[HEARTBEAT_ENV] = beat_path
    keep_flight = flight_path is not None
    if flight_path is None:
        fd, flight_path = tempfile.mkstemp(prefix="tknn-flight-")
        os.close(fd)
    # start every supervision from an empty record (a caller-provided
    # path may hold a previous run's story — stale spans banked as this
    # child's would misdiagnose the kill)
    for p in (flight_path, flight_path + ".1"):
        try:
            os.unlink(p)
        except OSError:
            pass
    child_env[RECORDER_ENV] = flight_path
    out_f = tempfile.NamedTemporaryFile(
        prefix="tknn-worker-out-", delete=False
    )
    err_f = tempfile.NamedTemporaryFile(
        prefix="tknn-worker-err-", delete=False
    )
    t0 = time.monotonic()
    last_progress = t0
    last_seq = 0
    last_label = ""
    reason = None
    try:
        with out_f, err_f:
            proc = subprocess.Popen(
                argv,
                env=child_env,
                stdout=out_f,
                stderr=err_f,
                cwd=cwd,
                start_new_session=True,  # kill escalation reaches grandchildren
            )
            killed = False
            while True:
                rc = proc.poll()
                if rc is not None:
                    break
                now = time.monotonic()
                beat = read_beat(beat_path)
                if beat is not None and beat["seq"] > last_seq:
                    last_seq = beat["seq"]
                    last_label = str(beat.get("label", ""))
                    last_progress = now
                if (
                    beat_timeout_s is not None
                    and beat_timeout_s > 0
                    and now - last_progress > beat_timeout_s
                ):
                    reason = (
                        f"beat starvation: no progress for "
                        f"{beat_timeout_s:g}s (last beat seq={last_seq} "
                        f"{last_label!r})"
                    )
                elif (
                    wall_timeout_s is not None
                    and wall_timeout_s > 0
                    and now - t0 > wall_timeout_s
                ):
                    reason = f"wall timeout: exceeded {wall_timeout_s:g}s"
                if reason is not None:
                    _kill_tree(proc)
                    killed = True
                    break
                time.sleep(poll_s)
        duration = time.monotonic() - t0
        rc = proc.poll()
        # one last beat read: the child may have beaten between the final
        # poll and its exit
        beat = read_beat(beat_path)
        if beat is not None and beat["seq"] > last_seq:
            last_seq = beat["seq"]
            last_label = str(beat.get("label", ""))
        if killed:
            status = "timeout"
        elif rc == 0:
            status = "ok"
        else:
            status = "crashed"
        return WorkerResult(
            status=status,
            returncode=rc,
            stdout=_read_tail(out_f.name, stdout_bytes),
            stderr_tail=_read_tail(err_f.name, tail_bytes),
            beats=last_seq,
            last_beat_label=last_label,
            duration_s=duration,
            reason=reason,
            flight=summarize_flight(read_flight(flight_path)),
        )
    finally:
        doomed = [beat_path, out_f.name, err_f.name]
        if not keep_flight:
            doomed += [flight_path, flight_path + ".1"]
        for p in doomed:
            try:
                os.unlink(p)
            except OSError:
                pass


def python_worker_argv(*module_args: str) -> list[str]:
    """argv for a worker that re-enters this interpreter (``python -m
    mpi_knn_tpu_torch ...`` for the doctor probe, ``-c`` scripts in
    tests): ``sys.executable`` keeps virtual environments honest."""
    return [sys.executable, *module_args]
