"""Named wall-clock phases that wait for the card, and the ``--profile``
trace.

CUDA work is asynchronous: the host returns before the device finishes, so
a phase that launched device work calls ``block_on`` before it ends, which
synchronises the device of every CUDA tensor it is given.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Usage::

        timer = PhaseTimer()
        with timer.phase("knn"):
            result = all_knn(...)
            timer.block_on(result.dists)
        timer.seconds["knn"]
    """

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @staticmethod
    def block_on(*tensors):
        """Wait for the device work producing ``tensors``."""
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str], device=None):
    """A torch.profiler trace of the block, written as a Chrome trace
    (``trace.json``) into ``trace_dir`` when one is given; the card's
    kernels are traced when ``device`` is a CUDA device."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
