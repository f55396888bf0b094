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


# host time a trace window keeps before the block and after the card has
# finished it, so no launch sits at either edge
PROFILE_EDGE_S = 0.02
# launches of torch's spin kernel (``torch.cuda._sleep``) that open a trace
# window on a card: a profiler session can lose its first device records
# (seen on an H100 after other sessions in the process), and these take
# the loss; ``obs/kineto.py`` leaves them out of the events
PROFILE_PRIMER = 64


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str], device=None):
    """A torch.profiler trace of the block, written as a Chrome trace
    (``trace.json``) into ``trace_dir`` when one is given; the card's
    kernels are traced when ``device`` is a CUDA device: the window opens
    with ``PROFILE_PRIMER`` spin launches and closes only after the card
    has finished the block's work."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if card:
            for _ in range(PROFILE_PRIMER):
                torch.cuda._sleep(1)
            torch.cuda.synchronize(device)
        time.sleep(PROFILE_EDGE_S)
        yield
        if card:
            torch.cuda.synchronize(device)
        time.sleep(PROFILE_EDGE_S)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
