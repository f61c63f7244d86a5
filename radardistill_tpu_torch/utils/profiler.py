"""Profiling hooks: a trace of a block of work and a step timer.

Counterpart of ``radardistill_tpu/utils/profiler.py``: ``trace(logdir)``
records the enclosed block with ``torch.profiler`` (CPU and, where there is
one, CUDA activity) and writes it as a Chrome trace
(``trace_<pid>.json``, which TensorBoard's profiler plugin and
``chrome://tracing`` read); ``StepTimer`` is a wall-clock p50 / p90 tracker
that synchronizes the card before it reads the clock. The JAX module's
``cost_analysis`` reads XLA's cost model and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the enclosed block into ``logdir/trace_<pid>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities, record_shapes=False) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(logdir) / f"trace_{os.getpid()}.json"))


class StepTimer:
    """Wall-clock p50 / p90 of the measured blocks; with ``sync`` the card
    finishes its queued work before each reading."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, sync: bool = True):
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)

    def summary(self):
        if not self.times:
            return {}
        t = np.asarray(self.times) * 1e3
        return {"p50_ms": float(np.percentile(t, 50)), "p90_ms": float(np.percentile(t, 90)),
                "mean_ms": float(t.mean()), "n": len(t)}
