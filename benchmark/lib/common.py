"""What both drivers share: the configuration as the program and the
reference take it, the device's clock and memory, and the reference's
numerics."""

from __future__ import annotations

import contextlib
import gc
import os
import resource
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch


def model_cfg(config: Dict[str, Any], config_dict_cls):
    """The configuration's ``MODEL`` as ``config_dict_cls`` (the program's or
    the reference's ``ConfigDict``)."""
    return config_dict_cls(config["MODEL"])


def activations(config: Dict[str, Any]) -> torch.dtype:
    """The dtype the configuration states for the program's activations."""
    return getattr(torch, config["precision"]["activations"])


def dataset_info(config: Dict[str, Any]) -> Dict[str, Any]:
    """grid, voxel size and range as the data layer gives them to the model:
    float32 values floated back, the grid from the range."""
    voxel = [float(v) for v in np.asarray(config["VOXEL_SIZE"], np.float64).astype(np.float32)]
    pc = [float(v) for v in np.asarray(config["POINT_CLOUD_RANGE"], np.float64).astype(np.float32)]
    g = int(round((pc[3] - pc[0]) / voxel[0]))
    return {"grid_size": (g, g), "voxel_size": tuple(voxel), "point_cloud_range": tuple(pc),
            "class_names": tuple(config["CLASS_NAMES"])}


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if torch.device(dev).type == "cuda" else 0


def free(dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def full_float32():
    """The reference's numerics: float32 products without TF32."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


class Clock:
    """Seconds since the process started (``t0``, read first thing in
    ``run.py``), with named marks for the set-up's split."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.marks: Dict[str, float] = {}
        self._last = t0

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.marks[name] = self.marks.get(name, 0.0) + (t - self._last)
        self._last = t


class HostReading:
    """What the host did over a window, read from this process alone: its
    CPU seconds, its voluntary and involuntary context switches, the load
    average at both ends, and the rate in each third of the window (from the
    host times at which the calls returned). Printed beside every run, to
    find what sets one process's level apart from another's."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.cpu0, self.ru0 = _cpu_s(), resource.getrusage(resource.RUSAGE_SELF)
        self.load0 = os.getloadavg()[0]
        self.done: List[float] = []

    def call_done(self) -> None:
        self.done.append(time.perf_counter())

    def summary(self, units_per_call: int) -> Dict[str, Any]:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        window = (self.done[-1] if self.done else time.perf_counter()) - self.t0
        edges = [self.t0 + window * i / 3 for i in range(4)]
        thirds = [units_per_call * sum(a <= t < b for t in self.done) / (b - a)
                  for a, b in zip(edges, edges[1:])] if window > 0 else []
        return {"cpu_s": round(_cpu_s() - self.cpu0, 3),
                "ctx_vol": ru.ru_nvcsw - self.ru0.ru_nvcsw,
                "ctx_invol": ru.ru_nivcsw - self.ru0.ru_nivcsw,
                "load": [round(self.load0, 2), round(os.getloadavg()[0], 2)],
                "cpus": len(os.sched_getaffinity(0)),
                "thirds": [round(r, 3) for r in thirds]}


def _cpu_s() -> float:
    t = os.times()
    return t.user + t.system


def p95(values) -> float:
    """The 95th percentile over all values (``statistics.quantiles``,
    exclusive method, 20 cut points: the 19th); a lone value is its own."""
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]
