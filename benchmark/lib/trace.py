"""What the per-layer metrics read: one profiled window of the timed calls.

:func:`view_of` turns a ``torch.profiler`` run into a :class:`TraceView`:
the device's kernels and copies, each with the host time and thread of the
runtime call that launched it, and the host spans (the program's
``record_function`` stages, torch's ``Optimizer.step#...``, the harness's
``bench.call`` around each timed call). A kernel belongs to a span when the
runtime call that launched it lies inside the span on the host: the
program's ctypes kernels have no torch op of their own, and the backward
launches from autograd's own thread. The arithmetic is the one of the
program's ``tools/torch_profile_slice.py`` (``_busy_us``, ``_is_kernel``),
frozen here.

Each metric's reader (``metrics/<name>.py``) takes the view and returns a
number, or None where its window holds nothing for it to read.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

CALL_SPAN = "bench.call"
# the program's stage spans (``models/detector.py``: ``STAGES``)
PROGRAM_SPANS = frozenset({
    "vfe", "backbone_3d", "backbone_2d", "dense_head", "radar_vfe", "radar_backbone_3d",
    "radar_cma", "radar_neck", "radar_dense_head", "assign_targets", "decode_and_nms"})
# peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 and int8 tensor
# operations, HBM3 bytes
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@dataclass
class Kernel:
    name: str
    start: float  # device, us
    end: float
    launch: Optional[float]  # host time of the runtime call that launched it, us
    thread: Optional[int]  # its host thread


@dataclass
class TraceView:
    kernels: List[Kernel]
    spans: Dict[str, List[Tuple[float, float, int]]]  # host spans by name
    main_thread: int
    calls: int  # timed calls in the traced window
    units: int  # steps or frames in the traced window
    window_us: float
    # the counted work per step's sample or per frame, and the untraced
    # window's seconds per unit (``work``, ``sec_per_unit``)
    cell: Dict[str, Any] = field(default_factory=dict)

    @property
    def busy_us(self) -> float:
        return busy_us((k.start, k.end) for k in self.kernels)

    def spans_named(self, *names: str, prefix: bool = False):
        out = []
        for n, ivs in self.spans.items():
            if n in names or (prefix and n.startswith(names)):
                out += ivs
        return out

    def kernel_us_launched_in(self, spans, thread: Optional[int] = None) -> Optional[float]:
        """Device time of the kernels whose launch lies inside one of
        ``spans`` (and on ``thread``, if given); None when no span is there."""
        if not spans:
            return None
        spans = sorted((s, e) for s, e, _ in spans)
        starts = [s for s, _ in spans]
        total = 0.0
        for k in self.kernels:
            if k.launch is None or (thread is not None and k.thread != thread):
                continue
            i = bisect.bisect_right(starts, k.launch) - 1
            if i >= 0 and k.launch < spans[i][1]:
                total += k.end - k.start
        return total

    def kernel_us_named(self, parts: Iterable[str]) -> float:
        parts = tuple(parts)
        return sum(k.end - k.start for k in self.kernels if any(p in k.name for p in parts))


def _is_kernel(e, span_names) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and e.name not in span_names
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Optimizer.", "ProfilerStep", "bench.")))


def view_of(prof, calls: int, units: int, window_us: float, cell=None) -> TraceView:
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    host_names = {e.name for e in cpu if getattr(e, "is_user_annotation", False)
                  or e.name in PROGRAM_SPANS or e.name.startswith(("Optimizer.step#", "bench."))}
    span_names = host_names | PROGRAM_SPANS
    launched = {e.id: (e.time_range.start, e.thread) for e in cpu
                if e.name.startswith("cu")}
    kernels = []
    for e in events:
        if _is_kernel(e, span_names):
            launch, thread = launched.get(e.id, (None, None))
            kernels.append(Kernel(e.name, e.time_range.start, e.time_range.end, launch, thread))
    spans: Dict[str, List[Tuple[float, float, int]]] = {}
    main_thread = None
    for e in cpu:
        if e.name in host_names:
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end, e.thread))
            if e.name == CALL_SPAN:
                main_thread = e.thread
    return TraceView(kernels, spans, main_thread, calls, units, window_us, dict(cell or {}))


def breakdown(view: TraceView, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the idle gaps between
    kernels summed by the innermost host span open when each began."""
    by_name: Dict[str, float] = {}
    for k in view.kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ivs = sorted((k.start, k.end) for k in view.kernels)
    gaps = []
    end = None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    spans = sorted(((s, e, n) for n, lst in view.spans.items()
                    for s, e, t in lst if t == view.main_thread), key=lambda x: x[0])
    by_host: Dict[str, float] = {}
    for gs, ge in gaps:
        inner = None
        for s, e, n in spans:
            if s > gs:
                break
            if e > gs and (inner is None or s >= inner[0]):
                inner = (s, n)
        label = "between calls" if inner is None else inner[1]
        if label == CALL_SPAN:  # the backward and the losses have no span yet
            label = "in a call, outside the program's spans"
        by_host[label] = by_host.get(label, 0.0) + (ge - gs)
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], t / 1e6] for n, t in ops],
            "idle_gaps": [[n[:120], t / 1e6] for n, t in idle]}
