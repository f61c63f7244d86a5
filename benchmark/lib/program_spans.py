"""What the readers of the program's inner spans share: the kernels launched
inside spans that lie on several threads, the device operations launched
inside spans of a kind, counted, and the idle gaps of the breakdown by the
label it gives them.

The program names a step inside a stage ``<stage>.<step>``, and each trained
stage's backward ``<stage>.backward``, a span on autograd's thread
(``radardistill_tpu_torch/utils/profiler.py``). A program without a span
of the name gives None.
"""

from __future__ import annotations

import bisect
from typing import Optional

from .trace import TraceView, breakdown


def kernel_us_in(view: TraceView, *names: str) -> Optional[float]:
    """Device us of the kernels launched inside the spans ``names``, each on
    the thread of the span it was launched in; None when no such span is
    there."""
    spans = view.spans_named(*names)
    if not spans:
        return None
    return sum(view.kernel_us_launched_in([s for s in spans if s[2] == t], t)
               for t in {s[2] for s in spans})


def idle_us_labelled(view: TraceView, suffix: str) -> Optional[float]:
    """The idle gaps that ``trace.breakdown`` labels with a span whose name
    ends in ``suffix``, summed, in us; None when no such span is there."""
    if not any(n.endswith(suffix) for n in view.spans):
        return None
    gaps = breakdown(view, top=len(view.spans) + 2)["idle_gaps"]
    return sum(s for label, s in gaps if label.endswith(suffix)) * 1e6


def launches_in(view: TraceView, suffix: str) -> Optional[int]:
    """Device operations (kernels, copies, fills) launched on the step's
    thread inside a span of that thread whose name ends in ``suffix``, each
    counted once; None when no such span is there."""
    ivs = sorted((s, e) for n, lst in view.spans.items() if n.endswith(suffix)
                 for s, e, t in lst if t == view.main_thread)
    if not ivs:
        return None
    merged = [list(ivs[0])]
    for s, e in ivs[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    n = 0
    for k in view.kernels:
        if k.launch is None or k.thread != view.main_thread:
            continue
        i = bisect.bisect_right(starts, k.launch) - 1
        n += i >= 0 and k.launch < merged[i][1]
    return n
