#!/usr/bin/env python3
"""Where the time goes in one forward of the port on one CUDA card.

    python3 tools/torch_profile_slice.py [--cfg val|train] [--trace DIR]

Builds a path as ``chip_smoke.py`` does (``--cfg val``: the radar-only serving
path, ``radar_distill_val.yaml``, batch 1; ``--cfg train``: the distillation
forward, ``radar_distill_train.yaml`` in eval mode, batch 2, 160 000 lidar
points per scene; both at 1440², bfloat16, seeded random weights, the synthetic
batch of ``radardistill_tpu_torch.data.synthetic``), warms it up, times 10
unprofiled synced forwards, and profiles one forward (``torch.profiler``, CPU
+ CUDA activities). It prints, for each stage span of ``PillarNet.forward``
(``detector.STAGES``), the host time and the device time of the kernels
launched inside it; the union of all kernel
intervals (the device's busy time); the forward's wall time under the
profiler; the top kernels by device time; and one JSON line with all of it.

The profiler adds host time to every op, so the profiled wall is longer than
an unprofiled forward: the device busy share is the busy time over the
unprofiled p50, which the tool prints first. Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _busy_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_forward(model, batch, trace_dir=None):
    """One profiled forward; returns the breakdown dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from radardistill_tpu_torch.models.detector import STAGES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "slice_forward.json"))

    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in STAGES]
    spans = {}
    for e in events:
        if e.name in STAGES:
            kind = "device" if e.device_type == DeviceType.CUDA else "host"
            spans[(e.name, kind)] = (e.time_range.start, e.time_range.end)
    stages = {}
    for name in STAGES:
        h = spans.get((name, "host"))
        d = spans.get((name, "device"))
        if h is None and d is None:  # a stage this configuration does not run
            continue
        inside = [k for k in kernels if d and d[0] <= k.time_range.start < d[1]]
        stages[name] = {
            "host_ms": (h[1] - h[0]) / 1e3 if h else None,
            "device_span_ms": (d[1] - d[0]) / 1e3 if d else None,
            "kernel_ms": sum(k.time_range.end - k.time_range.start for k in inside) / 1e3,
            "n_kernels": len(inside),
        }
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": _busy_us([(e.time_range.start, e.time_range.end)
                                        for e in kernels]) / 1e3,
            "n_kernels": len(kernels), "stages": stages,
            "top_kernels_ms": [(n[:100], t / 1e3) for n, t in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", choices=("val", "train"), default="val",
                    help="val: radar-only serving path; train: the distillation forward")
    ap.add_argument("--trace", default=None, help="directory for a chrome trace")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_slice.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, VAL_YAML

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cfg, info, batch = make_batch(TRAIN_YAML if args.cfg == "train" else VAL_YAML)
    model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16, device=dev),
                         torch.Generator().manual_seed(0))
    batch = batch_to_torch(batch, dev)
    for _ in range(3):
        model(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    p50 = (times[4] + times[5]) / 2
    print(f"{args.cfg}: unprofiled p50 {p50:.3f} ms over 10 synced forwards "
          f"(min {times[0]:.3f}, max {times[-1]:.3f})")
    rec = profile_forward(model, batch, args.trace)
    rec.update(cfg=args.cfg, unprofiled_p50_ms=p50,
               device_busy_share=rec["device_busy_ms"] / p50)
    print(f"profiled forward: wall under the profiler {rec['profiled_wall_ms']:.3f} ms, "
          f"device busy {rec['device_busy_ms']:.3f} ms "
          f"({100 * rec['device_busy_share']:.1f}% of the unprofiled p50), "
          f"{rec['n_kernels']} kernels")
    for name, s in rec["stages"].items():
        print(f"  {name:18s} host {s['host_ms'] or 0:.3f} ms, device span "
              f"{s['device_span_ms'] or 0:.3f} ms, kernels {s['kernel_ms']:.3f} ms "
              f"({s['n_kernels']})")
    for name, ms in rec["top_kernels_ms"]:
        print(f"  {ms:8.3f} ms  {name}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
