#!/usr/bin/env python3
"""Where the time goes in one forward, or one train step, of the port on one
CUDA card.

    python3 tools/torch_profile_slice.py [--cfg val|train] [--step] [--trace DIR]
                                         [--set KEY=VALUE ...]

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

``--cfg train --step`` profiles the distillation *train step* instead (the
model, optimizer and step built as ``chip_smoke.py`` builds them): 10
unprofiled synced steps, then 5 steps cut into forward / losses / backward /
optimizer by CUDA events (device-side spans), then one profiled step: device
busy time and its share of the unprofiled p50, kernel time of each of the four
phases and of each stage's forward (the spans of ``PillarNet.forward``), and
of each stage's backward (the program's ``<stage>.backward`` spans, which
tile the backward on autograd's thread), all by the host time and thread of
each kernel's launch. The phases are this tool's spans ``forward``,
``backward`` and ``optimizer`` and the program's own ``losses``
(``compute_training_loss``).

``--set KEY=VALUE`` (repeatable, with ``--cfg train``) overrides a key of the
yaml's ``MODEL.BACKBONE_3D`` before the model is built, as the JAX package's
tools take dotted ``--set`` overrides: another configuration of the teacher,
e.g. ``--set INT8_STAGES=5`` (the int8 chain through every stage) or ``--set
FP_STAGES=5`` (stages 2-5 as fused float links). Values parse as JSON where
they can (``5``, ``true``), else as strings (``static``).

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


def _is_kernel(e, spans):
    """A device event that is a kernel or a copy, not a profiler annotation
    (the spans of this tool, ``Optimizer.step#...``) projected onto the device."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA and e.name not in spans
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Optimizer.", "ProfilerStep")))


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
    kernels = [e for e in events if _is_kernel(e, STAGES)]
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


PHASES = ("forward", "losses", "backward", "optimizer")


def build_step(torch, cfg, info):
    """Model (bfloat16, seeded random weights), optimizer and the pieces of one
    train step, as ``train.train_step.make_train_step`` runs them."""
    from torch.profiler import record_function

    from radardistill_tpu_torch.models import build_network, compute_training_loss
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg

    full, _ = production_cfg(TRAIN_YAML)
    model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0))
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])
    step = make_train_step(model, opt, cfg, *geo)

    def pieces(batch, mark=lambda name: None):
        """The same step, with ``mark(phase)`` called before each phase and a
        profiler span around it (the program's own for the losses)."""
        model.train()
        opt.zero_grad()
        mark("forward")
        with record_function("forward"):
            out = model(batch)
        mark("losses")
        loss, _ = compute_training_loss(cfg, out, *geo)
        mark("backward")
        with record_function("backward"):
            loss.backward()
        mark("optimizer")
        with record_function("optimizer"):
            opt.step()
        mark("end")

    return step, pieces


def profile_step(pieces, batch, trace_dir=None):
    """One profiled train step; kernel time by phase and by stage."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from radardistill_tpu_torch.models.detector import STAGES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pieces(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / "train_step.json"))

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    names = (set(STAGES) | set(PHASES)
             | {e.name for e in cpu if getattr(e, "is_user_annotation", False)})
    host = {e.name: (e.time_range.start, e.time_range.end, e.thread)
            for e in cpu if e.name in names}

    # phases and stages by the host time of each kernel's launch: the runtime
    # call that launched it (cudaLaunchKernel, cudaMemcpyAsync, ...) shares
    # its correlation id. The ops a kernel is linked to would not do: the
    # port's ctypes launches (K1, K5, K2, K3, K4) have no torch op of their
    # own. A stage's backward span lies on autograd's thread, so its kernels
    # are those launched there while it is open
    kernels = [e for e in events if _is_kernel(e, names)]
    launched = {e.id: (e.time_range.start, e.thread) for e in cpu if e.name.startswith("cu")}

    def kernel_ms(span, thread=None):
        if span is None:
            return 0.0
        total = 0.0
        for k in kernels:
            at, on = launched.get(k.id, (-1, None))
            if span[0] <= at < span[1] and thread in (None, on):
                total += k.time_range.end - k.time_range.start
        return total / 1e3

    phase_ms = {p: kernel_ms(host.get(p)) for p in PHASES}
    fwd = {s: kernel_ms(host[s]) for s in STAGES if s in host}
    fwd["outside the stages"] = phase_ms["forward"] - sum(fwd.values())
    n_kernels = sum(1 for k in kernels if k.id in launched)
    bwd = {n[:-len(".backward")]: kernel_ms(span, span[2]) for n, span in host.items()
           if n.endswith(".backward")}
    bwd["outside the stages"] = phase_ms["backward"] - sum(bwd.values())
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": _busy_us([(e.time_range.start, e.time_range.end)
                                        for e in kernels]) / 1e3,
            "n_kernels": len(kernels), "n_kernels_attributed": n_kernels,
            "host_ms": {k: (v[1] - v[0]) / 1e3 for k, v in host.items()},
            "phase_kernel_ms": phase_ms, "forward_kernel_ms": fwd, "backward_kernel_ms": bwd,
            "top_kernels_ms": [(n[:100], t / 1e3) for n, t in top]}


def main_step(torch, args, cfg, info, batch) -> int:
    """``--cfg train --step``: the train step."""
    step, pieces = build_step(torch, cfg, info)
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    p50 = (times[4] + times[5]) / 2
    print(f"train step: unprofiled p50 {p50:.3f} ms over 10 synced steps (min {times[0]:.3f}, "
          f"max {times[-1]:.3f}); {batch['gt_boxes'].shape[0] / p50 * 1e3:.3f} samples/s")

    spans = {p: [] for p in PHASES}
    for _ in range(5):
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        pieces(batch, mark)
        torch.cuda.synchronize()
        for (name, ev), (_, nxt) in zip(marks, marks[1:]):
            spans[name].append(ev.elapsed_time(nxt))
    span_ms = {p: sorted(v)[len(v) // 2] for p, v in spans.items()}
    print("device-side spans by CUDA events, median of 5 steps: "
          + ", ".join(f"{p} {span_ms[p]:.3f} ms" for p in PHASES))

    torch.cuda.reset_peak_memory_stats()
    rec = profile_step(pieces, batch, args.trace)
    rec.update(cfg="train", step=True, unprofiled_p50_ms=p50, event_span_ms=span_ms,
               device_busy_share=rec["device_busy_ms"] / p50,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"profiled step: wall under the profiler {rec['profiled_wall_ms']:.3f} ms, device busy "
          f"{rec['device_busy_ms']:.3f} ms ({100 * rec['device_busy_share']:.1f}% of the "
          f"unprofiled p50), {rec['n_kernels']} kernels ({rec['n_kernels_attributed']} "
          f"with a launch record)")
    for p in PHASES:
        print(f"  {p:10s} host {rec['host_ms'].get(p, 0):.3f} ms, kernels "
              f"{rec['phase_kernel_ms'][p]:.3f} ms")
    for title, table in (("forward", rec["forward_kernel_ms"]),
                         ("backward", rec["backward_kernel_ms"])):
        for name, ms in sorted(table.items(), key=lambda kv: -kv[1]):
            print(f"  {title:8s} {name:24s} kernels {ms:.3f} ms")
    for name, ms in rec["top_kernels_ms"]:
        print(f"  {ms:8.3f} ms  {name}")
    print(json.dumps(rec))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", choices=("val", "train"), default="val",
                    help="val: radar-only serving path; train: the distillation forward")
    ap.add_argument("--step", action="store_true",
                    help="with --cfg train: profile the train step, not the eval forward")
    ap.add_argument("--trace", default=None, help="directory for a chrome trace")
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                    help="with --cfg train: override a key of MODEL.BACKBONE_3D (repeatable)")
    args = ap.parse_args()
    if args.step and args.cfg != "train":
        ap.error("--step needs --cfg train")
    if args.overrides and args.cfg != "train":
        ap.error("--set needs --cfg train (the val path has no teacher)")
    backbone_3d = {}
    for item in args.overrides:
        key, sep, value = item.partition("=")
        if not sep:
            ap.error(f"--set {item}: want KEY=VALUE")
        try:
            backbone_3d[key.rsplit(".", 1)[-1]] = json.loads(value)
        except ValueError:
            backbone_3d[key.rsplit(".", 1)[-1]] = value
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
    cfg, info, batch = make_batch(TRAIN_YAML if args.cfg == "train" else VAL_YAML,
                                  backbone_3d=backbone_3d)
    if backbone_3d:
        print(f"BACKBONE_3D overrides: {backbone_3d}")
    if args.step:
        return main_step(torch, args, cfg, info, batch_to_torch(batch, dev))
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
    rec.update(cfg=args.cfg, backbone_3d=backbone_3d, unprofiled_p50_ms=p50,
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
