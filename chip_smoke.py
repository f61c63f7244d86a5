#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100): ``python3 chip_smoke.py``.

Drives the radar-only serving path of ``radardistill_tpu_torch`` (the shipped
``radar_distill_val.yaml`` at its full 1440² grid, batch 1, random weights
from a seeded ``torch.Generator``) through the entry points a user calls:
``data.synthetic.make_batch`` (scene, collation, ``HostPrecompute``) ->
``build_network`` -> ``PillarNet.forward``. It imports only ``torch`` and
``radardistill_tpu_torch``. Phases:

  1. card: ``torch.cuda.is_available()`` (otherwise exit 2, no result) and the
     card's name and power limit from ``nvidia-smi``;
  2. build: nvcc compiles ``radardistill_tpu_torch/csrc/*.cu`` for sm_90a;
  3. K5 ``expand_rows`` vs its plain version at the conv4 handoff shape
     (table 8193 x 256, 180² cells), bfloat16 and float32: bit-equal;
  4. K2 ``dcn_sample`` vs its plain version at the three CMA sites
     (180²->90², 90²->45², 180²->90², C 256, clamp R = 5): float32 within
     1e-5 x max|ref| (summation order), bfloat16 within 1e-2 x max|ref| (one
     bfloat16 rounding of the same float32 sum);
  5. slice, bfloat16, kernel path: launch counts reset just before one
     forward and read just after (K5 x 1, K2 x 3); outputs finite and of the
     expected shapes, ``as_overflow == 0``; p50 latency over 20 synced runs;
  6. slice, float32 with TF32 off (``torch.backends.cudnn.allow_tf32`` and
     ``torch.backends.cuda.matmul.allow_tf32`` False): the kernel path on the
     card vs the plain path (the same model on the CPU, where every wrapper
     takes its plain version), ``radar_preds`` rel-L2 <= 1e-4 per head.

Kernel times are CUDA-event means over repeated launches on warm inputs,
measured plain, kernel, kernel, plain. Any failed phase exits non-zero. The
line before the last is the kernels record
``{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms"}]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def cuda_ms(torch, fn, iters):
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, kernel_fn, plain_fn, iters=100):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain_fn, iters)
    k1 = cuda_ms(torch, kernel_fn, iters)
    k2 = cuda_ms(torch, kernel_fn, iters)
    p2 = cuda_ms(torch, plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_l2(torch, got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want).clamp_min(1e-30)).item()


def phase_k5(torch, dev):
    from radardistill_tpu_torch.ops.active_site import site_index_grid
    from radardistill_tpu_torch.ops.expand import expand_rows, expand_rows_plain

    gen = torch.Generator().manual_seed(5)
    cap, hw, c = 8192, 180 * 180, 256  # conv4 handoff at the 1440² grid, bs1
    uids = torch.full((1, cap), hw, dtype=torch.int32)
    uids[0, :4096] = torch.sort(torch.randperm(hw, generator=gen)[:4096]).values.to(torch.int32)
    inv = site_index_grid(uids, hw, cap).reshape(-1).to(dev)
    rec = {"max_abs_err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        table = torch.randn(cap + 1, c, generator=gen).to(dev, dtype)
        table[cap] = 0
        got, want = expand_rows(table, inv), expand_rows_plain(table, inv)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"K5 {dtype}: kernel and plain version differ")
        err = (got.float() - want.float()).abs().max().item()
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms, plain_ms = paired_ms(torch, lambda: expand_rows(table, inv),
                                 lambda: expand_rows_plain(table, inv))
        print(f"K5 expand_rows {str(dtype)[6:]} table {tuple(table.shape)} inv {tuple(inv.shape)}: "
              f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if dtype == torch.bfloat16:  # the main path's dtype
            rec["ms"], rec["plain_ms"] = ms, plain_ms
    return rec


def phase_k2(torch, dev):
    from radardistill_tpu_torch.ops.dcn import DCN_MAX_OFFSET, shapes_supported
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample, dcn_sample_plain

    gen = torch.Generator().manual_seed(2)
    sites = ((180, 90), (90, 45), (180, 90))  # the CMA's three downsamples at 1440²
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for h, ho in sites:
        x32 = torch.randn(1, h, h, 256, generator=gen)
        if not shapes_supported(x32.shape, (1, ho, ho, 18), 2, 1, 3):
            raise RuntimeError(f"K2: the shape gate should clamp at {h}²")
        off = (3.0 * torch.randn(1, ho, ho, 18, generator=gen)).to(dev)
        msk = (torch.rand(1, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = x32.to(dev, dtype)
            got = dcn_sample(x, off, msk, 2, 1, 3, DCN_MAX_OFFSET)
            want = dcn_sample_plain(x, off, msk, 2, 1, 3, DCN_MAX_OFFSET)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            print(f"K2 dcn_sample {str(dtype)[6:]} x {tuple(x.shape)} -> {tuple(got.shape)}: "
                  f"max_abs_err {err:.3e} (limit {tol * ref:.3e})")
            if not err <= tol * ref:
                raise RuntimeError(f"K2 {dtype} at {h}²: error {err} over {tol} x {ref}")
            if dtype == torch.bfloat16:
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                ms, plain_ms = paired_ms(
                    torch, lambda: dcn_sample(x, off, msk, 2, 1, 3, DCN_MAX_OFFSET),
                    lambda: dcn_sample_plain(x, off, msk, 2, 1, 3, DCN_MAX_OFFSET), iters=20)
                print(f"K2 dcn_sample bfloat16 at {h}²->{ho}²: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms")
                rec["ms"] += ms
                rec["plain_ms"] += plain_ms
    return rec


def phase_slice_bf16(torch, dev, cfg, info, batch):
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample
    from radardistill_tpu_torch.ops.expand import expand_rows

    model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0)).to(dev)
    bdev = batch_to_torch(batch, dev)
    model(bdev)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()

    expand_rows.launches = 0
    dcn_sample.launches = 0
    out = model(bdev)
    torch.cuda.synchronize()
    launches = {"expand_rows": expand_rows.launches, "dcn_sample": dcn_sample.launches}
    print(f"slice bf16 launches in one forward: {launches}")
    if launches != {"expand_rows": 1, "dcn_sample": 3}:
        raise RuntimeError(f"main path launches {launches}, expected K5 x 1 and K2 x 3")

    g = info["grid_size"][0]
    n_heads = model.head_spec.num_heads
    expect = {"radar_x_conv4": (1, g // 8, g // 8, 256),
              "radar_spatial_features_2d": (1, g // 8, g // 8, 256)}
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(out[k]).all():
            raise RuntimeError(f"{k}: shape {tuple(out[k].shape)} (want {shape}) or not finite")
    for k, v in out["radar_preds"].items():
        if tuple(v.shape[:4]) != (1, g // 8, g // 8, n_heads) or not torch.isfinite(v).all():
            raise RuntimeError(f"radar_preds[{k}]: shape {tuple(v.shape)} or not finite")
    fin = out["final_box_dicts"]
    n_valid = int(fin["valid"].sum())
    if tuple(fin["boxes"].shape) != (1, n_heads * 83, 9) or not torch.isfinite(
            fin["boxes"][fin["valid"]]).all() or n_valid == 0:
        raise RuntimeError(f"final boxes {tuple(fin['boxes'].shape)}, {n_valid} valid")
    if int(out["as_overflow"]) != 0:
        raise RuntimeError(f"as_overflow {int(out['as_overflow'])}")
    print(f"slice bf16 outputs: finite, expected shapes, as_overflow 0, {n_valid} valid boxes")

    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        model(bdev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    p50 = (times[9] + times[10]) / 2 * 1e3
    print(f"slice bf16 forward latency p50 {p50:.3f} ms over 20 synced runs "
          f"(min {times[0] * 1e3:.3f}, max {times[-1] * 1e3:.3f})")
    return launches


def phase_slice_f32(torch, dev, cfg, info, batch):
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("slice f32: TF32 off (cudnn.allow_tf32 = matmul.allow_tf32 = False)")
    model = init_random_(build_network(cfg, info, compute_dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    ref = model(batch_to_torch(batch, "cpu"))  # plain versions
    t_cpu = time.perf_counter() - t0
    got = model.to(dev)(batch_to_torch(batch, dev))  # kernels
    torch.cuda.synchronize()
    errs = {k: rel_l2(torch, got["radar_preds"][k], v) for k, v in ref["radar_preds"].items()}
    errs["radar_x_conv4"] = rel_l2(torch, got["radar_x_conv4"], ref["radar_x_conv4"])
    print(f"slice f32 card (kernels) vs CPU (plain, {t_cpu:.1f} s) rel-L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    bad = {k: v for k, v in errs.items() if not v <= 1e-4}
    if bad or int(got["as_overflow"]) != int(ref["as_overflow"]):
        raise RuntimeError(f"slice f32 kernel path vs plain: {bad}, as_overflow "
                           f"{int(got['as_overflow'])} vs {int(ref['as_overflow'])}")


def main() -> int:
    if not (ROOT / "radardistill_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from radardistill_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    ptxas = cuda_lib.build(ptxas_verbose=True)
    print(f"build: nvcc {' '.join(cuda_lib.NVCC_FLAGS)} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Used" in line:
            print(f"  {line.strip()}")

    from radardistill_tpu_torch.data.synthetic import make_batch

    k5 = phase_k5(torch, dev)
    k2 = phase_k2(torch, dev)
    cfg, info, batch = make_batch()
    launches = phase_slice_bf16(torch, dev, cfg, info, batch)
    phase_slice_f32(torch, dev, cfg, info, batch)

    kernels = [
        {"name": "expand_rows", "route": "cuda", "source": "radardistill_tpu_torch/csrc/expand.cu",
         "replaces": "radardistill_tpu/ops/pallas_expand.py:39",
         "launches": launches["expand_rows"], **k5},
        {"name": "dcn_sample", "route": "cuda",
         "source": "radardistill_tpu_torch/csrc/dcn_sample.cu",
         "replaces": "radardistill_tpu/ops/pallas_dcn.py:213",
         "launches": launches["dcn_sample"], **k2},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
