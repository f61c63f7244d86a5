#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100): ``python3 chip_smoke.py``.

Drives the three paths of ``radardistill_tpu_torch`` through the entry points
a user calls, ``data.synthetic.make_batch`` (scenes, collation,
``HostPrecompute``) -> ``build_network`` -> ``PillarNet.forward``, and for
training ``train.optim.build_optimizer`` -> ``train.train_step.make_train_step``,
at full width and the full 1440² grid, with random weights from a seeded
``torch.Generator``:

  - the radar-only serving path (``radar_distill_val.yaml``, batch 1);
  - the distillation forward (``radar_distill_train.yaml`` in eval mode, batch
    2, 160 000 lidar points and 3000 radar returns per scene): the frozen
    LiDAR teacher with its static int8 stage 1 beside the radar student;
  - the distillation train step on the same batch: teacher forward without
    gradients, student forward in train mode, targets, head + AFD/PFD losses,
    backward, clip, AdamW with the one-cycle schedules.

It imports only ``torch`` and ``radardistill_tpu_torch``. Phases:

  1. card: ``torch.cuda.is_available()`` (otherwise exit 2, no result) and the
     card's name and power limit from ``nvidia-smi``;
  2. build: one nvcc per ``radardistill_tpu_torch/csrc/*.cu``, all started
     together, for sm_90a; g++ builds the host library at first use;
  3. K5 ``expand_rows`` vs its plain version, bit-equal, at the shapes the two
     paths give it: the conv4 handoff (table 8193 x 256 per sample, 180²
     cells, bfloat16 and float32; batch 1 and 2) and the teacher's entry (int8
     table 2 x 163841 rows of 32 bytes into 2 x 1440² cells);
  4. K2 ``dcn_sample`` vs its plain version at the three CMA sites
     (180²->90², 90²->45², 180²->90², C 256, clamp R = 5), batch 1 and 2:
     float32 within 1e-5 x max|ref| (summation order), bfloat16 within 1e-2 x
     max|ref| (one bfloat16 rounding of the same float32 sum);
  5. K1 ``conv_block`` vs its plain version at the teacher's stage-1 link,
     x (2, 720, 720, 128) int8, kernel (3, 3, 128, 128), 4 mask phases: a
     chain's first link (zero 0, no residual) and a later one (zero 127, with
     residual); every int8 code equal;
  6. val path, bfloat16: launch counts reset just before one forward and read
     just after (K5 x 1, K2 x 3); outputs finite and of the expected shapes,
     ``as_overflow == 0``; p50 latency over 20 synced runs;
  7. val path, float32 with TF32 off: the kernel path on the card vs the plain
     path (the same model on the CPU, where every wrapper takes its plain
     version), ``radar_preds`` rel-L2 <= 1e-4 per head;
  8. distillation forward, bfloat16: counts reset and read the same way
     (K1 x 4, K5 x 2: the teacher's entry and the student's handoff, K2 x 3);
     every output finite, ``as_overflow == 0``; p50 over 10 synced runs;
  9. distillation forward, float32 with TF32 off, kernel path on the card vs
     plain path on the CPU. The plain K1 on a CPU at 720² x 2 is far too slow,
     so this comparison runs at grid 512 (20 000 lidar points and 400 radar
     returns per scene, the full-size densities): teacher features and
     ``lidar_preds`` rel-L2 <= 1e-3 (the int8 chain: a code may flip where the
     card and the CPU round a scale differently), ``radar_preds`` <= 1e-4;
 10. train step, bfloat16, 1440², batch 2: counts reset, one warm step, counts
     read (K1 x 4, K5 x 2, K2 x 3, K3 x 3, K4 x 3 per step), then 10 timed
     steps with one synchronize each; the loss finite on every step,
     ``as_overflow == 0``, every trainable parameter changed and every frozen
     parameter and statistic bit-equal afterwards; p50, samples/s, peak memory;
 11. train step, float32 with TF32 off, grid 512: 2 steps on the card
     (kernels) against the same 2 steps on the CPU (plain versions): loss
     within 1e-4 relative; every element of every trained parameter within
     2.1 x sum(lr) of the CPU's (each side moves an element by at most about
     lr per step); every trained parameter within 5e-3 rel-L2 and
     its update's cosine with the CPU's at least 0.9. Why not tighter: with
     random weights the float32 gradient of this loss carries about 1e-2 of
     summation-order noise (the heatmap gradient nearly cancels in the
     train-mode BatchNorm backward), and Adam's first updates are
     lr x sign(g) per element, so an element whose gradient lies inside the
     noise goes either way (measured: 1.6e-3 rel-L2). A bias that feeds a
     train-mode BatchNorm (and two more leaves, ``ZERO_GRAD``) has a true
     gradient of zero, all noise, and is held to the elementwise bound only.

Kernel times are CUDA-event means over repeated launches on warm inputs,
measured plain, kernel, kernel, plain. ``bound_ms`` is the least time the card
could take: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its operations over the
peak rate of their type (K1: int8 tensor cores, 1979 TOP/s; K2: nine float32
operations per sampled value at 67 TFLOP/s; K3 and K4: 2 x 9 x 4 x C float32
operations per output site; K5 copies and does none). K4's float32 scratch
buffer is not counted: the function reads dsampled, offsets and mask and
writes dx.
``library_ms`` times the one PyTorch call that computes the same function
where there is one (``index_select`` for K5); the port never calls it. In the
kernels record each time is the sum over that kernel's launches in one
train step (K5, K2 and K1 launch as often there as in one distillation
forward), and ``launches`` is the count of one train step. Any failed phase exits non-zero. The line before the
last is the kernels record ``{"kernels": [{"name", "route", "source",
"replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
"bound_by", "library_ms"}]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published dense peaks of one H100 SXM: bytes/s of HBM, int8 operations/s of
# the tensor cores, float32 operations/s outside them (a multiply-add is two
# operations)
PEAK_BYTES = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12


def bound_of(rec):
    """Close a kernel's record: ``bound_ms`` is the larger of its summed
    ``bytes_ms`` and ``ops_ms``, ``bound_by`` says which."""
    bytes_ms, ops_ms = rec.pop("bytes_ms"), rec.pop("ops_ms")
    rec["bound_ms"] = max(bytes_ms, ops_ms)
    rec["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return rec


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


def paired_ms(torch, kernel_fn, plain_fn, iters=100, plain_iters=None):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    p1 = cuda_ms(torch, plain_fn, plain_iters)
    k1 = cuda_ms(torch, kernel_fn, iters)
    k2 = cuda_ms(torch, kernel_fn, iters)
    p2 = cuda_ms(torch, plain_fn, plain_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_l2(torch, got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want).clamp_min(1e-30)).item()


def check_expand(torch, name, table, inv, iters=100):
    """One K5 shape: bit-equal to the plain version; (kernel, plain, library,
    bound) ms. The library call is a row ``index_select``: ``inv`` addresses
    rows of the table only (absent sites point at its zero row)."""
    from radardistill_tpu_torch.ops.expand import expand_rows, expand_rows_plain

    got, want = expand_rows(table, inv), expand_rows_plain(table, inv)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError(f"K5 {name}: kernel and plain version differ")
    idx = inv.long()
    if not torch.equal(torch.index_select(table, 0, idx), want):
        raise RuntimeError(f"K5 {name}: index_select is not the same function here")
    ms, plain_ms = paired_ms(torch, lambda: expand_rows(table, inv),
                             lambda: expand_rows_plain(table, inv), iters)
    lib_ms = cuda_ms(torch, lambda: torch.index_select(table, 0, idx), iters)
    nbytes = (table.numel() + got.numel()) * table.element_size() + inv.numel() * 4
    bound = nbytes / PEAK_BYTES * 1e3
    print(f"K5 expand_rows {name} {str(table.dtype)[6:]} table {tuple(table.shape)} inv "
          f"{tuple(inv.shape)}: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_select {lib_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bytes_ms": bound}


def phase_k5(torch, dev):
    """The conv4 handoff at batch 1 (val path) and 2, and the teacher's entry.
    Returns the sums over the distillation forward's two launches."""
    from radardistill_tpu_torch.ops.active_site import site_index_grid

    gen = torch.Generator().manual_seed(5)

    def site_table(b, cap, hw, n_active):
        uids = torch.full((b, cap), hw, dtype=torch.int32)
        for i in range(b):
            uids[i, :n_active] = torch.sort(
                torch.randperm(hw, generator=gen)[:n_active]).values.to(torch.int32)
        inv = site_index_grid(uids, hw, cap)
        flat = inv + (torch.arange(b, dtype=torch.int32) * (cap + 1))[:, None]
        return flat.reshape(-1).to(dev), uids

    recs = {}
    for b in (1, 2):
        cap, hw, c = 8192, 180 * 180, 256  # conv4 handoff at the 1440² grid
        inv, _ = site_table(b, cap, hw, 4096)
        for dtype in (torch.bfloat16, torch.float32):
            table = torch.randn(b, cap + 1, c, generator=gen).to(dev, dtype)
            table[:, cap] = 0
            rec = check_expand(torch, f"handoff bs{b}", table.reshape(-1, c), inv)
            if dtype == torch.bfloat16:  # the main paths' dtype
                recs[f"handoff{b}"] = rec
    cap, hw = 163840, 1440 * 1440  # the teacher's entry: int8 rows of 32 bytes
    inv, _ = site_table(2, cap, hw, 120000)
    table = torch.randint(-127, 128, (2, cap + 1, 32), generator=gen, dtype=torch.int8).to(dev)
    table[:, cap] = 0
    recs["entry"] = check_expand(torch, "teacher entry bs2", table.reshape(-1, 32), inv, iters=20)
    out = {k: recs["handoff2"][k] + recs["entry"][k]
           for k in ("ms", "plain_ms", "library_ms", "bytes_ms")}
    return bound_of(dict(out, ops_ms=0.0, max_abs_err=0.0))  # a copy: no arithmetic


def phase_k2(torch, dev):
    """The three CMA sites at batch 1 (val path) and 2 (distillation forward);
    returns the batch-2 sums."""
    from radardistill_tpu_torch.ops.dcn import DCN_MAX_OFFSET, shapes_supported
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample, dcn_sample_plain

    gen = torch.Generator().manual_seed(2)
    sites = ((180, 90), (90, 45), (180, 90))  # the CMA's three downsamples at 1440²
    recs = {}
    for b in (1, 2):
        rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
        for h, ho in sites:
            x32 = torch.randn(b, h, h, 256, generator=gen)
            if not shapes_supported(x32.shape, (b, ho, ho, 18), 2, 1, 3):
                raise RuntimeError(f"K2: the shape gate should clamp at {h}²")
            off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
            msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
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
                        lambda: dcn_sample_plain(x, off, msk, 2, 1, 3, DCN_MAX_OFFSET), iters=10)
                    nbytes = ((x.numel() + got.numel()) * x.element_size()
                              + (off.numel() + msk.numel()) * 4)
                    # per output value: four corner multiply-adds and the mask
                    # multiply, in float32 outside the tensor cores
                    bytes_ms = nbytes / PEAK_BYTES * 1e3
                    ops_ms = 9.0 * got.numel() / PEAK_F32_OPS * 1e3
                    print(f"K2 dcn_sample bfloat16 bs{b} at {h}²->{ho}²: kernel {ms:.4f} ms, "
                          f"plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
                          f"{bytes_ms:.4f}, {nbytes / 1e6:.1f} MB; operations {ops_ms:.4f})")
                    rec["ms"] += ms
                    rec["plain_ms"] += plain_ms
                    rec["bytes_ms"] += bytes_ms
                    rec["ops_ms"] += ops_ms
        recs[b] = rec
    return bound_of(dict(recs[2], library_ms=None))


def phase_k34(torch, dev):
    """K3 and K4 at the three CMA sites, batch 2: kernel vs plain, then the
    whole DCN backward against autograd through the plain sampling. Returns
    the two records (sums over the three sites, bfloat16)."""
    from radardistill_tpu_torch.ops.dcn import (DCN_MAX_OFFSET, modulated_deform_conv,
                                                shapes_supported)
    from radardistill_tpu_torch.ops.dcn_grad import (dcn_input_grad, dcn_input_grad_plain,
                                                     dcn_offset_grad, dcn_offset_grad_plain)
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample_plain

    gen = torch.Generator().manual_seed(3)
    b, c = 2, 256
    zero = lambda: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,  # noqa: E731
                    "bytes_ms": 0.0, "ops_ms": 0.0}
    k3, k4 = zero(), zero()

    def check(tag, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if not err <= tol * ref:
            raise RuntimeError(f"{tag}: error {err} over {tol} x {ref}")
        return err, ref

    cases = [(180, 90, DCN_MAX_OFFSET), (90, 45, DCN_MAX_OFFSET), (180, 90, DCN_MAX_OFFSET),
             (64, 32, None)]  # the last: outside the gate, no clamp (float32 only)
    for h, ho, max_offset in cases:
        if shapes_supported((b, h, h, c), (b, ho, ho, 18), 2, 1, 3) != (max_offset is not None):
            raise RuntimeError(f"K3/K4: the shape gate at {h}² is not what this phase assumes")
        x32 = torch.randn(b, h, h, c, generator=gen)
        ds32 = torch.randn(b, ho, ho, 9 * c, generator=gen)
        off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
        msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
        sat = (off.abs() > DCN_MAX_OFFSET).float().mean().item()
        geo = (2, 1, 3, max_offset)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if max_offset is None and dtype != torch.float32:
                continue
            x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
            g18, dm9 = dcn_offset_grad(x, off, ds, msk, *geo)
            dx = dcn_input_grad(ds, off, msk, h, h, *geo)
            g18_p, dm9_p = dcn_offset_grad_plain(x, off, ds, msk, *geo)
            dx_p = dcn_input_grad_plain(ds, off, msk, h, h, *geo)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} bs{b} {h}²->{ho}² clamp {max_offset}"
            e_g, r_g = check(f"K3 g18 {tag}", g18, g18_p, tol)
            e_m, r_m = check(f"K3 dm9 {tag}", dm9, dm9_p, tol)
            e_x, r_x = check(f"K4 dx {tag}", dx, dx_p, tol)
            print(f"K3 dcn_offset_grad {tag} ({100 * sat:.1f}% of offsets beyond the clamp): "
                  f"g18 max_abs_err {e_g:.3e} (limit {tol * r_g:.3e}), dm9 {e_m:.3e} "
                  f"(limit {tol * r_m:.3e}); K4 dcn_input_grad: dx {e_x:.3e} "
                  f"(limit {tol * r_x:.3e})")
            if dtype != torch.bfloat16:
                continue
            k3["max_abs_err"] = max(k3["max_abs_err"], e_g, e_m)
            k4["max_abs_err"] = max(k4["max_abs_err"], e_x)
            ops_ms = 2.0 * 9 * 4 * c * b * ho * ho / PEAK_F32_OPS * 1e3
            small = (off.numel() + msk.numel()) * 4
            for rec, name, kern, plain, nbytes in (
                    (k3, "K3 dcn_offset_grad", lambda: dcn_offset_grad(x, off, ds, msk, *geo),
                     lambda: dcn_offset_grad_plain(x, off, ds, msk, *geo),
                     (x.numel() + ds.numel()) * 2 + small + (g18.numel() + dm9.numel()) * 4),
                    (k4, "K4 dcn_input_grad", lambda: dcn_input_grad(ds, off, msk, h, h, *geo),
                     lambda: dcn_input_grad_plain(ds, off, msk, h, h, *geo),
                     (ds.numel() + dx.numel()) * 2 + small)):
                ms, plain_ms = paired_ms(torch, kern, plain, iters=10)
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                print(f"{name} bfloat16 bs{b} at {h}²->{ho}²: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms (bytes "
                      f"{bytes_ms:.4f}, {nbytes / 1e6:.1f} MB; operations {ops_ms:.4f})")
                rec["ms"] += ms
                rec["plain_ms"] += plain_ms
                rec["bytes_ms"] += bytes_ms
                rec["ops_ms"] += ops_ms

        # the whole backward: the kernels against autograd through the plain sampling
        w = torch.randn(3, 3, c, c, generator=gen) / (9 * c) ** 0.5
        cot = torch.randn(b, ho, ho, c, generator=gen).to(dev)
        leaves = [t.to(dev).requires_grad_() for t in (x32, off.cpu(), msk.cpu(), w)]
        got = torch.autograd.grad(modulated_deform_conv(*leaves, stride=2, padding=1),
                                  leaves, cot)
        y_plain = torch.matmul(dcn_sample_plain(*leaves[:3], 2, 1, 3, max_offset),
                               leaves[3].reshape(9 * c, c))
        want = torch.autograd.grad(y_plain, leaves, cot)
        torch.cuda.synchronize()
        errs = [check(f"DCN backward d{n} at {h}² clamp {max_offset}", g, r, 1e-4)[0]
                for n, g, r in zip(("x", "offset", "mask", "weight"), got, want)]
        if max_offset is not None and not bool(
                (got[1][leaves[1].abs() > max_offset] == 0).all()):
            raise RuntimeError("DCN backward: an offset beyond the clamp got a gradient")
        print(f"DCN backward float32 bs{b} {h}²->{ho}² clamp {max_offset}: kernels vs autograd "
              f"through the plain sampling, max_abs_err dx {errs[0]:.3e}, doffset {errs[1]:.3e}, "
              f"dmask {errs[2]:.3e}, dweight {errs[3]:.3e} (each within 1e-4 x max|ref|)")
    return bound_of(dict(k3, library_ms=None)), bound_of(dict(k4, library_ms=None))


def k1_inputs(torch, dev, b=2, hw=720, c=128, seed=1):
    """Two links at the teacher's stage-1 shape, random codes from a seed: a
    chain's first link (zero 0, no residual) and a later one (zero 127, with
    a residual carry). Scales are chosen so the outputs spread over the whole
    code range and some saturate."""
    gen = torch.Generator().manual_seed(seed)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    mask = (torch.rand(b, hw, hw, 4, generator=gen) < 0.5).to(torch.int8).to(dev)
    per_ch = lambda lo, hi: (torch.rand(c, generator=gen) * (hi - lo) + lo).to(dev)  # noqa: E731
    links = []
    for zero, with_res in ((0.0, False), (127.0, True)):
        links.append(dict(
            xc=(codes(b, hw, hw, c), torch.tensor(4.0, device=dev), zero),
            kq=codes(3, 3, c, c), sw=per_ch(2e-4, 6e-4) / (2.0 if zero else 1.0),
            bias=per_ch(-0.1, 0.1), gt=per_ch(0.75, 1.25), sh=per_ch(-0.5, 0.5),
            bound=torch.tensor(6.0, device=dev), mask_c=mask,
            res=(codes(b, hw, hw, c), torch.tensor(3.0, device=dev), 127.0) if with_res else None))
    return links


def phase_k1(torch, dev):
    from radardistill_tpu_torch.ops.conv_block import (conv_block, conv_block_plain,
                                                       int8_block_conv_v2)

    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    for link in k1_inputs(torch, dev):
        run = lambda block: int8_block_conv_v2(block=block, **link)  # noqa: E731
        got, want = run(conv_block)[0], run(conv_block_plain)[0]
        torch.cuda.synchronize()
        diff = (got.int() - want.int()).abs()
        n_bad, err = int((diff != 0).sum()), int(diff.max())
        spread = [int((want == v).sum()) for v in (-127, 127)]
        xq, kq, res = link["xc"][0], link["kq"], link["res"]
        b, h, w, c = xq.shape
        kh, co = kq.shape[0], kq.shape[3]
        ops = 2.0 * b * h * w * kh * kh * c * co
        nbytes = (xq.numel() + kq.numel() + link["mask_c"].numel() + got.numel()
                  + 8 * co * 4 + (res[0].numel() if res else 0))
        bound_ops, bound_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        ms, plain_ms = paired_ms(torch, lambda: run(conv_block), lambda: run(conv_block_plain),
                                 iters=20, plain_iters=2)
        print(f"K1 conv_block x {tuple(xq.shape)} k {tuple(kq.shape)} zero {link['xc'][2]:.0f} "
              f"res {res is not None}: {n_bad} of {got.numel()} codes differ (max {err}); "
              f"codes at -127/127: {spread}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {max(bound_ops, bound_bytes):.4f} ms (operations {bound_ops:.4f}, "
              f"bytes {bound_bytes:.4f})")
        if n_bad:
            raise RuntimeError(f"K1: kernel and plain version differ in {n_bad} codes")
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
        # one forward runs two links of each kind
        rec["ms"] += 2 * ms
        rec["plain_ms"] += 2 * plain_ms
        rec["bytes_ms"] += 2 * bound_bytes
        rec["ops_ms"] += 2 * bound_ops
    rec["library_ms"] = None
    return bound_of(rec)


def reset_launches():
    """Set every kernel wrapper's count to 0; returns a reader of the counts."""
    from radardistill_tpu_torch.ops.conv_block import conv_block
    from radardistill_tpu_torch.ops.dcn_grad import dcn_input_grad, dcn_offset_grad
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample
    from radardistill_tpu_torch.ops.expand import expand_rows

    fns = {"expand_rows": expand_rows, "dcn_sample": dcn_sample, "conv_block": conv_block,
           "dcn_offset_grad": dcn_offset_grad, "dcn_input_grad": dcn_input_grad}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {k: fn.launches for k, fn in fns.items()}


def all_finite(torch, tree):
    if isinstance(tree, dict):
        return all(all_finite(torch, v) for v in tree.values())
    return not tree.is_floating_point() or bool(torch.isfinite(tree).all())


def phase_forward_bf16(torch, dev, name, cfg, info, batch, expect_launches, runs):
    """One path in bfloat16 on the kernel path: launch counts of one forward,
    finite outputs of the expected shapes, no overflow, p50 of synced runs."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0))
    bdev = batch_to_torch(batch)
    if next(model.parameters()).device != dev or bdev["gt_boxes"].device != dev:
        raise RuntimeError("the entry points did not default to the card")
    model(bdev)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    read = reset_launches()
    out = model(bdev)
    torch.cuda.synchronize()
    launches = read()
    print(f"{name} bf16 launches in one forward: {launches}")
    if launches != expect_launches:
        raise RuntimeError(f"{name}: main path launches {launches}, expected {expect_launches}")

    g, b = info["grid_size"][0], bdev["gt_boxes"].shape[0]
    fmap = (b, g // 8, g // 8, 256)
    expect = {"radar_x_conv4": fmap, "radar_spatial_features_2d": fmap}
    heads = ["radar_preds"]
    if model.has_teacher:
        expect.update({"x_conv4": fmap, "x_conv5": (b, g // 16, g // 16, 256),
                       "spatial_features_2d": fmap, "spatial_features_2d_8x": fmap})
        heads.append("lidar_preds")
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape:
            raise RuntimeError(f"{name} {k}: shape {tuple(out[k].shape)} (want {shape})")
    n_heads = model.head_spec.num_heads
    for head in heads:
        for k, v in out[head].items():
            if tuple(v.shape[:4]) != (b, g // 8, g // 8, n_heads):
                raise RuntimeError(f"{name} {head}[{k}]: shape {tuple(v.shape)}")
    fin = out.pop("final_box_dicts")
    if not all_finite(torch, out):
        raise RuntimeError(f"{name}: an output is not finite")
    n_valid = int(fin["valid"].sum())
    if tuple(fin["boxes"].shape) != (b, n_heads * 83, 9) or not torch.isfinite(
            fin["boxes"][fin["valid"]]).all() or n_valid == 0:
        raise RuntimeError(f"{name}: final boxes {tuple(fin['boxes'].shape)}, {n_valid} valid")
    if int(out["as_overflow"]) != 0:
        raise RuntimeError(f"{name}: as_overflow {int(out['as_overflow'])}")
    print(f"{name} bf16 outputs: finite, expected shapes, as_overflow 0, {n_valid} valid boxes")

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model(bdev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    p50 = (times[(runs - 1) // 2] + times[runs // 2]) / 2 * 1e3
    print(f"{name} bf16 forward latency p50 {p50:.3f} ms over {runs} synced runs "
          f"(min {times[0] * 1e3:.3f}, max {times[-1] * 1e3:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_forward_f32(torch, dev, name, cfg, info, batch, tol):
    """One path in float32 with TF32 off: the kernel path on the card against
    the plain path (the same model on the CPU). ``tol`` maps an output key to
    its rel-L2 limit; a key naming a dict of predictions holds each head."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = init_random_(build_network(cfg, info, compute_dtype=torch.float32, device="cpu"),
                         torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    ref = model(batch_to_torch(batch, "cpu"))  # plain versions
    t_cpu = time.perf_counter() - t0
    read = reset_launches()
    got = model.to(dev)(batch_to_torch(batch, dev))  # kernels
    torch.cuda.synchronize()
    errs = {}
    for key, limit in tol.items():
        if isinstance(ref[key], dict):
            errs.update({f"{key}.{k}": (rel_l2(torch, got[key][k], v), limit)
                         for k, v in ref[key].items()})
        else:
            errs[key] = (rel_l2(torch, got[key], ref[key]), limit)
    print(f"{name} f32 (TF32 off), grid {info['grid_size'][0]}: card (kernels, launches {read()}) "
          f"vs CPU (plain, {t_cpu:.1f} s) rel-L2: "
          + ", ".join(f"{k} {v:.3e}" for k, (v, _) in errs.items()))
    bad = {k: v for k, (v, limit) in errs.items() if not v <= limit}
    if bad or int(got["as_overflow"]) != int(ref["as_overflow"]):
        raise RuntimeError(f"{name} f32 kernel path vs plain: {bad}, as_overflow "
                           f"{int(got['as_overflow'])} vs {int(ref['as_overflow'])}")


def build_trainer(torch, yaml_name, cfg, info, dtype, device):
    """Model with seeded random weights, its optimizer and its train step, as
    a user builds them (1000 total steps, as the reference's benchmark)."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step
    from radardistill_tpu_torch.utils.production import production_cfg

    full, _ = production_cfg(yaml_name, grid=info["grid_size"][0])
    kwargs = {} if device is None else {"device": device}  # None: the entry point's default
    model = init_random_(build_network(cfg, info, compute_dtype=dtype, **kwargs),
                         torch.Generator().manual_seed(0))
    opt, lr_sched = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    step = make_train_step(model, opt, cfg, info["class_names"], info["voxel_size"],
                           info["point_cloud_range"])
    return model, step, lr_sched


def phase_train_bf16(torch, dev, yaml_name, cfg, info, batch, expect_launches, runs):
    """The train step in bfloat16 at full size: launch counts of one step,
    finite losses, no overflow, trained parameters moved and frozen ones
    untouched, p50 of synced steps."""
    from radardistill_tpu_torch.models.detector import batch_to_torch

    model, step, _ = build_trainer(torch, yaml_name, cfg, info, torch.bfloat16, None)
    bdev = batch_to_torch(batch)
    if next(model.parameters()).device != dev or bdev["gt_boxes"].device != dev:
        raise RuntimeError("the entry points did not default to the card")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    torch.cuda.reset_peak_memory_stats()

    read = reset_launches()
    losses = [step(bdev)]  # warm step: cuDNN picks its algorithms
    torch.cuda.synchronize()
    launches = read()
    print(f"train step bf16 launches in one step: {launches}")
    if launches != expect_launches:
        raise RuntimeError(f"train step: launches {launches}, expected {expect_launches}")

    read = reset_launches()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        losses.append(step(bdev))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if read() != {k: runs * v for k, v in expect_launches.items()}:
        raise RuntimeError(f"train step: launches over {runs} steps {read()}")
    vals = [float(m["loss"]) for m in losses]
    print("train step bf16 loss per step: " + ", ".join(f"{v:.4f}" for v in vals))
    last = losses[-1]
    print(f"  last step: rpn_loss {float(last['rpn_loss']):.4f}, distll_loss "
          f"{float(last['distll_loss']):.4f}, grad_norm {float(last['grad_norm']):.4f}, "
          f"dcn_offset_sat {float(last['dcn_offset_sat']):.4f}")
    if not all(v == v and abs(v) != float("inf") for v in vals):
        raise RuntimeError("train step: a loss is not finite")
    if any(int(m["as_overflow"]) != 0 for m in losses):
        raise RuntimeError("train step: as_overflow is not 0")

    after = model.state_dict()
    frozen_scopes = tuple(model.frozen)
    stuck = [n for n in trainable if torch.equal(after[n], before[n])]
    moved = [n for n in after if n not in trainable and not torch.equal(after[n], before[n])
             and (n.split(".", 1)[0] in frozen_scopes or n.endswith("down_bias"))]
    stats = [n for n in after if n not in trainable and n.split(".", 1)[0] not in frozen_scopes
             and not n.endswith("down_bias") and torch.equal(after[n], before[n])]
    if stuck or moved or stats or not all_finite(torch, dict(after)):
        raise RuntimeError(f"train step: trainable parameters unchanged {stuck[:5]}, frozen "
                           f"entries changed {moved[:5]}, BN statistics unchanged {stats[:5]}")
    n_frozen = sum(1 for n in after if n.split(".", 1)[0] in frozen_scopes)
    print(f"train step bf16: {len(trainable)} trainable parameters all changed, "
          f"{n_frozen} frozen parameters and statistics (and the DCN down_bias) bit-equal, "
          f"the student's BN statistics all updated, as_overflow 0")

    times.sort()
    p50 = (times[(runs - 1) // 2] + times[runs // 2]) / 2 * 1e3
    print(f"train step bf16, 1440², bs2: p50 {p50:.3f} ms over {runs} synced steps "
          f"(min {times[0] * 1e3:.3f}, max {times[-1] * 1e3:.3f}); "
          f"{bdev['gt_boxes'].shape[0] / p50 * 1e3:.3f} samples/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


# leaves of the student whose true gradient is zero in train mode: the conv
# biases that feed a BatchNorm directly, and encoder_3_1's last bias and GRN
# beta (a constant shift into agg_2's 1x1 conv, which its BatchNorm removes);
# see phase 11 of the module docstring
ZERO_GRAD = re.compile(
    r"radar_backbone_3d\.conv\d_\d\.conv[12]\.conv\.bias"
    r"|radar_cma\.(decoder_\d\.deconv|agg_\d\.conv\.conv)\.bias"
    r"|radar_cma\.encoder_3_1\.(pwconv2\.bias|grn\.beta)"
    r"|radar_dense_head\.(shared_conv|\w+\.conv_0)\.conv\.bias")


def phase_train_f32(torch, dev, yaml_name, cfg, info, batch, steps=2):
    """``steps`` train steps in float32 with TF32 off: the kernel path on the
    card against the plain path on the CPU, from the same weights."""
    from radardistill_tpu_torch.models.detector import batch_to_torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        model, step, lr_sched = build_trainer(torch, yaml_name, cfg, info, torch.float32, device)
        trained = lambda: {n: p.detach().cpu().clone()  # noqa: E731
                           for n, p in model.named_parameters() if p.requires_grad}
        b = batch_to_torch(batch, device)
        before = trained()
        t0 = time.perf_counter()
        read = reset_launches()
        losses = [float(step(b)["loss"]) for _ in range(steps)]
        runs[name] = (losses, trained(), read(), time.perf_counter() - t0)
    (l_cpu, p_cpu, _, t_cpu), (l_card, p_card, launches, _) = runs["cpu"], runs["card"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    reach = 2.1 * sum(lr_sched(t) for t in range(steps))
    far = max((p_card[n] - p_cpu[n]).abs().max().item() for n in p_cpu)
    judged = [n for n in p_cpu if not ZERO_GRAD.fullmatch(n)]
    errs = {n: rel_l2(torch, p_card[n], p_cpu[n]) for n in judged}

    def cosine(n):
        a, c = ((p[n] - before[n]).flatten().double() for p in (p_card, p_cpu))
        return (a @ c / (a.norm() * c.norm())).item()

    cos = {n: cosine(n) for n in judged}
    worst, least = max(errs, key=errs.get), min(cos, key=cos.get)
    print(f"train step f32 (TF32 off), grid {info['grid_size'][0]}, {steps} steps: card (kernels, "
          f"launches {launches}) vs CPU (plain, {t_cpu:.1f} s): loss {l_card} vs {l_cpu}, "
          f"rel {loss_err:.3e}; over {len(p_cpu)} trained tensors the largest elementwise "
          f"difference is {far:.3e} (limit {reach:.3e}); over the {len(judged)} with a gradient: "
          f"rel-L2 max {errs[worst]:.3e} ({worst}), least cosine of the updates "
          f"{cos[least]:.4f} ({least})")
    if (not loss_err <= 1e-4 or not far <= reach or not errs[worst] <= 5e-3
            or not cos[least] >= 0.9):
        bad = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
        raise RuntimeError(f"train step f32: loss rel {loss_err}, elementwise {far} (limit "
                           f"{reach}), rel-L2 {bad}, cosine {cos[least]} at {least}")


def cudnn_bf16_conv_aside(torch, dev):
    """Labelled aside, not a yardstick of K1 (another type, no epilogue): a
    cuDNN bfloat16 3x3 conv of the link's shape."""
    x = torch.randn(2, 128, 720, 720, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(128, 128, 3, 3, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    ms = cuda_ms(torch, lambda: torch.nn.functional.conv2d(x, w, None, 1, 1), 10)
    print(f"aside: cuDNN bf16 conv2d (2, 720, 720, 128) x (3, 3, 128, 128), no epilogue: {ms:.4f} ms")


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
    print(f"build: nvcc {' '.join(cuda_lib.NVCC_FLAGS)} x {len(cuda_lib.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in ptxas.splitlines():
        if "Used" in line:
            print(f"  {line.strip()}")

    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    k5 = phase_k5(torch, dev)
    k2 = phase_k2(torch, dev)
    k3, k4 = phase_k34(torch, dev)
    k1 = phase_k1(torch, dev)
    cudnn_bf16_conv_aside(torch, dev)

    cfg, info, batch = make_batch()
    none = {"dcn_offset_grad": 0, "dcn_input_grad": 0}  # no backward in a forward
    val_launches = phase_forward_bf16(
        torch, dev, "val path", cfg, info, batch,
        {"expand_rows": 1, "dcn_sample": 3, "conv_block": 0, **none}, 20)
    phase_forward_f32(torch, dev, "val path", cfg, info, batch,
                      {"radar_preds": 1e-4, "radar_x_conv4": 1e-4})
    torch.backends.cudnn.allow_tf32 = True

    t0 = time.perf_counter()
    cfg, info, batch = make_batch(TRAIN_YAML)
    print(f"distillation batch (2 x 160000 lidar points, host precompute): "
          f"{time.perf_counter() - t0:.1f} s on the host")
    fwd_launches = phase_forward_bf16(
        torch, dev, "distillation forward", cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, "conv_block": 4, **none}, 10)
    launches = phase_train_bf16(
        torch, dev, TRAIN_YAML, cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, "conv_block": 4, "dcn_offset_grad": 3,
         "dcn_input_grad": 3}, 10)
    del batch
    torch.cuda.empty_cache()
    cfg, info, batch = make_batch(TRAIN_YAML, grid=512, num_lidar=20000, num_radar=400,
                                  num_boxes=10)
    teacher = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x",
               "lidar_preds")
    phase_forward_f32(torch, dev, "distillation forward", cfg, info, batch,
                      {**{k: 1e-3 for k in teacher}, "radar_preds": 1e-4})
    phase_train_f32(torch, dev, TRAIN_YAML, cfg, info, batch)

    dcn_py = "radardistill_tpu/ops/pallas_dcn.py"
    table = [
        ("expand_rows", "expand.cu", "radardistill_tpu/ops/pallas_expand.py:39", k5),
        ("dcn_sample", "dcn_sample.cu", f"{dcn_py}:213", k2),
        ("conv_block", "conv_block.cu", "radardistill_tpu/ops/pallas_conv_block.py:81", k1),
        ("dcn_offset_grad", "dcn_offset_grad.cu", f"{dcn_py}:283", k3),
        ("dcn_input_grad", "dcn_input_grad.cu", f"{dcn_py}:378", k4),
    ]
    kernels = [{"name": name, "route": "cuda", "source": f"radardistill_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches[name],
                "launches_val": val_launches[name], "launches_forward": fwd_launches[name], **rec}
               for name, src, replaces, rec in table]
    keys = ("name", "route", "source", "replaces", "launches", "launches_val",
            "launches_forward", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
