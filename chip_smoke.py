#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100): ``python3 chip_smoke.py``.

Drives the paths of ``radardistill_tpu_torch`` through the entry points
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
    backward, clip, AdamW with the one-cycle schedules;
  - the distillation forward under two deeper configurations of the teacher,
    built from the same yaml with ``BACKBONE_3D`` overrides: ``INT8_STAGES: 5``
    (the int8 chain through every stage) and ``FP_STAGES: 5`` (stages 2-5 as
    fused float links); and one train step with the ``INT8_STAGES: 5`` teacher.

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
     max|ref| (one bfloat16 rounding of the same float32 sum); then with NaN
     offsets (NaN taps read exactly 0, as in the plain version). K3
     ``dcn_offset_grad`` and K4 ``dcn_input_grad`` at the same three sites,
     batch 2, the same tolerances, offsets 3 x randn (a tenth on the clamp),
     K4 on its tile route and bit-equal over two calls; one unclamped float32
     case at 64² on K4's atomic route; NaN offsets on both routes (NaNs
     compared as equal); the four gradients of ``modulated_deform_conv`` vs
     autograd through ``dcn_sample_plain`` (float32, within 1e-4 x max|ref|).
     Each of K2, K3, K4 timed as the wrapper, as the bare launch, as the
     plain version, and beside them, as an aside that is not the same
     function (NCHW, no mask), ``F.grid_sample`` (K2) and
     ``grid_sampler_2d_backward`` with the mask folded into the cotangent
     (K4: its input gradient, K3: its grid gradient);
  5. K1 ``conv_block`` vs its plain version at the teacher's stage-1 link,
     x (2, 720, 720, 128) int8, kernel (3, 3, 128, 128), 4 mask phases: a
     chain's first link (zero 0, no residual) and a later one (zero 127, with
     residual), on the route the dispatch rule gives it (the ``wgmma`` conv
     mainloop, its counter moved); every int8 code equal, and equal to the
     old resident ``mma.sync`` variant's; the bfloat16 output within 1e-2 x
     max|ref|; the wrapper, the bare launch, the resident variant and the
     plain version timed in one run;
  6. val path, bfloat16: launch counts reset just before one forward and read
     just after (K5 x 1, K2 x 3); outputs finite and of the expected shapes,
     ``as_overflow == 0``; p50 latency over 20 synced runs;
  7. val path, float32 with TF32 off: the kernel path on the card vs the plain
     path (the same model on the CPU, where every wrapper takes its plain
     version), ``radar_preds`` rel-L2 <= 1e-4 per head;
  8. distillation forward, bfloat16: counts reset and read the same way
     (K1 x 4, all four on the ``wgmma`` route; K5 x 2: the teacher's entry and
     the student's handoff, K2 x 3);
     every output finite, ``as_overflow == 0``; p50 over 10 synced runs;
  9. distillation forward, float32 with TF32 off, kernel path on the card vs
     plain path on the CPU. The plain K1 on a CPU at 720² x 2 is far too slow,
     so this comparison runs at grid 512 (20 000 lidar points and 400 radar
     returns per scene, the full-size densities): teacher features and
     ``lidar_preds`` rel-L2 <= 1e-3 (the int8 chain: a code may flip where the
     card and the CPU round a scale differently), ``radar_preds`` <= 1e-4;
 10. train step, bfloat16, 1440², batch 2: counts reset, one warm step, counts
     read (K1 x 4 on ``wgmma``, K5 x 2, K2 x 3, K3 x 3, K4 x 3 per step, all
     three on K4's tile route), then 10 timed
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

Phases 12-19, the deep chains of the teacher:

 12. K1 vs its plain version at every link shape of the ``INT8_STAGES: 5``
     chain beyond stage 1, each on the route the dispatch gives it (printed;
     14 links on ``wgmma``, the five Co-64 links on the resident ``mma.sync``
     variant): every int8 code equal; each timed as the wrapper and on the
     device alone, the ``wgmma`` links also on their ``mma.sync`` variant;
 13. K7 ``chain_conv`` vs its plain version at the conv5 link, pre-padded
     (2, 91, 90, 1024) x (2, 2, 1024, 256) with an all-ones lane mask, and at a
     3x3 link with a per-channel mask and a residual: every code equal, and
     equal to K1's on the same link;
 14. K6 ``conv_block_fp`` vs its plain version at the seven link shapes of the
     ``FP_STAGES: 5`` chain in bfloat16 (within 1e-2 x max|ref|: one bfloat16
     rounding of a differently ordered float32 sum), with and without a
     residual, and in float32 at two of them (within 1e-5 x max|ref|), plus a
     4-phase mask and an odd 45 x 77 grid;
 15. K9 ``conv3x3_wide`` at (2, 180, 180, 256) -> 256, bfloat16 (the TMA +
     ``wgmma`` conv mainloop of ``csrc/conv3x3_wgmma.cu``) and float32 (the
     float link's kernel): forward and both gradients vs autograd through
     ``F.conv2d`` (TF32 off), the same tolerances; y + dx timed as the wrapper
     runs them (weights prepared from the float32 parameter) and as the two
     bare launches on prepared weights and preallocated outputs, whose
     results must equal the wrapper's; ``F.conv2d``'s time as its library
     call;
 16. distillation forward, bfloat16, 1440², ``INT8_STAGES: 5``: K1 x 23
     (18 on ``wgmma``, 5 on ``mma.sync``), K7 x 1, K6 x 0, K5 x 2, K2 x 3;
     finite outputs, p50;
 17. the same with ``INT8_STAGES: 1`` + ``FP_STAGES: 5``: K1 x 4 (``wgmma``), K6 x 19,
     K7 x 0, K5 x 2, K2 x 3;
 18. both configurations in float32 at grid 512, card vs CPU (teacher features
     1e-3, ``radar_preds`` 1e-4; under ``INT8_STAGES: 5`` the teacher's bound
     is 5e-2, see below), and the ``INT8_STAGES: 5`` teacher once more with
     ``CONV_BLOCK_V1=1`` (every link through K7): features bit-equal;
 19. one warm and three timed train steps with the ``INT8_STAGES: 5`` teacher:
     finite losses, K1 x 23 (18 + 5), K3 x 3 and K4 x 3 per step as before.

Phases 20-24, the route without host tables and the last three kernels:

 20. device-built tables at full width, val yaml (batch 1) and train yaml
     (batch 2), from ``make_batch(..., host_precompute=False)``: ``uids``,
     ``slot``, ``count`` of each VFE and every table of ``hp_as`` bit-equal to
     what ``HostPrecompute`` ships for the same scenes; float32 (TF32 off)
     ``radar_preds`` and ``radar_x_conv4`` of the two routes within 1e-4
     rel-L2 (only the cluster means differ, by summation order); bfloat16
     finite, ``as_overflow == 0``, the host route's launch counts; p50 of 10
     synced forwards of each route and of the device build alone;
 21. one train step in float32 through each route from the same weights:
     losses within 1e-4 relative;
 22. ``DENSE_FROM: 3`` against 5 on the raw val batch, float32, one set of
     parameters loaded into both: ``radar_preds`` within 1e-4 rel-L2, peak
     memory of each;
 23. K8 ``gather_rows_windowed`` on the seven tap tables of the batch-2 train
     batch, forward (``nb``) and backward (``inv``), bfloat16: the least
     ``n_win`` without overflow per table, kernel == plain windowed version ==
     unwindowed gather and count 0; one table with ``n_win`` one too small:
     rows and count equal to the plain version's, count > 0;
 24. P2 ``mma_rate`` (two routes, three types) and P1 ``conv_probe`` (three
     modes on two routes, ``mma.sync`` and the ``wgmma`` conv mainloop, five
     shapes): each case within tolerance of its plain version
     (bfloat16 1e-2, TF32 1e-3 x max|ref|, int8 equal), then its rate beside
     the library call's; the ``wgmma`` route also by its launch alone. (They
     run first, right after the build.)

Why 5e-2 under ``INT8_STAGES: 5``: the card and the CPU round the chain's
float32 scales alike, but not every stock op around it (the VFE's sums); one
flipped input code flips a few percent of the 9 x Co codes it reaches in the
next link, and from stage 2 on a code is a coarse step (the BN bound is many
times the activations), so two correct runs drift apart with depth (measured
6e-3 to 1e-2). The kernels themselves are held code for code in phases 12
and 13.

Kernel times are CUDA-event means over repeated launches on warm inputs,
measured plain, kernel, kernel, plain. ``bound_ms`` is the least time the card
could take: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s and its operations over the
peak rate of their type (K1, K7: int8 tensor cores, 1979 TOP/s; K6, K9:
bfloat16 tensor cores, 989 TFLOP/s; K2: nine float32
operations per sampled value at 67 TFLOP/s; K3 and K4: 2 x 9 x 4 x C float32
operations per output site; K5 copies and does none). K4's bound counts what
the function reads (dsampled, offsets, mask) and writes (dx).
``library_ms`` times the one PyTorch call that computes the same function
where there is one (``index_select`` for K5, ``F.conv2d`` for K9); the port
never calls it. In the
kernels record each time is the sum over that kernel's launches in one
train step (K5, K2 and K1 launch as often there as in one distillation
forward), and ``launches`` is the count of one train step; for K7 and K6 it
is one forward of their configuration (``INT8_STAGES: 5``, ``FP_STAGES: 5``),
for K9, which no model calls, one forward and backward of ``conv3x3_wide``;
for K8 one pass over its 14 gathers (times summed), for P1 the ``conv`` mode at
(2, 720, 720, 128) -> 128 on the ``wgmma`` route and for P2 the bfloat16 (2048, 512, 512) product on
the ``wgmma`` route, with ``launches`` counting every case of their tables
(bound of P1, P2: operations at the bfloat16 peak). ``launch_ms`` (K1, K2,
K3, K4, K9 and P1; null for the others) is the time of the bare launches on
prepared inputs and preallocated outputs, ``ms`` that of the wrapper.
``aside_ms`` (K2, K3, K4) is the time of the asides of phase 4, ``k4_route``
the route K4 takes on the main path and ``repeats_bitwise`` whether its dx
repeated bit for bit.
``mma`` names the tensor-core instruction of a kernel that has one (K1: its
stage-1 route). K1's record also carries ``old_route_ms``, the stage-1 links
on the resident ``mma.sync`` variant in the same run, and ``deep_*``, the
sums over the 19 deeper links of ``INT8_STAGES: 5`` on their routes
(``deep_old_route_ms``: all 19 on ``mma.sync``; ``deep_device_*``: their
device time with the host's enqueue hidden, as the wrappers of the links
below 720² cost the host more than the card). Any failed phase exits non-zero. The line before the
last is the kernels record ``{"kernels": [{"name", "route", "mma", "source",
"replaces", "launches", "max_abs_err", "ms", "launch_ms", "plain_ms",
"bound_ms", "bound_by", "library_ms", ...}]}``; the last line is
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
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12

# the link shapes of the teacher's deep chains at the 1440² grid, batch 2:
# (H = W, C, Co, kh, launches without a residual, launches with one)
INT8_DEEP_LINKS = ((720, 128, 64, 2, 1, 0), (720, 64, 64, 3, 2, 2), (360, 256, 128, 2, 1, 0),
                   (360, 128, 128, 3, 2, 2), (180, 512, 256, 2, 1, 0), (180, 256, 256, 3, 2, 2),
                   (90, 256, 256, 3, 2, 2))  # + 4 stage-1 links, + K7 into conv5: 23 + 1
# the tensor-core instruction of each kernel that has one (K1: its route at
# the stage-1 links; the Co-64 links of INT8_STAGES: 5 stay on mma.sync)
MMA_ROUTES = {"conv_block": "wgmma", "conv3x3_wide": "wgmma", "conv_probe": "wgmma",
              "mma_rate": "wgmma", "conv_block_fp": "mma.sync", "chain_conv": "mma.sync"}
# K1's launches in one distillation forward: the four stage-1 links, all on
# the wgmma route
K1_STAGE1 = {"conv_block": 4, "conv_block.wgmma": 4, "conv_block.mma_sync": 0}
# the CMA's backward in one train step: K3 x 3, K4 x 3 on its tile route
DCN_BACKWARD = {"dcn_offset_grad": 3, "dcn_input_grad": 3, "dcn_input_grad.tile": 3}
FP_LINKS = ((720, 64, 64, 3, 2, 2), (360, 256, 128, 2, 1, 0), (360, 128, 128, 3, 2, 2),
            (180, 512, 256, 2, 1, 0), (180, 256, 256, 3, 2, 2), (90, 1024, 256, 2, 1, 0),
            (90, 256, 256, 3, 2, 2))  # 19 launches


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


def device_ms(torch, fn, iters):
    """Mean device time of one ``fn()`` with the host's enqueue hidden: the
    stream sleeps first (about 30 ms) while the host enqueues all ``iters``
    calls, so the events time the device's work back to back. A wrapper whose
    launches cost the host more than its kernels cost the card reads its
    device time here and its host time in :func:`cuda_ms`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(60_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, kernel_fn, plain_fn, iters=100, plain_iters=None, timer=cuda_ms):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    plain_iters = plain_iters or iters
    p1 = timer(torch, plain_fn, plain_iters)
    k1 = timer(torch, kernel_fn, iters)
    k2 = timer(torch, kernel_fn, iters)
    p2 = timer(torch, plain_fn, plain_iters)
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


def nan_equal_within(torch, got, want, tol):
    """(error, limit, ok): NaN exactly where the reference has NaN, the rest
    within tol x max|ref|."""
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    err = (got[~nan] - want[~nan]).abs().max().item()
    lim = tol * want[~nan].abs().max().item()
    return err, lim, bool(torch.equal(torch.isnan(got), nan)) and err <= lim


def with_nans(torch, off):
    """The offsets with a NaN in every 7th dy and every 11th dx (of 18)."""
    off = off.clone()
    flat = off.view(-1, 18)
    flat[::7, 0::2] = float("nan")
    flat[::11, 1::2] = float("nan")
    return off


def grid_of(torch, off, h, ho, max_offset):
    """``F.grid_sample``'s grid (align_corners=True) of the clamped sample
    positions: (B, Ho, 9·Wo, 2), x before y, tap k of site wo at 9·wo + k."""
    b = off.shape[0]
    k = torch.arange(9, device=off.device)
    base = torch.arange(ho, device=off.device) * 2 - 1
    d = off.view(b, ho, ho, 9, 2).clamp(-max_offset, max_offset)
    ph = (base[:, None, None] + (k // 3)).float() + d[..., 0]
    pw = (base[None, :, None] + (k % 3)).float() + d[..., 1]
    g = torch.stack([2 * pw / (h - 1) - 1, 2 * ph / (h - 1) - 1], dim=-1)
    return g.reshape(b, ho, ho * 9, 2).contiguous()


def phase_k2(torch, dev):
    """The three CMA sites at batch 1 (val path) and 2 (distillation forward),
    then NaN offsets; returns the batch-2 sums. Timed: the wrapper, the bare
    launch into a preallocated output, the plain version, and as an aside
    ``F.grid_sample`` of the same samples (NCHW, no mask: not the same
    function)."""
    import torch.nn.functional as F

    from radardistill_tpu_torch.ops import dcn_sample as ds_mod
    from radardistill_tpu_torch.ops.dcn import DCN_MAX_OFFSET, shapes_supported
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample, dcn_sample_plain

    gen = torch.Generator().manual_seed(2)
    sites = ((180, 90), (90, 45), (180, 90))  # the CMA's three downsamples at 1440²
    R = DCN_MAX_OFFSET
    recs = {}
    for b in (1, 2):
        rec = dict.fromkeys(("max_abs_err", "ms", "launch_ms", "plain_ms", "aside_ms",
                             "bytes_ms", "ops_ms"), 0.0)
        for h, ho in sites:
            x32 = torch.randn(b, h, h, 256, generator=gen)
            if not shapes_supported(x32.shape, (b, ho, ho, 18), 2, 1, 3):
                raise RuntimeError(f"K2: the shape gate should clamp at {h}²")
            off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
            msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
                x = x32.to(dev, dtype)
                got = dcn_sample(x, off, msk, 2, 1, 3, R)
                want = dcn_sample_plain(x, off, msk, 2, 1, 3, R)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                print(f"K2 dcn_sample {str(dtype)[6:]} x {tuple(x.shape)} -> {tuple(got.shape)}: "
                      f"max_abs_err {err:.3e} (limit {tol * ref:.3e})")
                if not err <= tol * ref:
                    raise RuntimeError(f"K2 {dtype} at {h}²: error {err} over {tol} x {ref}")
                if dtype != torch.bfloat16:
                    continue
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                out = torch.empty_like(got)
                alone = lambda: ds_mod.launch(x, off, msk, out, 2, 1, R)  # noqa: E731
                alone()
                torch.cuda.synchronize()
                if not torch.equal(out, got):
                    raise RuntimeError("K2: the bare launch differs from the wrapper's result")
                ms, plain_ms = paired_ms(
                    torch, lambda: dcn_sample(x, off, msk, 2, 1, 3, R),
                    lambda: dcn_sample_plain(x, off, msk, 2, 1, 3, R), iters=10)
                launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
                xn = x.permute(0, 3, 1, 2).contiguous()
                grid = grid_of(torch, off, h, ho, R).to(dtype)
                aside_ms = cuda_ms(torch, lambda: F.grid_sample(
                    xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
                nbytes = ((x.numel() + got.numel()) * x.element_size()
                          + (off.numel() + msk.numel()) * 4)
                # per output value: four corner multiply-adds and the mask
                # multiply, in float32 outside the tensor cores
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                ops_ms = 9.0 * got.numel() / PEAK_F32_OPS * 1e3
                print(f"K2 dcn_sample bfloat16 bs{b} at {h}²->{ho}²: wrapper {ms:.4f} ms, launch "
                      f"alone {launch_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, {nbytes / 1e6:.1f} "
                      f"MB; operations {ops_ms:.4f}); aside, not the same function (no mask, "
                      f"NCHW): F.grid_sample {aside_ms:.4f} ms")
                for key, v in (("ms", ms), ("launch_ms", launch_ms), ("plain_ms", plain_ms),
                               ("aside_ms", aside_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    rec[key] += v
        recs[b] = rec

    # NaN offsets: the clamp keeps them, their taps read exactly zeros
    b, h, ho = 2, 90, 45
    x32 = torch.randn(b, h, h, 256, generator=gen)
    off = with_nans(torch, (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev))
    msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
    tap_nan = torch.isnan(off.view(b, ho, ho, 9, 2)).any(-1)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = x32.to(dev, dtype)
        got = dcn_sample(x, off, msk, 2, 1, 3, R)
        want = dcn_sample_plain(x, off, msk, 2, 1, 3, R)
        err, lim, ok = nan_equal_within(torch, got, want, tol)
        zero = bool((got.view(b, ho, ho, 9, 256)[tap_nan] == 0).all())
        print(f"K2 dcn_sample {str(dtype)[6:]} bs{b} {h}² with {int(tap_nan.sum())} NaN taps: "
              f"max_abs_err {err:.3e} (limit {lim:.3e}), NaN taps read 0: {zero}, finite: "
              f"{bool(torch.isfinite(got.float()).all())}")
        if not (ok and zero and torch.isfinite(got.float()).all()):
            raise RuntimeError(f"K2 {dtype}: NaN offsets are not handled as the plain version")
    return bound_of(dict(recs[2], library_ms=None))


def phase_k34(torch, dev):
    """K3 and K4 at the three CMA sites, batch 2: kernel vs plain (K4 on the
    route the dispatch gives it, counted; the tile route twice, bit for bit),
    the bare launches timed beside the wrappers, and as asides the grid
    gradient (K3) and the input gradient (K4) of ``grid_sampler_2d_backward``
    with the mask folded into the cotangent; then NaN offsets on both K4
    routes, and the whole DCN backward against autograd through the plain
    sampling. Returns the two records (sums over the three sites,
    bfloat16)."""
    from radardistill_tpu_torch.ops import dcn_grad
    from radardistill_tpu_torch.ops.dcn import (DCN_MAX_OFFSET, modulated_deform_conv,
                                                shapes_supported)
    from radardistill_tpu_torch.ops.dcn_grad import (dcn_input_grad, dcn_input_grad_plain,
                                                     dcn_offset_grad, dcn_offset_grad_plain,
                                                     input_grad_route)
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample_plain

    gen = torch.Generator().manual_seed(3)
    b, c = 2, 256
    zero = lambda: dict.fromkeys(("max_abs_err", "ms", "launch_ms", "plain_ms",  # noqa: E731
                                  "aside_ms", "bytes_ms", "ops_ms"), 0.0)
    k3, k4 = zero(), zero()
    k4["repeats_bitwise"] = True

    def check(tag, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if not err <= tol * ref:
            raise RuntimeError(f"{tag}: error {err} over {tol} x {ref}")
        return err, ref

    def routed(ds, off, msk, h, geo):
        """dx through the wrapper, and the route it was counted on."""
        before = dict(dcn_input_grad.route_launches)
        dx = dcn_input_grad(ds, off, msk, h, h, *geo)
        moved = [r for r, n in dcn_input_grad.route_launches.items() if n != before[r]]
        if len(moved) != 1 or moved[0] != input_grad_route(geo[3], 2, 1, c, ds.dtype):
            raise RuntimeError(f"K4: counted on {moved}")
        return dx, moved[0]

    cases = [(180, 90, DCN_MAX_OFFSET), (90, 45, DCN_MAX_OFFSET), (180, 90, DCN_MAX_OFFSET),
             (64, 32, None)]  # the last: outside the gate, no clamp (float32 only)
    for h, ho, max_offset in cases:
        if shapes_supported((b, h, h, c), (b, ho, ho, 18), 2, 1, 3) != (max_offset is not None):
            raise RuntimeError(f"K3/K4: the shape gate at {h}² is not what this phase assumes")
        x32 = torch.randn(b, h, h, c, generator=gen)
        ds32 = torch.randn(b, ho, ho, 9 * c, generator=gen)
        off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
        msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
        sat = (off.abs() >= DCN_MAX_OFFSET).float().mean().item()
        geo = (2, 1, 3, max_offset)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if max_offset is None and dtype != torch.float32:
                continue
            x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
            g18, dm9 = dcn_offset_grad(x, off, ds, msk, *geo)
            dx, route = routed(ds, off, msk, h, geo)
            g18_p, dm9_p = dcn_offset_grad_plain(x, off, ds, msk, *geo)
            dx_p = dcn_input_grad_plain(ds, off, msk, h, h, *geo)
            torch.cuda.synchronize()
            tag = f"{str(dtype)[6:]} bs{b} {h}²->{ho}² clamp {max_offset}"
            e_g, r_g = check(f"K3 g18 {tag}", g18, g18_p, tol)
            e_m, r_m = check(f"K3 dm9 {tag}", dm9, dm9_p, tol)
            e_x, r_x = check(f"K4 dx {tag}", dx, dx_p, tol)
            again = torch.equal(dx, dcn_input_grad(ds, off, msk, h, h, *geo))
            if route == "tile":
                k4["repeats_bitwise"] &= again
            print(f"K3 dcn_offset_grad {tag} ({100 * sat:.1f}% of offsets at or beyond the "
                  f"clamp): g18 max_abs_err {e_g:.3e} (limit {tol * r_g:.3e}), dm9 {e_m:.3e} "
                  f"(limit {tol * r_m:.3e}); K4 dcn_input_grad, {route} route: dx {e_x:.3e} "
                  f"(limit {tol * r_x:.3e}), a second call bit-equal: {again}")
            if dtype != torch.bfloat16:
                continue
            if route != "tile":
                raise RuntimeError(f"K4: a clamped CMA site took the {route} route")
            k3["max_abs_err"] = max(k3["max_abs_err"], e_g, e_m)
            k4["max_abs_err"] = max(k4["max_abs_err"], e_x)
            ops_ms = 2.0 * 9 * 4 * c * b * ho * ho / PEAK_F32_OPS * 1e3
            small = (off.numel() + msk.numel()) * 4
            # the bare launches: preallocated outputs, K4's window table made
            g18_o, dm9_o, dx_o = torch.empty_like(g18), torch.empty_like(dm9), torch.empty_like(dx)
            plan = dcn_grad.tile_plan(h, h)
            win = dcn_grad.tile_windows(h, h, ho, ho, *geo[:3], max_offset, *plan[:2], dev)
            k3_alone = lambda: dcn_grad.launch_offset_grad(  # noqa: E731
                x, off, msk, ds, g18_o, dm9_o, 2, 1, max_offset)
            k4_alone = lambda: dcn_grad.launch_tile(  # noqa: E731
                ds, off, msk, win, dx_o, 2, 1, max_offset, plan)
            k3_alone()
            k4_alone()
            torch.cuda.synchronize()
            if not (torch.equal(g18_o, g18) and torch.equal(dm9_o, dm9)
                    and torch.equal(dx_o, dx)):
                raise RuntimeError("K3/K4: the bare launches differ from the wrappers' results")
            # asides, not the same functions: the input and the grid gradient
            # of grid_sample (NCHW) with the mask folded into the cotangent
            xn = x.permute(0, 3, 1, 2).contiguous()
            grid = grid_of(torch, off, h, ho, max_offset).to(dtype)
            cot = (ds.view(b, ho, ho, 9, c) * msk[..., None].to(dtype)).permute(0, 4, 1, 2, 3)
            cot = cot.reshape(b, c, ho, ho * 9).contiguous()
            bwd = torch.ops.aten.grid_sampler_2d_backward
            for rec, name, kern, alone, plain, nbytes, aside in (
                    (k3, "K3 dcn_offset_grad", lambda: dcn_offset_grad(x, off, ds, msk, *geo),
                     k3_alone, lambda: dcn_offset_grad_plain(x, off, ds, msk, *geo),
                     (x.numel() + ds.numel()) * 2 + small + (g18.numel() + dm9.numel()) * 4,
                     lambda: bwd(cot, xn, grid, 0, 0, True, [False, True])),
                    (k4, "K4 dcn_input_grad", lambda: dcn_input_grad(ds, off, msk, h, h, *geo),
                     k4_alone, lambda: dcn_input_grad_plain(ds, off, msk, h, h, *geo),
                     (ds.numel() + dx.numel()) * 2 + small,
                     lambda: bwd(cot, xn, grid, 0, 0, True, [True, False]))):
                ms, plain_ms = paired_ms(torch, kern, plain, iters=10)
                launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
                aside_ms = cuda_ms(torch, aside, 10)
                bytes_ms = nbytes / PEAK_BYTES * 1e3
                print(f"{name} bfloat16 bs{b} at {h}²->{ho}²: wrapper {ms:.4f} ms, launch alone "
                      f"{launch_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, {nbytes / 1e6:.1f} "
                      f"MB; operations {ops_ms:.4f}); aside, not the same function: "
                      f"grid_sampler_2d_backward {aside_ms:.4f} ms")
                for key, v in (("ms", ms), ("launch_ms", launch_ms), ("plain_ms", plain_ms),
                               ("aside_ms", aside_ms), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                    rec[key] += v

        # NaN offsets through K3 and K4 (the same route), NaNs compared as equal
        off_n = with_nans(torch, off)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            if (max_offset is None and dtype != torch.float32) or h == 180:
                continue
            x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
            g18, dm9 = dcn_offset_grad(x, off_n, ds, msk, *geo)
            dx, route = routed(ds, off_n, msk, h, geo)
            g18_p, dm9_p = dcn_offset_grad_plain(x, off_n, ds, msk, *geo)
            dx_p = dcn_input_grad_plain(ds, off_n, msk, h, h, *geo)
            res = [nan_equal_within(torch, g, p, tol)
                   for g, p in ((g18, g18_p), (dm9, dm9_p), (dx, dx_p))]
            print(f"K3/K4 {str(dtype)[6:]} bs{b} {h}² clamp {max_offset} with NaN offsets: "
                  f"g18 / dm9 / dx (K4 {route} route) max_abs_err "
                  + " / ".join(f"{e:.3e} (limit {lim:.3e})" for e, lim, _ in res)
                  + f"; NaNs in g18 {int(torch.isnan(g18_p).sum())}, in dx "
                  f"{int(torch.isnan(dx_p.float()).sum())}, placed as the plain version's")
            if not all(ok for _, _, ok in res):
                raise RuntimeError(f"K3/K4 {dtype} at {h}²: NaN offsets differ from plain")

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
    if not k4["repeats_bitwise"]:
        raise RuntimeError("K4: the tile route did not repeat bit for bit")
    return (bound_of(dict(k3, library_ms=None)),
            bound_of(dict(k4, library_ms=None, k4_route="tile")))


def int8_link(torch, dev, gen, b, h, w, c, co, kh, nph, zero, with_res):
    """Random operands of one int8 link; the weight scale shrinks with C so
    that the output codes spread over the range at every width."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    per_ch = lambda lo, hi: (torch.rand(co, generator=gen) * (hi - lo) + lo).to(dev)  # noqa: E731
    return dict(
        xc=(codes(b, h, w, c), torch.tensor(4.0, device=dev), zero), kq=codes(kh, kh, c, co),
        sw=per_ch(2e-4, 6e-4) * (128.0 / c) / (2.0 if zero else 1.0),
        bias=per_ch(-0.1, 0.1), gt=per_ch(0.75, 1.25), sh=per_ch(-0.5, 0.5),
        bound=torch.tensor(6.0, device=dev),
        mask_c=(torch.rand(b, h, w, nph, generator=gen) < 0.6).to(torch.int8).to(dev),
        res=(codes(b, h, w, co), torch.tensor(3.0, device=dev), 127.0) if with_res else None)


def int8_link_bound(link, mask_numel):
    """(operations ms, bytes ms) of one int8 link."""
    xq, kq, res = link["xc"][0], link["kq"], link["res"]
    b, h, w, c = xq.shape
    kh, co = kq.shape[0], kq.shape[3]
    ops = 2.0 * b * h * w * kh * kh * c * co
    nbytes = (xq.numel() + kq.numel() + mask_numel + b * h * w * co + 8 * co * 4
              + (res[0].numel() if res else 0))
    return ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_k1(torch, dev):
    """K1 at the teacher's stage-1 link on the route the dispatch gives it
    (the ``wgmma`` conv mainloop), both link kinds: every int8 code equal to
    the plain version, and to the old resident ``mma.sync`` variant's on the
    same operands; the bfloat16 output within 1e-2 x max|ref|. Timed: the
    wrapper, the bare launch on prepared operands, the resident variant and
    the plain version, in one run."""
    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.conv_block import (conv_block, conv_block_plain,
                                                       int8_block_conv_v2, link_constants,
                                                       route_of, tap_sums)

    rec = {"max_abs_err": 0.0, "ms": 0.0, "launch_ms": 0.0, "old_route_ms": 0.0,
           "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    gen = torch.Generator().manual_seed(1)
    resident = lambda *a, **k: conv_block(*a, variant="resident", **k)  # noqa: E731
    if route_of(3, 128, 128, 4, torch.int8) != "wgmma":
        raise RuntimeError("K1: the stage-1 link is not dispatched to the wgmma route")
    # the teacher's stage-1 shape: a chain's first link (zero 0, no residual)
    # and a later one (zero 127, with a residual carry)
    for zero, with_res in ((0.0, False), (127.0, True)):
        link = int8_link(torch, dev, gen, 2, 720, 720, 128, 128, 3, 4, zero, with_res)
        run = lambda block, **kw: int8_block_conv_v2(block=block, **link, **kw)  # noqa: E731
        read = reset_launches()
        got = run(conv_block)[0]
        routes = read()
        old, want = run(resident)[0], run(conv_block_plain)[0]
        torch.cuda.synchronize()
        if routes["conv_block.wgmma"] != 1 or routes["conv_block.mma_sync"] != 0:
            raise RuntimeError(f"K1: the stage-1 link ran on {routes}")
        diff = (got.int() - want.int()).abs()
        n_bad, err, n_old = int((diff != 0).sum()), int(diff.max()), int((old != want).sum())
        spread = [int((want == v).sum()) for v in (-127, 127)]
        got_bf = run(conv_block, deq_out=torch.bfloat16)
        want_bf = run(conv_block_plain, deq_out=torch.bfloat16)
        torch.cuda.synchronize()
        err_bf = (got_bf.float() - want_bf.float()).abs().max().item()
        ref_bf = want_bf.float().abs().max().item()
        n_bf = int((got_bf != want_bf).sum())
        # the bare launch on prepared operands and a preallocated output
        xq, kq, res = link["xc"][0], link["kq"], link["res"]
        ab = link_constants(link["xc"], kq, link["sw"], link["bias"], link["gt"], link["sh"],
                            link["bound"], res)[0]
        wk, wsum, out = conv3x3_wgmma.wgmma_taps(kq), tap_sums(kq), torch.empty_like(got)
        alone = lambda: conv3x3_wgmma.launch_link(  # noqa: E731
            xq, wk, ab, link["mask_c"], None if res is None else res[0], wsum, out, -int(zero))
        alone()
        torch.cuda.synchronize()
        if not torch.equal(out, got):
            raise RuntimeError("K1: the bare launch differs from the wrapper's codes")
        bound_ops, bound_bytes = int8_link_bound(link, link["mask_c"].numel())
        ms, old_ms = paired_ms(torch, lambda: run(conv_block), lambda: run(resident), iters=20)
        launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
        plain_ms = cuda_ms(torch, lambda: run(conv_block_plain), 2)
        print(f"K1 conv_block (wgmma) x {tuple(xq.shape)} k {tuple(kq.shape)} zero {zero:.0f} "
              f"res {res is not None}: {n_bad} of {got.numel()} codes differ from plain (max "
              f"{err}), resident mma.sync variant {n_old}; codes at -127/127: {spread}; bfloat16 "
              f"out: max_abs_err {err_bf:.3e} (limit {1e-2 * ref_bf:.3e}), {n_bf} values differ; "
              f"wrapper {ms:.4f} ms, launch alone {launch_ms:.4f} ms "
              f"({bound_ops * PEAK_INT8_OPS / 1e12 / launch_ms:.1f} TOP/s), resident mma.sync "
              f"{old_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bound_ops, bound_bytes):.4f} ms (operations {bound_ops:.4f}, bytes "
              f"{bound_bytes:.4f})")
        if n_bad or n_old or not err_bf <= 1e-2 * ref_bf:
            raise RuntimeError(f"K1: {n_bad} codes differ from plain, {n_old} from the resident "
                               f"variant; bfloat16 error {err_bf}")
        rec["max_abs_err"] = max(rec["max_abs_err"], float(err))
        # one forward runs two links of each kind
        for key, v in (("ms", ms), ("launch_ms", launch_ms), ("old_route_ms", old_ms),
                       ("plain_ms", plain_ms), ("bytes_ms", bound_bytes), ("ops_ms", bound_ops)):
            rec[key] += 2 * v
    rec["library_ms"] = None
    return bound_of(rec)


def phase_k1_deep(torch, dev):
    """K1 at the link shapes of the ``INT8_STAGES: 5`` chain beyond stage 1,
    each on the route the dispatch gives it (``wgmma`` where C and Co are
    multiples of 128, else the ``mma.sync`` kernel, resident or streamed);
    every code equal to the plain version's on that route and on the
    ``mma.sync`` variant (resident where the weight fits, else streamed), and
    the links on ``wgmma`` are timed against that variant too. Returns the
    sums over those 19 launches."""
    from radardistill_tpu_torch.ops.conv_block import (conv_block, conv_block_plain,
                                                       int8_block_conv_v2, resident_fits, route_of)

    gen = torch.Generator().manual_seed(6)
    tot = dict.fromkeys(("ms", "old_route_ms", "device_ms", "device_old_route_ms", "plain_ms",
                         "bound_ms", "wgmma_device_ms", "mma_sync_device_ms"), 0.0)
    for hw, c, co, kh, n_plain, n_res in INT8_DEEP_LINKS:
        route = route_of(kh, c, co, 1, torch.int8)
        old_route = "resident" if resident_fits(kh, c, co, 1) else "streamed"
        old = lambda *a, **k: conv_block(*a, variant=old_route, **k)  # noqa: E731
        for with_res, count in ((False, n_plain), (True, n_res)):
            if not count:
                continue
            link = int8_link(torch, dev, gen, 2, hw, hw, c, co, kh, 1, 127.0, with_res)
            run = lambda block: int8_block_conv_v2(block=block, **link)  # noqa: E731
            read = reset_launches()
            got = run(conv_block)[0]
            moved = read()
            want, got_old = run(conv_block_plain)[0], run(old)[0]
            torch.cuda.synchronize()
            n_bad, n_old = int((got != want).sum()), int((got_old != want).sum())
            ops_ms, bytes_ms = int8_link_bound(link, link["mask_c"].numel())
            # the wrapper as a caller meets it (host-bound below 720²), and its
            # device time; the wgmma links on their mma.sync variant too
            new_fn, old_fn = lambda: run(conv_block), lambda: run(old)  # noqa: E731
            if route == "wgmma":
                ms, old_ms = paired_ms(torch, new_fn, old_fn, iters=10)
                dev_ms, dev_old_ms = paired_ms(torch, new_fn, old_fn, iters=10, timer=device_ms)
            else:
                ms = old_ms = (cuda_ms(torch, new_fn, 10) + cuda_ms(torch, new_fn, 10)) / 2
                dev_ms = dev_old_ms = device_ms(torch, new_fn, 10)
            plain_ms = cuda_ms(torch, lambda: run(conv_block_plain), 2)
            print(f"K1 conv_block ({route}) x (2, {hw}, {hw}, {c}) k ({kh}, {kh}, {c}, {co}) "
                  f"res {with_res}: {n_bad} of {got.numel()} codes differ, {n_old} on the "
                  f"{old_route} mma.sync variant; "
                  f"{100 * float((want > -127).float().mean()):.0f}% of codes above -127; wrapper "
                  f"{ms:.4f} ms, device {dev_ms:.4f} ms ({old_route} mma.sync {old_ms:.4f}, "
                  f"device {dev_old_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
                  f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes "
                  f"{bytes_ms:.4f})")
            if (n_bad or n_old
                    or moved[f"conv_block.{'wgmma' if route == 'wgmma' else 'mma_sync'}"] != 1):
                raise RuntimeError(f"K1 at {hw}² C {c}: {n_bad} codes differ from plain, {n_old} "
                                   f"on the {old_route} variant; launches {moved} (route {route})")
            for key, v in (("ms", ms), ("old_route_ms", old_ms), ("device_ms", dev_ms),
                           ("device_old_route_ms", dev_old_ms), ("plain_ms", plain_ms),
                           ("bound_ms", max(ops_ms, bytes_ms)),
                           (f"{'wgmma' if route == 'wgmma' else 'mma_sync'}_device_ms", dev_ms)):
                tot[key] += count * v
    print(f"K1 over the 19 links of the INT8_STAGES: 5 chain beyond stage 1: wrapper "
          f"{tot['ms']:.4f} ms (all 19 on mma.sync {tot['old_route_ms']:.4f}); device "
          f"{tot['device_ms']:.4f} ms (wgmma links {tot['wgmma_device_ms']:.4f}, mma.sync links "
          f"{tot['mma_sync_device_ms']:.4f}; all 19 on mma.sync {tot['device_old_route_ms']:.4f}), "
          f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return tot


def phase_k7(torch, dev):
    """K7 at the conv5 link of the ``INT8_STAGES: 5`` chain and at a 3x3 link
    with a per-channel mask and a residual: equal to plain, and to K1."""
    from radardistill_tpu_torch.ops.conv_block import conv_block, int8_block_conv_v2
    from radardistill_tpu_torch.ops.int8_conv import (chain_conv, chain_conv_plain,
                                                      int8_block_conv)

    gen = torch.Generator().manual_seed(7)
    rec = None
    for name, (h, c, co, kh, with_res) in (("conv5 link", (90, 1024, 256, 2, False)),
                                           ("3x3 link", (90, 256, 256, 3, True))):
        link = int8_link(torch, dev, gen, 2, h, h, c, co, kh, 1, 127.0, with_res)
        args = {k: v for k, v in link.items() if k != "mask_c"}
        if with_res:  # a mask that differs from channel to channel
            mq = (torch.rand(2, h, h, co, generator=gen) < 0.6).to(torch.int8).to(dev)
        else:
            mq = torch.ones((2, h, h, co), dtype=torch.int8, device=dev)
        run = lambda block: int8_block_conv(mask_q=mq, block=block, **args)[0]  # noqa: E731
        got, want = run(chain_conv), run(chain_conv_plain)
        # K1 on the same link: a lane mask it can take is constant per pixel
        ones = torch.ones((2, h, h, co), dtype=torch.int8, device=dev)
        k7_ones = int8_block_conv(mask_q=ones, **args)[0]
        k1_ones = int8_block_conv_v2(mask_c=ones[..., :1].contiguous(), block=conv_block,
                                     **args)[0]
        torch.cuda.synchronize()
        n_bad, n_k1 = int((got != want).sum()), int((k7_ones != k1_ones).sum())
        ops_ms, bytes_ms = int8_link_bound(link, mq.numel())
        ms, plain_ms = paired_ms(torch, lambda: run(chain_conv), lambda: run(chain_conv_plain),
                                 iters=20, plain_iters=2)
        print(f"K7 chain_conv {name} x (2, {h + kh - 1}, {h}, {c}) pre-padded, k ({kh}, {kh}, "
              f"{c}, {co}), lane mask {tuple(mq.shape)}, res {with_res}: {n_bad} of "
              f"{got.numel()} codes differ from plain, {n_k1} from K1; "
              f"{100 * float((want > -127).float().mean()):.0f}% of codes above -127; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms "
              f"(operations {ops_ms:.4f}, bytes {bytes_ms:.4f})")
        if n_bad or n_k1:
            raise RuntimeError(f"K7 {name}: {n_bad} codes differ from plain, {n_k1} from K1")
        if rec is None:  # the main path's launch
            rec = bound_of({"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "library_ms": None})
    return rec


def fp_link(torch, dev, gen, dtype, b, h, w, c, co, kh, nph, with_res):
    return dict(
        x=torch.randn(b, h, w, c, generator=gen).to(dev, dtype),
        kernel=(torch.randn(kh, kh, c, co, generator=gen) / (kh * kh * c) ** 0.5).to(dev),
        bias=(torch.randn(co, generator=gen) * 0.1).to(dev),
        gt=(torch.rand(co, generator=gen) + 0.5).to(dev),
        sh=(torch.randn(co, generator=gen) * 0.1).to(dev),
        mask_c=(torch.rand(b, h, w, nph, generator=gen) < 0.6).to(torch.int8).to(dev),
        res=torch.randn(b, h, w, co, generator=gen).to(dev, dtype) if with_res else None)


def phase_k6(torch, dev):
    """K6 at the link shapes of the ``FP_STAGES: 5`` chain; returns the sums
    over its 19 launches (bfloat16)."""
    from radardistill_tpu_torch.ops.conv_block import (conv_block_fp, conv_block_fp_plain,
                                                       fp_block_conv)

    gen = torch.Generator().manual_seed(8)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}

    def check(link, tag, tol):
        got = fp_block_conv(block=conv_block_fp, **link)
        want = fp_block_conv(block=conv_block_fp_plain, **link)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        if not err <= tol * ref:
            raise RuntimeError(f"K6 {tag}: error {err} over {tol} x {ref}")
        return err, ref, got

    for hw, c, co, kh, n_plain, n_res in FP_LINKS:
        for with_res, count in ((False, n_plain), (True, n_res)):
            if not count:
                continue
            link = fp_link(torch, dev, gen, torch.bfloat16, 2, hw, hw, c, co, kh, 1, with_res)
            tag = f"bfloat16 x (2, {hw}, {hw}, {c}) k ({kh}, {kh}, {c}, {co}) res {with_res}"
            err, ref, got = check(link, tag, 1e-2)
            ops_ms = 2.0 * got.numel() * kh * kh * c / PEAK_BF16_OPS * 1e3
            nbytes = (2 * (link["x"].numel() + link["kernel"].numel() + got.numel()
                           + (got.numel() if with_res else 0))
                      + link["mask_c"].numel() + 2 * co * 4)
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ms, plain_ms = paired_ms(torch, lambda: fp_block_conv(block=conv_block_fp, **link),
                                     lambda: fp_block_conv(block=conv_block_fp_plain, **link),
                                     iters=10, plain_iters=2)
            print(f"K6 conv_block_fp {tag}: max_abs_err {err:.3e} (limit {1e-2 * ref:.3e}); "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, bytes "
                  f"{bytes_ms:.4f}, {nbytes / 1e6:.1f} MB)")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["ms"] += count * ms
            rec["plain_ms"] += count * plain_ms
            rec["bytes_ms"] += count * bytes_ms
            rec["ops_ms"] += count * ops_ms
    # float32 at two of the shapes, a 4-phase and a 2-phase mask, an odd grid
    for dtype, tol, (b, h, w, c, co, kh, nph, with_res) in (
            (torch.float32, 1e-5, (2, 180, 180, 256, 256, 3, 1, True)),
            (torch.float32, 1e-5, (2, 90, 90, 1024, 256, 2, 1, False)),
            (torch.bfloat16, 1e-2, (2, 90, 90, 256, 256, 3, 4, True)),
            (torch.bfloat16, 1e-2, (1, 45, 77, 128, 128, 3, 2, True)),
            (torch.float32, 1e-5, (1, 45, 77, 128, 128, 3, 2, False))):
        link = fp_link(torch, dev, gen, dtype, b, h, w, c, co, kh, nph, with_res)
        tag = (f"{str(dtype)[6:]} x ({b}, {h}, {w}, {c}) k ({kh}, {kh}, {c}, {co}) nph {nph} "
               f"res {with_res}")
        err, ref, _ = check(link, tag, tol)
        print(f"K6 conv_block_fp {tag}: max_abs_err {err:.3e} (limit {tol * ref:.3e})")
    rec["library_ms"] = None  # no single PyTorch call fuses the conv with this epilogue
    return bound_of(rec)


def phase_k9(torch, dev):
    """K9 at (2, 180, 180, 256) -> 256: forward and both gradients against
    autograd through ``F.conv2d`` (TF32 off). The record is one forward and
    backward in bfloat16: two launches of the kernel (y and dx); the library
    call is ``F.conv2d`` on the same operands, for y and for dx."""
    import torch.nn.functional as F

    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops.wide_conv import (conv3x3_wide, conv3x3_wide_plain, conv_or_dx,
                                                      wgmma_weights)

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    b, hw, c = 2, 180, 256
    rec = None
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = torch.randn(b, hw, hw, c, generator=gen).to(dev, dtype).requires_grad_()
        k = (torch.randn(3, 3, c, c, generator=gen) / (9 * c) ** 0.5).to(dev).requires_grad_()
        ct = torch.randn(b, hw, hw, c, generator=gen).to(dev, dtype)
        conv3x3_wide.launches = 0
        y = conv3x3_wide(x, k)
        got = (y, *torch.autograd.grad(y, (x, k), ct))
        launches = conv3x3_wide.launches
        yr = F.conv2d(x.permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1),
                      padding=1).permute(0, 2, 3, 1)
        want = (yr, *torch.autograd.grad(yr, (x, k), ct))
        torch.cuda.synchronize()
        errs = []
        for name, g, r in zip(("y", "dx", "dW"), got, want):
            err = (g.float() - r.float()).abs().max().item()
            ref = r.float().abs().max().item()
            errs.append(f"{name} {err:.3e} (limit {tol * ref:.3e})")
            if not err <= tol * ref or g.dtype != r.dtype:
                raise RuntimeError(f"K9 {dtype} {name}: error {err} over {tol} x {ref}")
        print(f"K9 conv3x3_wide {str(dtype)[6:]} x (2, {hw}, {hw}, {c}) k (3, 3, {c}, {c}), "
              f"{launches} launches for forward + backward: max_abs_err " + ", ".join(errs))
        if launches != 2:
            raise RuntimeError(f"K9: {launches} launches for one forward and backward, not 2")
        if dtype != torch.bfloat16:
            continue
        # y and dx as the autograd wrapper runs them, from the float32 parameter
        xd, kd = x.detach(), k.detach()
        kt = kd.flip(0, 1).transpose(2, 3)
        kern = lambda: (conv_or_dx(xd, kd), conv_or_dx(ct, kd, backward=True))  # noqa: E731
        plain = lambda: (conv3x3_wide_plain(xd, kd), conv3x3_wide_plain(ct, kt))  # noqa: E731
        # the launches alone: prepared K-major weights, preallocated outputs
        wf, wb = wgmma_weights(kd), wgmma_weights(kd, backward=True)
        yo, dxo = torch.empty_like(xd), torch.empty_like(ct)
        alone = lambda: (conv3x3_wgmma.launch(xd, wf, yo, "conv", padded=False),  # noqa: E731
                         conv3x3_wgmma.launch(ct, wb, dxo, "conv", padded=False, flip=True))
        alone()
        if not (torch.equal(yo, got[0]) and torch.equal(dxo, got[1])):
            raise RuntimeError("K9: the bare launches differ from the wrapper's y and dx")
        xn, cn = (t.permute(0, 3, 1, 2) for t in (xd, ct))
        wn, wtn = (t.to(dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                   for t in (kd, kt))
        ms, plain_ms = paired_ms(torch, kern, plain, iters=20, plain_iters=2)
        launch_ms = (cuda_ms(torch, alone, 20) + cuda_ms(torch, alone, 20)) / 2
        lib_ms = cuda_ms(torch, lambda: (F.conv2d(xn, wn, padding=1),
                                         F.conv2d(cn, wtn, padding=1)), 20)
        ops_ms = 2 * 2.0 * b * hw * hw * 9 * c * c / PEAK_BF16_OPS * 1e3
        bytes_ms = 2 * 2.0 * (2 * xd.numel() + kd.numel()) / PEAK_BYTES * 1e3
        print(f"K9 conv3x3_wide bfloat16, y and dx (TMA + wgmma mainloop): wrapper {ms:.4f} ms, "
              f"launches alone {launch_ms:.4f} ms, plain {plain_ms:.4f} ms, F.conv2d "
              f"{lib_ms:.4f} ms, bound {max(ops_ms, bytes_ms):.4f} ms (operations {ops_ms:.4f}, "
              f"bytes {bytes_ms:.4f}); {ops_ms * PEAK_BF16_OPS / 1e12 / launch_ms:.1f} TFLOP/s "
              "launched alone")
        rec = bound_of({"max_abs_err": max((g.float() - r.float()).abs().max().item()
                                           for g, r in zip(got[:2], want[:2])),
                        "ms": ms, "launch_ms": launch_ms, "plain_ms": plain_ms,
                        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "library_ms": lib_ms})
    torch.backends.cudnn.allow_tf32 = True
    return rec, launches


def reset_launches():
    """Set every kernel wrapper's count to 0; returns a reader of the counts."""
    from radardistill_tpu_torch.ops.conv_block import conv_block, conv_block_fp
    from radardistill_tpu_torch.ops.dcn_grad import dcn_input_grad, dcn_offset_grad
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample
    from radardistill_tpu_torch.ops.expand import expand_rows, gather_rows_windowed
    from radardistill_tpu_torch.ops.int8_conv import chain_conv
    from radardistill_tpu_torch.ops.probes import conv_probe, mma_rate
    from radardistill_tpu_torch.ops.wide_conv import conv3x3_wide

    fns = {"expand_rows": expand_rows, "dcn_sample": dcn_sample, "conv_block": conv_block,
           "dcn_offset_grad": dcn_offset_grad, "dcn_input_grad": dcn_input_grad,
           "chain_conv": chain_conv, "conv_block_fp": conv_block_fp,
           "conv3x3_wide": conv3x3_wide, "gather_rows_windowed": gather_rows_windowed,
           "conv_probe": conv_probe, "mma_rate": mma_rate}
    for fn in fns.values():
        fn.launches = 0
    routes, dx_routes = conv_block.route_launches, dcn_input_grad.route_launches
    for r in (routes, dx_routes):
        for k in r:
            r[k] = 0

    def read():
        # K1 also by route: the wgmma conv mainloop, or the mma.sync kernel
        # (resident and streamed variants); K4 by route: tile or atomic
        return {**{k: fn.launches for k, fn in fns.items()},
                "conv_block.wgmma": routes["wgmma"],
                "conv_block.mma_sync": routes["resident"] + routes["streamed"],
                **{f"dcn_input_grad.{k}": n for k, n in dx_routes.items()}}

    return read


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
    expect_launches = {**dict.fromkeys(launches, 0), **expect_launches}
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


def phase_forward_f32(torch, dev, name, cfg, info, batch, tol, v1_equal=()):
    """One path in float32 with TF32 off: the kernel path on the card against
    the plain path (the same model on the CPU). ``tol`` maps an output key to
    its rel-L2 limit; a key naming a dict of predictions holds each head. The
    keys of ``v1_equal`` must come out bit-equal when the same model runs on
    the card once more with ``CONV_BLOCK_V1=1`` (every int8 link through the
    first-generation kernel)."""
    import os

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
    if v1_equal:
        v2_launches = read()
        os.environ["CONV_BLOCK_V1"] = "1"
        try:
            read = reset_launches()
            got_v1 = model(batch_to_torch(batch, dev))
            torch.cuda.synchronize()
        finally:
            del os.environ["CONV_BLOCK_V1"]
        v1_launches = read()
        differ = [k for k in v1_equal if not torch.equal(got_v1[k], got[k])]
        print(f"{name} f32 with CONV_BLOCK_V1=1: conv_block x {v1_launches['conv_block']}, "
              f"chain_conv x {v1_launches['chain_conv']} (v2 route: "
              f"{v2_launches['conv_block']}, {v2_launches['chain_conv']}); "
              f"{', '.join(v1_equal)} bit-equal to the v2 route's: {not differ}")
        links = v2_launches["conv_block"] + v2_launches["chain_conv"]
        if differ or v1_launches["conv_block"] != 0 or v1_launches["chain_conv"] != links:
            raise RuntimeError(f"{name}: v1 route differs in {differ}, launches {v1_launches}")


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
    expect_launches = {**dict.fromkeys(launches, 0), **expect_launches}
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
          f"{float(last['distll_loss']):.4f}, grad_norm "
          f"{float(step.state.optimizer.grad_norm):.4f}, "
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


def p50_ms(torch, fn, runs):
    """p50 of ``runs`` host-clock times of ``fn()`` + synchronize, in ms."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return (times[(runs - 1) // 2] + times[runs // 2]) / 2 * 1e3


def equal_tree(torch, got, want):
    """Bit-equality of two tables or tuples of tables, after a cast to the
    wider integer type (the host may ship narrower indices)."""
    if isinstance(want, (tuple, list)):
        return len(got) == len(want) and all(equal_tree(torch, g, w) for g, w in zip(got, want))
    if got.dtype != want.dtype:
        got, want = got.long(), want.long()
    return got.shape == want.shape and torch.equal(got, want)


def phase_device_tables(torch, dev, name, cfg, info, host_batch, raw_batch, expect_launches,
                        runs=10):
    """The route with no host tables: the same scenes collated with and without
    ``HostPrecompute`` through one model. Device-built tables bit-equal to the
    host's; float32 outputs of the two routes within 1e-4 rel-L2; bfloat16
    finite, no overflow, the host route's launch counts; p50 of both routes and
    of the device build alone. Returns (launches, device-built tables)."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    if any(k.startswith("hp_") for k in raw_batch):
        raise RuntimeError(f"{name}: the raw batch carries host tables")
    bh, br = batch_to_torch(host_batch), batch_to_torch(raw_batch)
    model = init_random_(build_network(cfg, info, compute_dtype=torch.float32),
                         torch.Generator().manual_seed(0))
    rkey = "radar_points" if "radar_points" in br else "points"
    vfes = [(model.radar_vfe, rkey, "hp_radar")]
    if model.has_teacher:
        vfes.append((model.vfe, "points", "hp_lidar"))

    def build():
        built = {}
        for vfe, key, hp in vfes:
            built[hp] = vfe.sort_and_compact(br[key], br[f"{key}_mask"])[1]
        built["hp_as"] = model.radar_backbone_3d.build_tables(built["hp_radar"]["uids"])
        return built

    with torch.no_grad():
        built = build()
        torch.cuda.synchronize()
        checked = []
        for _, _, hp in vfes:
            for k in ("uids", "slot", "count"):
                if not equal_tree(torch, built[hp][k], bh[hp][k]):
                    raise RuntimeError(f"{name}: device-built {hp}.{k} differs from the host's")
                checked.append(f"{hp}.{k}")
        if set(built["hp_as"]) != set(bh["hp_as"]):
            raise RuntimeError(f"{name}: device tables {sorted(built['hp_as'])}, host tables "
                               f"{sorted(bh['hp_as'])}")
        for k, want in bh["hp_as"].items():
            if not equal_tree(torch, built["hp_as"][k], want):
                raise RuntimeError(f"{name}: device-built hp_as.{k} differs from the host's")
            checked.append(k)
        build_ms = p50_ms(torch, build, runs)
        print(f"{name} device-built tables bit-equal to the host's: {', '.join(checked)}; the "
              f"build alone p50 {build_ms:.3f} ms over {runs} synced runs")

        # float32, TF32 off: the two routes differ only in the cluster means
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        out_h, out_d = model(bh), model(br)
        torch.cuda.synchronize()
        errs = {f"radar_preds.{k}": rel_l2(torch, out_d["radar_preds"][k], v)
                for k, v in out_h["radar_preds"].items()}
        errs["radar_x_conv4"] = rel_l2(torch, out_d["radar_x_conv4"], out_h["radar_x_conv4"])
        print(f"{name} f32 (TF32 off), device route vs host route on the card, rel-L2: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        bad = {k: v for k, v in errs.items() if not v <= 1e-4}
        if bad or int(out_d["as_overflow"]) != int(out_h["as_overflow"]):
            raise RuntimeError(f"{name}: device route vs host route {bad}, as_overflow "
                               f"{int(out_d['as_overflow'])} vs {int(out_h['as_overflow'])}")
        torch.backends.cudnn.allow_tf32 = True
        del out_h, out_d

        model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                             torch.Generator().manual_seed(0))
        model(br)  # warm-up
        read = reset_launches()
        out = model(br)
        torch.cuda.synchronize()
        launches = read()
        want = {**dict.fromkeys(launches, 0), **expect_launches}
        fin = out.pop("final_box_dicts")
        if launches != want or not all_finite(torch, out) or int(out["as_overflow"]) != 0 \
                or int(fin["valid"].sum()) == 0:
            raise RuntimeError(f"{name} device route bf16: launches {launches} (want {want}), "
                               f"finite {all_finite(torch, out)}, as_overflow "
                               f"{int(out['as_overflow'])}, {int(fin['valid'].sum())} boxes")
        t_host = p50_ms(torch, lambda: model(bh), runs)
        t_dev = p50_ms(torch, lambda: model(br), runs)
        t_host2 = p50_ms(torch, lambda: model(bh), runs)
        print(f"{name} bf16: launches {launches}, finite, as_overflow 0; forward p50 over {runs} "
              f"synced runs: host tables {t_host:.3f} ms, device-built {t_dev:.3f} ms, host "
              f"tables again {t_host2:.3f} ms")
    return launches, built


def phase_device_train(torch, dev, yaml_name, cfg, info, host_batch, raw_batch):
    """One train step in float32 (TF32 off) through each route from the same
    weights: the losses agree to 1e-4 relative."""
    from radardistill_tpu_torch.models.detector import batch_to_torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    losses = {}
    for route, batch in (("host", host_batch), ("device", raw_batch)):
        model, step, _ = build_trainer(torch, yaml_name, cfg, info, torch.float32, None)
        metrics = step(batch_to_torch(batch))
        torch.cuda.synchronize()
        losses[route] = float(metrics["loss"])
        if int(metrics["as_overflow"]) != 0:
            raise RuntimeError(f"train step, {route} route: as_overflow {metrics['as_overflow']}")
        del model, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    rel = abs(losses["device"] - losses["host"]) / abs(losses["host"])
    print(f"train step f32 (TF32 off), 1440², bs2, one step from the same weights: loss "
          f"{losses['device']:.6f} through the device-built tables, {losses['host']:.6f} through "
          f"the host's, rel {rel:.3e} (limit 1e-4)")
    if not rel <= 1e-4 or losses["device"] != losses["device"]:
        raise RuntimeError(f"train step: device route loss {losses['device']} vs host route "
                           f"{losses['host']}")


def phase_dense_from(torch, dev, yaml_name, dense_from=3):
    """``DENSE_FROM: dense_from`` against the shipped 5 on one raw val batch in
    float32 (TF32 off): the table stages and the masked-dense stages are the
    same function, and share their parameters."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, peaks = {}, {}
    state = None
    for df in (5, dense_from):
        cfg, info, batch = make_batch(yaml_name, radar_backbone_3d={"DENSE_FROM": df},
                                      host_precompute=False)
        model = build_network(cfg, info, compute_dtype=torch.float32)
        if state is None:
            state = init_random_(model, torch.Generator().manual_seed(0)).state_dict()
        else:
            model.load_state_dict(state, strict=True)
        b = batch_to_torch(batch)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            outs[df] = model(b)
        torch.cuda.synchronize()
        peaks[df] = torch.cuda.max_memory_allocated() / 2**30
    torch.backends.cudnn.allow_tf32 = True
    errs = {k: rel_l2(torch, outs[dense_from]["radar_preds"][k], v)
            for k, v in outs[5]["radar_preds"].items()}
    print(f"val path f32 (TF32 off), 1440², DENSE_FROM {dense_from} vs 5 (same parameters, "
          f"device-built tables), radar_preds rel-L2: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; peak device memory {peaks[dense_from]:.2f} GiB vs {peaks[5]:.2f} GiB")
    bad = {k: v for k, v in errs.items() if not v <= 1e-4}
    if bad or int(outs[dense_from]["as_overflow"]) != 0:
        raise RuntimeError(f"DENSE_FROM {dense_from} vs 5: {bad}")


# input channels of the conv that reads each tap table
TAP_CHANNELS = {"tap1": 32, "dtap2": 32, "tap2": 64, "dtap3": 64, "tap3": 128, "dtap4": 128,
                "tap4": 256}


def phase_k8(torch, dev, tables):
    """K8 on the student's tap tables of the bs2 train batch, as the
    active-site convs would use it: forward (rows of the feature table at
    ``nb``) and backward (rows of the cotangent at ``inv``), bfloat16. Per
    table the least window without overflow, then kernel == plain windowed ==
    unwindowed gather and count 0; one table with the window one too small.
    Returns the record summed over the 14 gathers."""
    from radardistill_tpu_torch.ops.expand import (gather_rows_windowed,
                                                   gather_rows_windowed_plain, window_overflow)

    gen = torch.Generator().manual_seed(18)
    rec = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
           "ops_ms": 0.0}
    cases, small = [], None
    for name, c in TAP_CHANNELS.items():
        nb, _, inv, _ = tables[name]
        b, k, cap_out = nb.shape
        cap_in = inv.shape[2]
        fwd_idx = (nb + (torch.arange(b, device=dev, dtype=torch.int32) * cap_in)[:, None, None])
        seg = (torch.arange(b * k, device=dev, dtype=torch.int32) * cap_out).reshape(b, k, 1)
        for direction, idx, rows in (("forward", fwd_idx, b * cap_in),
                                     ("backward", inv + seg, b * k * cap_out)):
            idx = idx.reshape(-1).to(torch.int32).contiguous()
            table = torch.randn(rows, c, generator=gen).to(dev, torch.bfloat16)
            n_win = next(n for n in range(1, rows // 512 + 2)
                         if int(window_overflow(idx, rows, n)) == 0)
            got, over = gather_rows_windowed(table, idx, n_win)
            want, over_p = gather_rows_windowed_plain(table, idx, n_win)
            lib = torch.index_select(table, 0, idx.long())  # no window: every idx is a row
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, lib)) or int(over) or int(over_p):
                raise RuntimeError(f"K8 {name} {direction}: kernel, plain and unwindowed gather "
                                   f"differ at n_win {n_win} (counts {int(over)}, {int(over_p)})")
            cases.append((table, idx, n_win))
            if small is None and n_win > 1:
                small = (name, direction, table, idx, n_win - 1)
            ms, plain_ms = paired_ms(
                torch, lambda: gather_rows_windowed(table, idx, n_win),
                lambda: gather_rows_windowed_plain(table, idx, n_win), iters=20)
            idx64 = idx.long()
            lib_ms = cuda_ms(torch, lambda: torch.index_select(table, 0, idx64), 20)
            # idx and the table read once (no more of it than the rows asked
            # for), the rows written once
            nbytes = (idx.numel() * 4 + got.numel() * 2
                      + min(table.numel(), got.numel()) * 2)
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            print(f"K8 gather_rows_windowed {name} {direction}: table ({rows}, {c}) bf16, idx "
                  f"({idx.numel()},), least n_win {n_win}: kernel == plain == unwindowed gather, "
                  f"overflow 0; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select (no "
                  f"window) {lib_ms:.4f} ms, bound {bytes_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bytes_ms", bytes_ms)):
                rec[key] += v
    if small is None:
        raise RuntimeError("K8: no tap table needs a window above one block")
    name, direction, table, idx, n_win = small
    got, over = gather_rows_windowed(table, idx, n_win)
    want, over_p = gather_rows_windowed_plain(table, idx, n_win)
    torch.cuda.synchronize()
    zeroed = int((got == 0).all(dim=1).sum())
    print(f"K8 {name} {direction} with n_win {n_win}, one too small: kernel rows == plain rows "
          f"{torch.equal(got, want)}, {zeroed} zero rows, overflow count kernel {int(over)}, "
          f"plain {int(over_p)}")
    if not torch.equal(got, want) or int(over) != int(over_p) or int(over) <= 0:
        raise RuntimeError("K8: the too-small window differs from the plain version")
    read = reset_launches()
    for table, idx, n_win in cases:
        gather_rows_windowed(table, idx, n_win)
    torch.cuda.synchronize()
    return bound_of(rec), read()["gather_rows_windowed"]


def phase_probes(torch, dev):
    """P2 then P1: every case against its plain version, then its rate. The
    records of the kernels line: the bfloat16 (2048, 512, 512) product on the
    ``wgmma`` route, and the ``conv`` mode at (2, 720, 720, 128) -> 128 on the
    ``wgmma`` route (the TMA + ``wgmma`` conv mainloop)."""
    from radardistill_tpu_torch.ops.probe_bench import conv_probe_table, mma_rate_table

    read = reset_launches()
    rates = mma_rate_table(dev, target_ops=4e11)
    convs = conv_probe_table(dev, iters=3)
    launches = read()
    p2 = next(r for r in rates if r["shape"] == (2048, 512, 512) and r["type"] == "bfloat16"
              and r["route"] == "wgmma")
    p1 = next(r for r in convs if r["shape"] == (2, 720, 720, 128, 128) and r["mode"] == "conv"
              and r["route"] == "wgmma")
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")
    return (bound_of({"launch_ms": p1["launch_ms"], **{k: p1[k] for k in keys}}),
            launches["conv_probe"],
            bound_of({k: p2[k] for k in keys}), launches["mma_rate"])


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
    t_start = time.perf_counter()
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
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, VAL_YAML

    p1, p1_launches, p2, p2_launches = phase_probes(torch, dev)
    k5 = phase_k5(torch, dev)
    k2 = phase_k2(torch, dev)
    k3, k4 = phase_k34(torch, dev)
    k1 = phase_k1(torch, dev)
    cudnn_bf16_conv_aside(torch, dev)
    k1_deep = phase_k1_deep(torch, dev)
    k7 = phase_k7(torch, dev)
    k6 = phase_k6(torch, dev)
    k9, k9_launches = phase_k9(torch, dev)

    cfg, info, batch = make_batch()
    none = {"dcn_offset_grad": 0, "dcn_input_grad": 0}  # no backward in a forward
    val_launches = phase_forward_bf16(
        torch, dev, "val path", cfg, info, batch,
        {"expand_rows": 1, "dcn_sample": 3, "conv_block": 0, **none}, 20)
    phase_forward_f32(torch, dev, "val path", cfg, info, batch,
                      {"radar_preds": 1e-4, "radar_x_conv4": 1e-4})
    torch.backends.cudnn.allow_tf32 = True
    raw = make_batch(host_precompute=False)[2]  # the same scene, no host tables
    phase_device_tables(torch, dev, "val path", cfg, info, batch, raw,
                        {"expand_rows": 1, "dcn_sample": 3})
    phase_dense_from(torch, dev, VAL_YAML)

    t0 = time.perf_counter()
    cfg, info, batch = make_batch(TRAIN_YAML)
    print(f"distillation batch (2 x 160000 lidar points, host precompute): "
          f"{time.perf_counter() - t0:.1f} s on the host")
    fwd_launches = phase_forward_bf16(
        torch, dev, "distillation forward", cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1, **none}, 10)
    launches = phase_train_bf16(
        torch, dev, TRAIN_YAML, cfg, info, batch,
        {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1, **DCN_BACKWARD}, 10)
    raw = make_batch(TRAIN_YAML, host_precompute=False)[2]
    dev_launches, built = phase_device_tables(
        torch, dev, "distillation forward", cfg, info, batch, raw,
        {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1})
    phase_device_train(torch, dev, TRAIN_YAML, cfg, info, batch, raw)
    k8, k8_launches = phase_k8(torch, dev, built["hp_as"])
    del batch, raw, built
    torch.cuda.empty_cache()

    # the teacher's deep chains: the same yaml with BACKBONE_3D overrides
    deep = {"int8_stages5": {"INT8_STAGES": 5}, "fp_stages5": {"INT8_STAGES": 1, "FP_STAGES": 5}}
    chain_expect = {
        "int8_stages5": {"expand_rows": 2, "dcn_sample": 3, "conv_block": 23,
                         "conv_block.wgmma": 18, "conv_block.mma_sync": 5, "chain_conv": 1},
        "fp_stages5": {"expand_rows": 2, "dcn_sample": 3, **K1_STAGE1, "conv_block_fp": 19}}
    chain_launches = {}
    for name, over in deep.items():
        cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d=over)
        chain_launches[name] = phase_forward_bf16(
            torch, dev, f"distillation forward {over}", cfg, info, batch, chain_expect[name], 5)
        if name == "int8_stages5":
            phase_train_bf16(torch, dev, TRAIN_YAML, cfg, info, batch,
                             {**chain_expect[name], **DCN_BACKWARD}, 3)
        del batch
        torch.cuda.empty_cache()

    small = dict(grid=512, num_lidar=20000, num_radar=400, num_boxes=10)
    cfg, info, batch = make_batch(TRAIN_YAML, **small)
    teacher = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x",
               "lidar_preds")
    phase_forward_f32(torch, dev, "distillation forward", cfg, info, batch,
                      {**{k: 1e-3 for k in teacher}, "radar_preds": 1e-4})
    phase_train_f32(torch, dev, TRAIN_YAML, cfg, info, batch)
    for name, over in deep.items():
        cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d=over, **small)
        t_tol = 5e-2 if name == "int8_stages5" else 1e-3  # see the module docstring
        phase_forward_f32(torch, dev, f"distillation forward {over}", cfg, info, batch,
                          {**{k: t_tol for k in teacher}, "radar_preds": 1e-4},
                          v1_equal=teacher[:4] if name == "int8_stages5" else ())

    dcn_py = "radardistill_tpu/ops/pallas_dcn.py"
    block_py = "radardistill_tpu/ops/pallas_conv_block.py"
    table = [
        ("expand_rows", "expand.cu", "radardistill_tpu/ops/pallas_expand.py:39", k5),
        ("dcn_sample", "dcn_sample.cu", f"{dcn_py}:213", k2),
        ("conv_block", "conv3x3_wgmma.cu", f"{block_py}:81", k1),
        ("dcn_offset_grad", "dcn_offset_grad.cu", f"{dcn_py}:283", k3),
        ("dcn_input_grad", "dcn_input_grad.cu", f"{dcn_py}:378", k4),
        ("conv_block_fp", "conv_block_fp.cu", f"{block_py}:81", k6),
        ("chain_conv", "conv_block.cu", "radardistill_tpu/ops/pallas_int8_conv.py:64", k7),
        ("conv3x3_wide", "conv3x3_wgmma.cu", "radardistill_tpu/ops/pallas_wide_conv.py:57", k9),
        ("gather_rows_windowed", "gather_win.cu", "radardistill_tpu/ops/pallas_expand.py:130", k8),
        ("conv_probe", "conv3x3_wgmma.cu", "tools/pallas_conv_proto.py:65", p1),
        ("mma_rate", "mma_rate.cu", "tools/mxu_rate.py:53", p2),
    ]
    # `launches`: the train step for the first five; one forward of its own
    # configuration for K6 and K7; one forward + backward of the wrapper for
    # K9; for K8, P1 and P2, which no model calls, the launches of their phase
    # (K8: one pass over the 14 tap gathers; P1, P2: every case of the tables)
    own = {"conv_block_fp": chain_launches["fp_stages5"]["conv_block_fp"],
           "chain_conv": chain_launches["int8_stages5"]["chain_conv"],
           "conv3x3_wide": k9_launches, "gather_rows_windowed": k8_launches,
           "conv_probe": p1_launches, "mma_rate": p2_launches}
    kernels = [{"name": name, "route": "cuda", "source": f"radardistill_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": own.get(name, launches[name]),
                "launches_val": val_launches[name], "launches_forward": fwd_launches[name],
                "launches_int8_stages5": chain_launches["int8_stages5"][name],
                "launches_fp_stages5": chain_launches["fp_stages5"][name],
                "launches_device_tables": dev_launches[name], "launch_ms": None,
                "mma": MMA_ROUTES.get(name), **rec}
               for name, src, replaces, rec in table]
    # K1: the stage-1 links' time on the old resident mma.sync variant, and
    # the 19 deeper links of INT8_STAGES: 5 on their routes
    kernels[2].update({f"deep_{k}": v for k, v in k1_deep.items()})
    if any(k["launches"] < 1 for k in kernels):
        raise RuntimeError("a kernel was launched on no path: "
                           + str([k["name"] for k in kernels if k["launches"] < 1]))
    keys = ("name", "route", "mma", "source", "replaces", "launches", "launches_val",
            "launches_forward", "launches_int8_stages5", "launches_fp_stages5",
            "launches_device_tables", "max_abs_err",
            "ms", "launch_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "aside_ms",
            "k4_route", "repeats_bitwise", "old_route_ms",
            "deep_ms", "deep_old_route_ms", "deep_device_ms", "deep_device_old_route_ms",
            "deep_plain_ms", "deep_bound_ms")
    print(f"chip_smoke.py: every phase passed; {time.perf_counter() - t_start:.1f} s in all, the "
          f"build included, on {smi}")
    print(json.dumps({"kernels": [{k: kern.get(k) for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
