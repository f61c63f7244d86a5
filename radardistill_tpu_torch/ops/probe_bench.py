"""Run the probes of ``ops/probes.py`` on the card and print their rate tables.

``mma_rate_table`` is the counterpart of ``tools/mxu_rate.py``'s ``main`` and
``conv_probe_table`` of the ``main*`` functions of
``tools/pallas_conv_proto.py``: each case is first held against its plain
version (bfloat16 within 1e-2 x max|ref|, TF32 within 1e-3 x max|ref|: one
rounding of a differently ordered float32 sum, resp. the TF32 rounding of
the operands; int8 exact), then timed with CUDA events. Rates stand beside
the published dense peaks of one H100 SXM and beside one library call on the
same operands (cuBLAS through ``torch.bmm`` / ``torch._int_mm``, cuDNN
through ``F.conv2d``), which the port uses nowhere else.
``tools/torch_mma_rate.py``, ``tools/torch_conv_probe.py`` and
``chip_smoke.py`` call these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import conv3x3_wgmma
from .probes import (ROUTES, conv_probe, conv_probe_plain, conv_probe_work, mma_rate,
                     mma_rate_plain, mma_rate_work)

PEAK_BYTES = 3.35e12
# operations/s of the tensor cores, dense
PEAK_OPS = {"bfloat16": 989e12, "int8": 1979e12, "tf32": 495e12}
TOL = {"bfloat16": 1e-2, "tf32": 1e-3, "int8": 0.0}

# (M, K, N): the TPU tool's shapes, with N = 64 added
MMA_SHAPES = tuple((2048, 512, n) for n in (64, 128, 256, 512, 1024)) + (
    (2048, 128, 128), (8192, 128, 128))
MMA_CASES = (tuple((s, torch.bfloat16) for s in MMA_SHAPES)
             + tuple((s, torch.int8) for s in MMA_SHAPES)
             + (((2048, 512, 512), torch.float32),))

# (B, H, W, C, Co): the TPU tool's shape at Co 128 and 512, then the other 3x3
# links of the teacher's float chain
CONV_SHAPES = ((2, 720, 720, 128, 128), (2, 720, 720, 128, 512), (2, 360, 360, 128, 128),
               (2, 180, 180, 256, 256), (2, 90, 90, 256, 256))


def type_name(dtype) -> str:
    return "tf32" if dtype == torch.float32 else str(dtype)[6:]


def cuda_ms(fn, iters: int, hide_host: bool = False) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls.
    With ``hide_host`` the stream sleeps first (about 30 ms) while the host
    enqueues every call, so a wrapper whose launches cost the host more than
    its kernels cost the card reads its device time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(60_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_err(got, want, name, tol):
    wide = torch.float64 if got.dtype == torch.int32 else torch.float32
    err = (got.to(wide) - want.to(wide)).abs().max().item()
    ref = want.to(wide).abs().max().item()
    if not err <= tol * ref:
        raise RuntimeError(f"{name}: max_abs_err {err} over {tol} x max|ref| {ref}")
    return err, ref


def _rate_operands(shape, dtype, dev, gen):
    m, k, n = shape
    if dtype == torch.int8:  # a + r stays inside int8 for r < 8
        a = torch.randint(-127, 120, (m, k), generator=gen, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    else:
        a = (torch.randn(m, k, generator=gen) * 0.05).to(dtype)
        bt = (torch.randn(n, k, generator=gen) * 0.05).to(dtype)
    return a.to(dev), bt.to(dev).t()  # b (K, N) as the transpose of a contiguous (N, K)


def _library_matmul_ms(a, b, copies):
    """One library call on the same operands: ``copies`` products a @ b as a
    batched cuBLAS call (``torch.bmm`` over broadcast views; TF32 on for
    float32), or ``torch._int_mm`` for int8 (one product a call). Returns
    (ms per product, what was called) or (None, why not)."""
    if a.dtype == torch.int8:
        if not hasattr(torch, "_int_mm"):
            return None, "no torch._int_mm"
        return cuda_ms(lambda: torch._int_mm(a, b), 50), "torch._int_mm"
    ab, bb = a.expand(copies, *a.shape), b.expand(copies, *b.shape)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ms = cuda_ms(lambda: torch.bmm(ab, bb), 5) / copies
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return ms, f"torch.bmm x {copies}"


def mma_rate_table(dev, target_ops=1.5e12):
    """Every case on every route: compared with the plain version, then timed
    in one launch that repeats the grid until it holds about ``target_ops``
    operations. Prints one line and returns one record per (case, route)."""
    gen = torch.Generator().manual_seed(20)
    recs, reps = [], 8  # the TPU tool's eight products
    for shape, dtype in MMA_CASES:
        m, k, n = shape
        tname = type_name(dtype)
        a, b = _rate_operands(shape, dtype, dev, gen)
        want = mma_rate_plain(a, b, reps)
        plain_ms = cuda_ms(lambda: mma_rate_plain(a, b, reps), 2)
        ops1, nbytes = mma_rate_work(a, b, reps)
        grid_reps = int(min(max(round(target_ops / ops1), 1), 4096))
        lib_ms, lib_what = _library_matmul_ms(a, b, min(reps * grid_reps, 128))
        lib_rate = None if lib_ms is None else 2.0 * m * k * n / lib_ms / 1e9
        for route in ROUTES:
            got = mma_rate(a, b, reps, route)
            torch.cuda.synchronize()
            err, ref = _max_err(got, want, f"mma_rate {route} {tname} {shape}", TOL[tname])
            ms = cuda_ms(lambda: mma_rate(a, b, reps, route, grid_reps), 3)
            rate = ops1 * grid_reps / ms / 1e9  # T operations / s
            share = rate * 1e12 / PEAK_OPS[tname]
            rec = {"shape": shape, "type": tname, "route": route, "max_abs_err": err,
                   "ms": ms / grid_reps, "plain_ms": plain_ms, "tops": rate, "share_of_peak": share,
                   "library_ms": None if lib_ms is None else lib_ms * reps,
                   "ops_ms": ops1 / PEAK_OPS[tname] * 1e3, "bytes_ms": nbytes / PEAK_BYTES * 1e3}
            recs.append(rec)
            unit = "TOP/s" if dtype == torch.int8 else "TFLOP/s"
            lib = "none" if lib_rate is None else f"{lib_rate:.1f} {unit}"
            print(f"P2 mma_rate M={m:5d} K={k:4d} N={n:4d} {tname:8s} {route:8s}: {rate:7.1f} "
                  f"{unit} ({100 * share:5.1f}% of the {PEAK_OPS[tname] / 1e12:.0f} peak), max_abs_err "
                  f"{err:.3e} (limit {TOL[tname] * ref:.3e}); {lib_what}: {lib}")
    return recs


def mma_rate_against_library(dev, shape=(2048, 512, 512), rounds=20, iters=20):
    """P2's ``wgmma`` route and ``torch.bmm`` on the same bfloat16 operands in
    turns, ``rounds`` times each (P2, library, P2, library, ...), each time a
    CUDA-event mean over ``iters`` calls; returns both lists of ms per ``reps``
    = 8 products, P2 checked against its plain version first."""
    gen = torch.Generator().manual_seed(21)
    m, k, n = shape
    reps = 8
    a, b = _rate_operands(shape, torch.bfloat16, dev, gen)
    _max_err(mma_rate(a, b, reps, "wgmma"), mma_rate_plain(a, b, reps), "mma_rate wgmma",
             TOL["bfloat16"])
    grid_reps = int(min(max(round(4e11 / (2.0 * m * k * n * reps)), 1), 4096))
    copies = min(reps * grid_reps, 128)
    ab, bb = a.expand(copies, *a.shape), b.expand(copies, *b.shape)
    kernel, library = [], []
    for _ in range(rounds):
        kernel.append(cuda_ms(lambda: mma_rate(a, b, reps, "wgmma", grid_reps), iters) / grid_reps)
        library.append(cuda_ms(lambda: torch.bmm(ab, bb), iters) / copies * reps)
    return kernel, library


def _conv_operands(shape, int8, dev, gen):
    b, h, w, c, co = shape
    if int8:
        x = torch.randint(-127, 128, (b, h, w, c), generator=gen, dtype=torch.int8)
        k = torch.randint(-127, 128, (3, 3, c, co), generator=gen, dtype=torch.int8)
    else:
        x = (torch.randn(b, h, w, c, generator=gen) * 0.05).to(torch.bfloat16)
        k = (torch.randn(3, 3, c, co, generator=gen) * 0.05).to(torch.bfloat16)
    a = (torch.randn(co, generator=gen).abs() * 1e-4 * (128.0 / c)).to(dev)
    return F.pad(x, (0, 0, 0, 0, 1, 1)).to(dev), k.to(dev), a


def _launch_alone_ms(xp, k, mode, a, got, iters):
    """The ``wgmma`` route's launch alone: the taps prepared and the output
    allocated outside the timed loop (which the wrapper's time includes)."""
    kt, out = conv3x3_wgmma.wgmma_taps(k), torch.empty_like(got)
    relu = k.shape[-1] == 128  # the wrapper's default
    fn = lambda: conv3x3_wgmma.launch(xp, kt, out, mode, padded=True, scale=a,  # noqa: E731
                                      relu=relu)
    fn()
    if not torch.equal(out, got):
        raise RuntimeError(f"conv_probe {mode}: the bare launch differs from the wrapper")
    return cuda_ms(fn, iters)


def conv_probe_table(dev, iters=5):
    """The three modes on both routes at every shape: compared with the plain
    version, then timed (the ``wgmma`` route also by its launch alone);
    cuDNN's bfloat16 channels-last ``F.conv2d`` beside ``conv``. Prints one
    line and returns one record per (shape, mode, route)."""
    gen = torch.Generator().manual_seed(21)
    recs = []
    for shape in CONV_SHAPES:
        b, h, w, c, co = shape
        operands = {False: _conv_operands(shape, False, dev, gen),
                    True: _conv_operands(shape, True, dev, gen)}
        for mode in ("dots", "conv", "int8"):
            xp, k, a = operands[mode == "int8"]
            tname = "int8" if mode == "int8" else "bfloat16"
            args = (xp, k, mode, a) if mode == "int8" else (xp, k, mode)
            ops, nbytes = conv_probe_work(*args)
            want = conv_probe_plain(*args)
            plain_ms = cuda_ms(lambda: conv_probe_plain(*args), 1)
            lib_ms = None
            if mode == "conv":
                xn = xp[:, 1:-1].contiguous().permute(0, 3, 1, 2)  # NCHW view, channels last
                wn = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                lib_ms = cuda_ms(lambda: F.conv2d(xn, wn, padding=1), iters)
            for route in ROUTES:
                got = conv_probe(*args, route=route)
                torch.cuda.synchronize()
                err, ref = _max_err(got, want, f"conv_probe {mode} {route} {shape}", TOL[tname])
                ms = cuda_ms(lambda: conv_probe(*args, route=route), iters)
                launch_ms = (_launch_alone_ms(xp, k, mode, a, got, iters) if route == "wgmma"
                             else None)
                rate = ops / ms / 1e9
                rec = {"shape": shape, "mode": mode, "route": route, "type": tname,
                       "max_abs_err": err, "ms": ms, "launch_ms": launch_ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms, "tops": rate,
                       "share_of_peak": rate * 1e12 / PEAK_OPS[tname],
                       "ops_ms": ops / PEAK_OPS[tname] * 1e3,
                       "bytes_ms": nbytes / PEAK_BYTES * 1e3}
                recs.append(rec)
                unit = "TOP/s" if mode == "int8" else "TFLOP/s"
                spread = (f", {100 * float((got > -127).float().mean()):.0f}% of codes above -127"
                          if mode == "int8" else "")
                alone = ("" if launch_ms is None else
                         f", launch alone {launch_ms:.4f} ms ({ops / launch_ms / 1e9:.1f} {unit})")
                lib = "" if lib_ms is None else f", cuDNN F.conv2d {lib_ms:.4f} ms"
                print(f"P1 conv_probe {mode:4s} {route:8s} xp ({b}, {h}+2, {w}, {c}) Co {co:3d}: "
                      f"{ms:8.4f} ms, {rate:6.1f} {unit} ({100 * rec['share_of_peak']:4.1f}% of "
                      f"peak){alone}, max_abs_err {err:.3e} (limit {TOL[tname] * ref:.3e}){spread};"
                      f" plain {plain_ms:.3f} ms{lib}")
            del want
    return recs
