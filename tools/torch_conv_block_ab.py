#!/usr/bin/env python3
"""A/B of K1's ``wgmma`` route on one CUDA card: the working tree's
``csrc/conv3x3_wgmma.cu`` against another version of that file.

    python3 tools/torch_conv_block_ab.py OTHER_DIR

``OTHER_DIR`` holds the other ``conv3x3_wgmma.cu`` with the headers it
includes (``tma_ops.cuh``, ``wgmma_ops.cuh``), e.g. a parent commit's
``radardistill_tpu_torch/csrc`` unpacked with ``git archive``. Both build for
sm_90a (ptxas registers and spills printed); then at the link shapes of the
teacher's chain that take the route (the stage-1 link (2, 720, 720, 128) x (3,
3, 128, 128) with 4 mask phases, the deeper C, Co % 128 links, and the two
Co-64 shapes of stage 2 on the transposed kernel, which the other build must
also take) and for
each ``zpad`` 0 / -127 with and without a residual, int8 out (and once
bfloat16 out at 720²): both versions' outputs must equal ``conv_block_plain``;
the bare launches (``rdt_conv_block_wgmma`` on prepared operands) are timed
with CUDA events, other, this, this, other; the wrapper ``conv_block`` beside
them, its device time with the host's enqueue hidden; and P1's ``int8`` mode at
the same 3x3 shape (the mainloop with P1's short epilogue). Then K7's two
Co-64 shapes (the transposed kernel K1 shares, with K7's mask of a byte per
output channel), through ``rdt_chain_conv_wgmma`` on a pre-padded input, for
each ``zpad`` with and without a residual: both outputs equal to
``chain_conv_plain``, the bare launches (``conv3x3_wgmma.launch_chain``)
timed in turns the same way; an other build that refuses the shape (one from
before K7's Co-64 links moved) is said to, and this one is timed alone. Needs
a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SHAPES = ((2, 720, 720, 128, 128, 3, 4), (2, 720, 720, 128, 64, 2, 1),
          (2, 720, 720, 64, 64, 3, 1), (2, 360, 360, 128, 128, 3, 1),
          (2, 180, 180, 256, 256, 3, 1), (2, 180, 180, 512, 256, 2, 1),
          (2, 90, 90, 256, 256, 3, 1))  # (B, H, W, C, Co, kh, nph)
K7_SHAPES = ((2, 720, 720, 128, 64, 2), (2, 720, 720, 64, 64, 3))  # (B, H, W, C, Co, kh)


def ptxas_summary(log: str) -> list[str]:
    """The register and spill lines of the K1 and K7 instantiations (EPI_K1_S8,
    EPI_K1_BF16, EPI_K7)."""
    out, keep = [], False
    for line in log.splitlines():
        if "entry function" in line:
            keep = (("conv_wgmma_kernel" in line or "conv_co64_kernel" in line)
                    and any(f"S8ELi{e}" in line for e in (2, 3, 5)))
        elif keep and ("Used" in line or "spill" in line):
            out.append(line.strip())
    return out


def k7_ab(torch, dev, gen, libs, b, h, w, c, co, kh, codes, cuda_ms) -> int:
    """K7 at one Co-64 shape, per-channel mask, both builds in turns; returns
    the number of codes that differ from ``chain_conv_plain``."""
    from radardistill_tpu_torch.ops import conv3x3_wgmma
    from radardistill_tpu_torch.ops import conv_block as cb
    from radardistill_tpu_torch.ops.int8_conv import chain_conv_plain

    xq, kq, resq = codes(b, h, w, c), codes(kh, kh, c, co), codes(b, h, w, co)
    ab = torch.zeros(8, co)
    ab[0] = (torch.rand(co, generator=gen) * 4e-4 + 2e-4) * 128 / c * 0.4
    ab[1] = torch.rand(co, generator=gen) - 0.5
    ab[2], ab[3], ab[4] = 254.0 / 9.0, 3.0 / 254, 127 * 3.0 / 254
    ab = ab.to(dev)
    mq = (torch.rand(b, h, w, co, generator=gen) < 0.6).to(torch.int8).to(dev)
    wk, wsum = conv3x3_wgmma.wgmma_taps(kq), cb.tap_sums(kq)
    bad = 0
    for zpad in (0, -127):
        xp = torch.nn.functional.pad(xq, (0, 0, 0, 0, 1, kh - 2), value=zpad)
        for r in (None, resq):
            want = chain_conv_plain(xp, kq, ab, mq, r, zpad)
            outs = {k: torch.empty((b, h, w, co), dtype=torch.int8, device=dev) for k in libs}
            run = {k: (lambda k=k: conv3x3_wgmma.launch_chain(xp, wk, ab, mq, r, wsum, outs[k],
                                                              zpad, lib=libs[k]))
                   for k in libs}
            try:
                run["other"]()
            except RuntimeError as e:  # cudaErrorInvalidValue: the shape is refused
                if "CUDA error 1:" not in str(e):
                    raise
                del run["other"], outs["other"]
            run["this"]()
            torch.cuda.synchronize()
            n_bad = sum(int((o != want).sum()) for o in outs.values())
            bad += n_bad
            if "other" in run:
                t = [cuda_ms(run["other"], 20), cuda_ms(run["this"], 20),
                     cuda_ms(run["this"], 20), cuda_ms(run["other"], 20)]
                other = f"other {(t[0] + t[3]) / 2:.4f} ms"
                this_ms = (t[1] + t[2]) / 2
            else:
                other = "the other build does not take it"
                this_ms = (cuda_ms(run["this"], 20) + cuda_ms(run["this"], 20)) / 2
            print(f"K7 ({b}, {h + kh - 1}, {w}, {c}) pre-padded, k{kh} -> {co}, per-channel "
                  f"mask, zpad {zpad}, residual {r is not None}: {n_bad} codes differ from plain; "
                  f"launch alone {other}, this {this_ms:.4f} ms", flush=True)
    return bad


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_block_ab.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.ops import conv3x3_wgmma, cuda_lib
    from radardistill_tpu_torch.ops import conv_block as cb
    from radardistill_tpu_torch.ops.probe_bench import cuda_ms

    log = cuda_lib.build(ptxas_verbose=True)
    other_so = cuda_lib.BUILD_DIR / "ab" / "libconv_other.so"
    other_so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                          str(other_so), str(Path(sys.argv[1]) / "conv3x3_wgmma.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        print(res.stderr[-4000:], file=sys.stderr)
        return 1
    for name, text in (("this", log), ("other", res.stderr)):
        for line in ptxas_summary(text):
            print(f"{name}: {line}")
    libs = {"this": cuda_lib.lib(),
            "other": cuda_lib.bind(ctypes.CDLL(str(other_so)),
                                   ["rdt_conv_block_wgmma", "rdt_chain_conv_wgmma"])}
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    bad = 0
    for b, h, w, c, co, kh, nph in SHAPES:
        xq, kq, resq = codes(b, h, w, c), codes(kh, kh, c, co), codes(b, h, w, co)
        ab = torch.zeros(8, co)
        ab[0] = (torch.rand(co, generator=gen) * 4e-4 + 2e-4) * 128 / c * 0.4
        ab[1] = torch.rand(co, generator=gen) - 0.5
        ab[2], ab[3], ab[4] = 254.0 / 9.0, 3.0 / 254, 127 * 3.0 / 254
        ab = ab.to(dev)
        mask = (torch.rand(b, h, w, nph, generator=gen) < 0.6).to(torch.int8).to(dev)
        wk, wsum = conv3x3_wgmma.wgmma_taps(kq), cb.tap_sums(kq)
        cases = [(0, None, torch.int8), (-127, None, torch.int8), (0, resq, torch.int8),
                 (-127, resq, torch.int8)] + ([(-127, resq, torch.bfloat16)] if h == 720 else [])
        for zpad, r, out_dtype in cases:
            outs = {k: torch.empty((b, h, w, co), dtype=out_dtype, device=dev) for k in libs}
            want = cb.conv_block_plain(xq, kq, ab, mask, r, zpad, out_dtype)
            run = {k: (lambda k=k: conv3x3_wgmma.launch_link(xq, wk, ab, mask, r, wsum, outs[k],
                                                             zpad, lib=libs[k]))
                   for k in libs}
            for fn in run.values():
                fn()
            torch.cuda.synchronize()
            n_bad = sum(int((o != want).sum()) for o in outs.values())
            bad += n_bad
            t = [cuda_ms(run["other"], 20), cuda_ms(run["this"], 20), cuda_ms(run["this"], 20),
                 cuda_ms(run["other"], 20)]
            this_ms = (t[1] + t[2]) / 2
            ops = 2.0 * b * h * w * kh * kh * c * co
            wrap = lambda: cb.conv_block(xq, kq, ab, mask, r, zpad, out_dtype)  # noqa: E731
            print(f"({b}, {h}, {w}, {c}) k{kh} -> {co}, {nph} phases, zpad {zpad}, residual "
                  f"{r is not None}, {str(out_dtype)[6:]} out: {n_bad} values differ from plain; "
                  f"launch alone other {(t[0] + t[3]) / 2:.4f} ms, this {this_ms:.4f} ms "
                  f"({ops / this_ms / 1e9:.0f} TOP/s); wrapper {cuda_ms(wrap, 20):.4f} ms, its "
                  f"device time {cuda_ms(wrap, 20, hide_host=True):.4f} ms", flush=True)
        if kh == 3 and co % 128 == 0:  # P1's int8 mode: the same products, its short epilogue
            xp = torch.nn.functional.pad(xq, (0, 0, 0, 0, 1, 1))
            o = torch.empty((b, h, w, co), dtype=torch.int8, device=dev)
            a = torch.full((co,), 1e-3, device=dev)
            p1 = lambda: conv3x3_wgmma.launch(xp, wk, o, "int8", padded=True, scale=a,  # noqa
                                              relu=True)
            print(f"  P1 int8 at this shape, launch alone: {cuda_ms(p1, 20):.4f} ms", flush=True)
    for b, h, w, c, co, kh in K7_SHAPES:
        bad += k7_ab(torch, dev, gen, libs, b, h, w, c, co, kh, codes, cuda_ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"on {smi}; {'every output equal to plain' if bad == 0 else f'{bad} values differ'}")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
