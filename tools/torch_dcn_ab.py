#!/usr/bin/env python3
"""The DCN kernels K2 (``dcn_sample``), K3 (``dcn_offset_grad``) and K4
(``dcn_input_grad``) on one CUDA card, at the CMA's two site shapes (180² ->
90² and 90² -> 45², batch 2, C 256, offsets 3·randn clamped to ±5):

    python3 tools/torch_dcn_ab.py [OTHER_DIR] [--sweep]

Builds the working tree's kernels for sm_90a (ptxas registers and spills of
the DCN kernels printed) and checks each against its plain version, bfloat16
within 1e-2 x max|ref| and float32 within 1e-5. Then times the bare
launches on prepared operands and preallocated outputs with CUDA events;
K4 on both of its routes (the tile kernel; the atomic kernel with its
zeroing and cast, as its wrapper runs it).

``OTHER_DIR`` holds another version of ``dcn_sample.cu``,
``dcn_offset_grad.cu`` and ``dcn_input_grad.cu`` (with ``dcn_geom.cuh`` if
they include it), e.g. a parent commit's ``radardistill_tpu_torch/csrc``
unpacked with ``git archive``: it is built too, checked against the plain
versions the same way, and timed in turns with this tree (other, this, this,
other). Its K4 is the atomic route. ``--sweep`` also times K4's tile kernel
at other tile plans (each checked against plain first). K4's tile route must
repeat bit for bit. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SITES = ((180, 90), (90, 45))  # the CMA's downsamples at 1440² (180² runs twice)
DCN_SOURCES = ("dcn_sample.cu", "dcn_offset_grad.cu", "dcn_input_grad.cu")
# K4's tile plans (tile rows, tile columns, warps) that --sweep times
TILE_SWEEP = ((8, 8, 8), (8, 8, 4), (6, 6, 4), (10, 10, 8), (12, 12, 8))


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    sweep = "--sweep" in sys.argv[1:]
    if len(args) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_dcn_ab.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.ops import cuda_lib, dcn_grad
    from radardistill_tpu_torch.ops.dcn_sample import DTYPE_CODES, dcn_sample_plain
    from radardistill_tpu_torch.ops.probe_bench import cuda_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    log = cuda_lib.build(ptxas_verbose=True)
    libs = {"this": cuda_lib.lib()}
    logs = {"this": log}
    if args:
        so = cuda_lib.BUILD_DIR / "ab" / "libdcn_other.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                              "-o", str(so), *[str(Path(args[0]) / s) for s in DCN_SOURCES]],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        logs["other"] = res.stderr
        libs["other"] = cuda_lib.bind(ctypes.CDLL(str(so)), ["rdt_dcn_sample",
                                                            "rdt_dcn_offset_grad",
                                                            "rdt_dcn_input_grad"])
    for name, text in logs.items():
        keep = False
        for line in text.splitlines():
            if "entry function" in line:
                keep = "dcn" in line
                fn = line.split("'")[1] if "'" in line else line
            elif keep and ("Used" in line or "spill" in line):
                print(f"{name}: {fn[:60]}: {line.strip()}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(8)
    R, geo = 5.0, (2, 1)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    def err_ratio(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    def sample(lib, x, off, msk, out):
        B, H, W, C = x.shape
        rc = lib.rdt_dcn_sample(x.data_ptr(), off.data_ptr(), msk.data_ptr(), out.data_ptr(),
                                DTYPE_CODES[x.dtype], B, H, W, C, off.shape[1], off.shape[2],
                                *geo, 1, R, 0, stream())
        cuda_lib.check(rc, "dcn_sample")

    def offgrad(lib, x, off, msk, ds, g18, dm9):
        B, H, W, C = x.shape
        rc = lib.rdt_dcn_offset_grad(x.data_ptr(), off.data_ptr(), msk.data_ptr(), ds.data_ptr(),
                                     g18.data_ptr(), dm9.data_ptr(), DTYPE_CODES[x.dtype], B, H,
                                     W, C, off.shape[1], off.shape[2], *geo, 1, R, 0, stream())
        cuda_lib.check(rc, "dcn_offset_grad")

    def atomic(lib, ds, off, msk, shape):
        acc = torch.zeros(shape, dtype=torch.float32, device=dev)
        B, H, W, C = shape
        rc = lib.rdt_dcn_input_grad(ds.data_ptr(), off.data_ptr(), msk.data_ptr(),
                                    acc.data_ptr(), DTYPE_CODES[ds.dtype], B, H, W, C,
                                    off.shape[1], off.shape[2], *geo, 1, R, 0, stream())
        cuda_lib.check(rc, "dcn_input_grad (atomic)")
        return acc.to(ds.dtype)

    def tile(ds, off, msk, dx, plan):
        H, W = dx.shape[1:3]
        win = dcn_grad.tile_windows(H, W, off.shape[1], off.shape[2], *geo, 3, R, *plan[:2],
                                    dev)
        dcn_grad.launch_tile(ds, off, msk, win, dx, *geo, R, plan)

    def turns(fns, iters=20):
        """Times of each named fn, in the order given and then reversed."""
        order = list(fns) + list(reversed(fns))
        got = {k: [] for k in fns}
        for k in order:
            got[k].append(cuda_ms(fns[k], iters))
        return {k: sum(v) / len(v) for k, v in got.items()}

    tot = {}
    for h, ho in SITES:
        b, c = 2, 256
        x32 = torch.randn(b, h, h, c, generator=gen)
        ds32 = torch.randn(b, ho, ho, 9 * c, generator=gen)
        off = (3.0 * torch.randn(b, ho, ho, 18, generator=gen)).to(dev)
        msk = (torch.rand(b, ho, ho, 9, generator=gen) * 0.9 + 0.05).to(dev)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x, ds = x32.to(dev, dtype), ds32.to(dev, dtype)
            want_s = dcn_sample_plain(x, off, msk, *geo, 3, R)
            want_x = dcn_grad.dcn_input_grad_plain(ds, off, msk, h, h, *geo, 3, R)
            want_g = dcn_grad.dcn_offset_grad_plain(x, off, ds, msk, *geo, 3, R)
            out, dx = torch.empty_like(want_s), torch.empty_like(want_x)
            g18, dm9 = torch.empty_like(want_g[0]), torch.empty_like(want_g[1])
            plan = dcn_grad.tile_plan(h, h)
            tile(ds, off, msk, dx, plan)
            dx2 = torch.empty_like(dx)
            tile(ds, off, msk, dx2, plan)
            if not torch.equal(dx, dx2):
                raise RuntimeError("K4 tile: two launches differ")
            errs = {"K4 tile": err_ratio(dx, want_x)}
            for name, lib in libs.items():
                sample(lib, x, off, msk, out)
                offgrad(lib, x, off, msk, ds, g18, dm9)
                errs[f"K2 {name}"] = err_ratio(out, want_s)
                errs[f"K3 {name}"] = max(err_ratio(g18, want_g[0]), err_ratio(dm9, want_g[1]))
                errs[f"K4 atomic {name}"] = err_ratio(atomic(lib, ds, off, msk, dx.shape), want_x)
            torch.cuda.synchronize()
            print(f"{str(dtype)[6:]} bs{b} {h}²->{ho}²: error / max|ref| "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (limit {tol})")
            if not all(v <= tol for v in errs.values()):
                raise RuntimeError(f"a kernel disagrees with its plain version: {errs}")
            if dtype != torch.bfloat16:
                continue
            fns = {}
            for name, lib in libs.items():
                fns[f"K2 {name}"] = lambda lib=lib: sample(lib, x, off, msk, out)
                fns[f"K3 {name}"] = lambda lib=lib: offgrad(lib, x, off, msk, ds, g18, dm9)
                fns[f"K4 atomic {name}"] = lambda lib=lib: atomic(lib, ds, off, msk, dx.shape)
            fns["K4 tile"] = lambda: tile(ds, off, msk, dx, plan)
            ms = turns(fns)
            n = 2 if h == 180 else 1  # 180² runs twice in the CMA
            for k, v in ms.items():
                tot[k] = tot.get(k, 0.0) + n * v
            print(f"bfloat16 bs{b} {h}²->{ho}², launches alone: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
            if sweep:
                for p in TILE_SWEEP:
                    dx.zero_()
                    tile(ds, off, msk, dx, p)
                    e = err_ratio(dx, want_x)
                    if not e <= tol:
                        raise RuntimeError(f"K4 tile {p}: error {e}")
                    t = cuda_ms(lambda: tile(ds, off, msk, dx, p), 20)
                    print(f"  K4 tile {p[0]} x {p[1]} cells, {p[2]} warps: {t:.4f} ms "
                          f"(error {e:.2e})")
    print("over the three CMA sites, bs2 bfloat16, launches alone: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in tot.items()) + f" on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
