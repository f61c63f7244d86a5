#!/usr/bin/env python3
"""Tensor-core rate of one NVIDIA GPU (an H100) against the product's shape.

The PyTorch + CUDA counterpart of ``tools/mxu_rate.py``: for every (M, K, N)
of that tool (and N = 64), in bfloat16, int8 and float32-as-TF32, the kernel
``radardistill_tpu_torch/csrc/mma_rate.cu`` runs eight products of a slightly
rotated A with B kept on chip, on two routes (``mma.sync`` and
``wgmma.mma_async``). Each case is first held against its plain PyTorch
version; then one line per case and route gives the rate, its share of the
card's published peak, and cuBLAS on the same operands beside it.

Usage (needs the card and nvcc): ``python3 tools/torch_mma_rate.py [OTHER_DIR]``

``OTHER_DIR`` holds another version of ``mma_rate.cu`` with the headers it
includes, e.g. a parent commit's ``radardistill_tpu_torch/csrc`` unpacked with
``git archive``. It is built too, and on the ``wgmma`` route both builds are
held against the plain version at every case, then timed in turns (other,
this, this, other) by bare launches on the same operands; last the bfloat16
(2048, 512, 512) case of both builds and ``torch.bmm`` in turns, 20 times
each (mean, min, max), as ``chip_smoke.py`` reads P2 against the library.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def build_other(cuda_lib, other_dir: Path):
    """The other ``mma_rate.cu`` as a library with P2's two entry points."""
    so = cuda_lib.BUILD_DIR / "ab" / "libmma_rate_other.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(so),
                          str(other_dir / "mma_rate.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on the other mma_rate.cu:\n{res.stderr[-4000:]}")
    return cuda_lib.bind(ctypes.CDLL(str(so)), ["rdt_mma_rate", "rdt_mma_rate_bn"])


def ab(torch, dev, libs, rounds=20, iters=20):
    """Both builds' ``wgmma`` route at every case, checked and timed in turns
    by bare launches; then the headline case against ``torch.bmm``."""
    from radardistill_tpu_torch.ops import cuda_lib
    from radardistill_tpu_torch.ops.probe_bench import (MMA_CASES, TOL, _max_err,
                                                        _rate_operands, cuda_ms, type_name)
    from radardistill_tpu_torch.ops.probes import RATE_DTYPES, mma_rate_plain

    gen = torch.Generator().manual_seed(22)
    reps = 8

    def bare(lib, a, bt, out, grid_reps):
        (m, k), n = a.shape, bt.shape[0]
        rc = lib.rdt_mma_rate(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, k, k,
                              RATE_DTYPES[a.dtype], 1, reps, grid_reps, dev.index,
                              cuda_lib.stream_of(a))
        cuda_lib.check(rc, "mma_rate (bare)")

    for shape, dtype in MMA_CASES:
        m, k, n = shape
        tname = type_name(dtype)
        a, b = _rate_operands(shape, dtype, dev, gen)
        bt = b.t()
        want = mma_rate_plain(a, b, reps)
        ops = 2.0 * m * k * n * reps
        grid_reps = int(min(max(round(4e11 / ops), 1), 4096))
        outs = {name: torch.empty_like(want) for name in libs}
        for name, lib in libs.items():
            bare(lib, a, bt, outs[name], 1)
            torch.cuda.synchronize()
            _max_err(outs[name], want, f"mma_rate wgmma ({name}) {tname} {shape}", TOL[tname])
        run = {name: (lambda lib=lib, o=outs[name]: bare(lib, a, bt, o, grid_reps))
               for name, lib in libs.items()}
        t = [cuda_ms(run["other"], 3), cuda_ms(run["this"], 3), cuda_ms(run["this"], 3),
             cuda_ms(run["other"], 3)]
        other, this = (t[0] + t[3]) / 2 / grid_reps, (t[1] + t[2]) / 2 / grid_reps
        unit = "TOP/s" if dtype == torch.int8 else "TFLOP/s"
        print(f"P2 wgmma A/B M={m:5d} K={k:4d} N={n:4d} {tname:8s}: other {other:.5f} ms "
              f"({ops / other / 1e9:.1f} {unit}), this {this:.5f} ms ({ops / this / 1e9:.1f} "
              f"{unit}); both within tolerance of plain", flush=True)

    a, b = _rate_operands((2048, 512, 512), torch.bfloat16, dev, gen)
    bt, out = b.t(), torch.empty((2048, 512), dtype=torch.bfloat16, device=dev)
    grid_reps = int(round(4e11 / (2.0 * 2048 * 512 * 512 * reps)))
    copies = min(reps * grid_reps, 128)
    a_all, b_all = a.expand(copies, *a.shape), b.expand(copies, *b.shape)
    times = {"other": [], "this": [], "torch.bmm": []}
    for _ in range(rounds):
        for name, lib in libs.items():
            times[name].append(cuda_ms(lambda: bare(lib, a, bt, out, grid_reps), iters)
                               / grid_reps)
        times["torch.bmm"].append(cuda_ms(lambda: torch.bmm(a_all, b_all), iters)
                                  / copies * reps)
    print(f"P2 bfloat16 (2048, 512, 512), 8 products, in turns {rounds} times each: " + "; ".join(
        f"{name} mean {sum(v) / len(v):.5f} ms (min {min(v):.5f}, max {max(v):.5f})"
        for name, v in times.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_rate.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.ops import cuda_lib
    from radardistill_tpu_torch.ops.probe_bench import mma_rate_table

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    if len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 2
    if len(sys.argv) == 2:
        libs = {"other": build_other(cuda_lib, Path(sys.argv[1])), "this": cuda_lib.lib()}
        ab(torch, dev, libs)
        return 0
    mma_rate_table(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
