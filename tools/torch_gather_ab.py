#!/usr/bin/env python3
"""K8 (``gather_rows_windowed``, ``csrc/gather_win.cu``) on one CUDA card at
the 14 gathers of the student's tap tables (bs2 train batch, bfloat16):

    python3 tools/torch_gather_ab.py [OTHER_DIR] [--iters N]

Builds the working tree's kernels for sm_90a (ptxas registers and spills of
K8's instantiations printed) and holds each gather's wrapper and bare launch
(``expand.launch_gather_win``) bit-equal to the plain version and to
``torch.index_select``, with a count of 0. Then times each gather with CUDA
events (``ops/gather_bench.py``): in turns the wrapper as a caller meets it,
the bare launch with the host's enqueue hidden (the device's time), the plain
version and ``index_select``; then the bare launch with L2 emptied before
each call ("cold"). The bound is the bytes the gather must move (idx, each
distinct row it copies, the rows written) over 3.35 TB/s; a warm time below
it means the rows came from the 50 MB L2, and is marked so.

``OTHER_DIR`` holds another ``gather_win.cu``, e.g. a parent commit's
``radardistill_tpu_torch/csrc`` unpacked with ``git archive``: it is built
too, held to the same equalities, and its bare launch timed in turns with
this tree's (other, this, this, other), then cold. A version without the
count's scratch word (its caller zeroes the count) is launched through that
older signature. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the C signature of a gather_win.cu without the scratch word (its caller
# zeroes the count)
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ZEROED_COUNT_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I64, _I32, _P]


def ptxas_summary(log: str) -> list[str]:
    """The register and spill lines of the K8 kernels."""
    out, keep, fn = [], False, ""
    for line in log.splitlines():
        if "entry function" in line:
            keep = "gather_win" in line
            fn = line.split("'")[1] if "'" in line else line
        elif keep and ("Used" in line or "spill" in line):
            out.append(f"{fn}: {line.strip()}")
    return out


def build_other(cuda_lib, other: Path):
    """The other gather_win.cu as its own library: (lib, zeroed_count, ptxas log)."""
    src = other / "gather_win.cu"
    so = cuda_lib.BUILD_DIR / "ab" / "libgather_other.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-o", str(so), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    zeroed = "scratch" not in src.read_text()
    if zeroed:
        fn = lib.rdt_gather_rows_windowed
        fn.argtypes, fn.restype = ZEROED_COUNT_ARGS, _I32
    else:
        cuda_lib.bind(lib, ["rdt_gather_rows_windowed"])
    return lib, zeroed, res.stderr


def main() -> int:
    args = sys.argv[1:]
    iters = 20
    if "--iters" in args:
        i = args.index("--iters")
        iters = int(args[i + 1])
        del args[i:i + 2]
    if len(args) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_gather_ab.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.ops import cuda_lib, expand, gather_bench
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    logs = {"this": cuda_lib.build(ptxas_verbose=True)}
    cuda_lib.lib()
    other = None
    if args:
        other, zeroed, logs["other"] = build_other(cuda_lib, Path(args[0]))
    for name, log in logs.items():
        for line in ptxas_summary(log):
            print(f"{name}: {line}")

    def other_alone(table, idx, n_win, out, over):
        """The other build's bare launch. Without the scratch word the count
        accumulates: the check zeroes it first."""
        if not zeroed:
            expand.launch_gather_win(table, idx, n_win, out, over, lib=other)
            return
        m, (r, c) = idx.shape[0], table.shape
        rc = other.rdt_gather_rows_windowed(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), over.data_ptr(), m, r,
            expand._padded_rows(r, n_win), n_win, c * table.element_size(), table.device.index,
            cuda_lib.stream_of(table))
        cuda_lib.check(rc, "gather_rows_windowed (other)")

    dev = torch.device("cuda", 0)
    batch = make_batch(TRAIN_YAML)[2]
    tables = batch_to_torch(batch["hp_as"], dev)
    cases = gather_bench.tap_gathers(tables, torch.Generator().manual_seed(18))
    sums: dict[str, float] = {}
    for case in cases:
        table, idx, n_win = case["table"], case["idx"], case["n_win"]
        got = gather_bench.check_case(case)
        out = torch.empty_like(got)
        over = torch.empty((), dtype=torch.int32, device=dev)
        before = {}
        if other is not None:
            over.zero_()
            other_alone(table, idx, n_win, out, over)
            torch.cuda.synchronize()
            if not torch.equal(out, got) or int(over):
                raise RuntimeError(f"K8 other build, {gather_bench.describe(case)}: rows or "
                                   f"count ({int(over)}) differ")
            before["other alone"] = (lambda: other_alone(table, idx, n_win, out, over), True)
        # the other build first: in turns other, this, this, other
        ms = gather_bench.time_case(case, iters, before)
        if other is not None:
            ms["other cold"] = gather_bench.cold_ms(
                lambda: other_alone(table, idx, n_win, out, over), iters, dev)
        bound = ms["bound"]
        l2 = " (L2-served: below the DRAM bound)" if ms["alone"] < bound else ""
        print(f"K8 {gather_bench.describe(case)}, bit-equal: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; alone at {bound / ms['alone']:.0%} of the bound{l2}, cold at "
              f"{bound / ms['cold']:.0%}")
        for k, v in ms.items():
            sums[k] = sums.get(k, 0.0) + v
    print("K8, the 14 gathers summed: " + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items())
          + f"; alone at {sums['bound'] / sums['alone']:.0%} of the bound, cold at "
          f"{sums['bound'] / sums['cold']:.0%}, on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
