#!/usr/bin/env python3
"""Tensor-core rate of one NVIDIA GPU (an H100) against the product's shape.

The PyTorch + CUDA counterpart of ``tools/mxu_rate.py``: for every (M, K, N)
of that tool (and N = 64), in bfloat16, int8 and float32-as-TF32, the kernel
``radardistill_tpu_torch/csrc/mma_rate.cu`` runs eight products of a slightly
rotated A with B out of shared memory, on two routes (``mma.sync`` and
``wgmma.mma_async``). Each case is first held against its plain PyTorch
version; then one line per case and route gives the rate, its share of the
card's published peak, and cuBLAS on the same operands beside it.

Usage (needs the card and nvcc): ``python3 tools/torch_mma_rate.py``
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mma_rate.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.ops.probe_bench import mma_rate_table

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    mma_rate_table(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
