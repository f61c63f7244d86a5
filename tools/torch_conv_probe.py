#!/usr/bin/env python3
"""What a 3x3 convolution costs beyond its nine products, on one NVIDIA GPU.

The PyTorch + CUDA counterpart of ``tools/pallas_conv_proto.py``: P1's three
modes (``dots``: nine tap products without shifted views; ``conv``: the
convolution; ``int8``: the nine products in int8 with a quantizing epilogue)
on its two routes, ``mma.sync`` (``radardistill_tpu_torch/csrc/conv_probe.cu``)
and the TMA + ``wgmma`` conv mainloop (``csrc/conv3x3_wgmma.cu``, also timed
by its launch alone), at the TPU tool's shape,
(2, 720 + 2, 720, 128) x 128 and x 512, and at the other 3x3 links of the
teacher's float chain. Each case is first held against its plain PyTorch
version; then one line per case gives the time, the rate and its share of the
card's published peak, and cuDNN's ``F.conv2d`` beside ``conv``. Subtract:
``conv`` - ``dots`` is the cost of the shifted views, ``dots`` against
``tools/torch_mma_rate.py`` at the same N the cost of streaming the operands.

Usage (needs the card and nvcc): ``python3 tools/torch_conv_probe.py``
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_probe.py: no CUDA device", file=sys.stderr)
        return 2
    from radardistill_tpu_torch.ops.probe_bench import conv_probe_table

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    conv_probe_table(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
