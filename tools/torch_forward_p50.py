"""p50 of the bfloat16 val forward (bs1) and distillation eval forward (bs2)
at 1440² on the card, for the tree in the working directory: one reading a
process, the kernels built into that tree's ``build/``.

    python3 tools/torch_forward_p50.py

To hold two trees against each other, run it from each in turns in one chip
call, the other tree unpacked with ``git archive`` into a directory that
``.gitignore`` lists: ``(cd OTHER && python3 ../../tools/torch_forward_p50.py)``,
then this tree, this tree, the other.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())


def forward_p50(yaml_name, runs, warm=5):
    """(p50, min) ms of synced bfloat16 eval forwards of ``yaml_name``'s
    synthetic batch with seeded random weights."""
    import torch

    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_

    cfg, info, batch = make_batch(yaml_name)
    model = init_random_(build_network(cfg, info, compute_dtype=torch.bfloat16),
                         torch.Generator().manual_seed(0)).eval()
    b = batch_to_torch(batch)
    times = []
    with torch.no_grad():
        for i in range(runs + warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(b)
            torch.cuda.synchronize()
            if i >= warm:
                times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2], times[0]


def main():
    import torch

    from radardistill_tpu_torch.ops import cuda_lib
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, VAL_YAML

    if not torch.cuda.is_available():
        raise SystemExit("torch_forward_p50.py: no CUDA device")
    cuda_lib.build()
    out = []
    for name, yaml_name, runs in (("val", VAL_YAML, 40), ("distill", TRAIN_YAML, 20)):
        p50, lo = forward_p50(yaml_name, runs)
        out.append(f"{name} p50 {p50:.3f} min {lo:.3f} ms")
    print(f"{os.path.basename(os.getcwd())} on {torch.cuda.get_device_name(0)}: " + "; ".join(out))


if __name__ == "__main__":
    main()
