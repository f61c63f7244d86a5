"""Does the input pipeline set the pace of training on the card?
``python3 tools/torch_train_pace.py [--workers 2 4] [--steps 10]``, from the
repository root, on a machine with a CUDA card.

In one process, in turns: the train step's p50 on a device-resident batch
(``data.synthetic.make_batch(TRAIN_YAML)``: bs2, 1440², 160 000 lidar points
a scene, host tables precomputed once; bf16; the reference's initializers),
then for each worker count one epoch of ``tools/torch_train.py`` on
``tools/cfgs/synthetic/production_cert.yaml`` as shipped (104 samples: 52
steps at bs2, bf16, a log line a step, no post-train eval; the loader,
``HostPrecompute`` and the host-to-card copies in the loop), then the step's
p50 again. Prints, on the card's name and power limit, each epoch's t_iter
and t_data p50 read from its train log (its first step, which builds the
kernels or forks the workers, left out) beside the step p50s. Its outputs
under ``output/production_cert/pace_w*`` are removed.
"""

import argparse
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def step_p50_ms(torch, steps):
    """p50 of ``steps`` synced train steps on one device-resident batch, after
    one warm step."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.train_step import create_train_state, make_train_step
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg

    cfg, info, batch = make_batch(TRAIN_YAML)
    full, _ = production_cfg(TRAIN_YAML)
    model = build_network(cfg, info, compute_dtype=torch.bfloat16)
    state, _ = create_train_state(model, full.OPTIMIZATION, 1000)
    step = make_train_step(model, state.optimizer, cfg, info["class_names"],
                           info["voxel_size"], info["point_cloud_range"])
    b = batch_to_torch(batch)
    step(b)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--steps", type=int, default=10, help="synced steps of each step p50")
    args = parser.parse_args(argv)
    import torch

    from radardistill_tpu_torch.train.trainer import read_log
    from tools import torch_train

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_pace.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    before = step_p50_ms(torch, args.steps)
    epochs = {}
    for w in args.workers:
        tag = f"pace_w{w}"
        out = Path("output") / "production_cert" / tag
        shutil.rmtree(out, ignore_errors=True)
        torch_train.main(["--cfg_file", str(ROOT / "tools/cfgs/synthetic/production_cert.yaml"),
                          "--batch_size", "2", "--workers", str(w), "--log_interval", "1",
                          "--epochs", "1", "--num_epochs_to_eval", "0", "--extra_tag", tag])
        (log,) = out.glob("log_train_*.txt")
        epochs[w] = read_log(log)
        shutil.rmtree(out)
    after = step_p50_ms(torch, args.steps)
    print(f"{smi}: the step on a device-resident batch, p50 of {args.steps}: "
          f"{before:.3f} ms before the epochs, {after:.3f} ms after")
    for w, rows in epochs.items():
        it, data = [r[5] for r in rows[1:]], [r[6] for r in rows[1:]]
        finite = all(r[4] == r[4] and abs(r[4]) != float("inf") for r in rows)
        print(f"{w} workers: {len(rows)} steps, steps 2-{len(rows)}: t_iter p50 "
              f"{statistics.median(it) * 1e3:.1f} ms (min {min(it) * 1e3:.1f}, max "
              f"{max(it) * 1e3:.1f}), t_data p50 {statistics.median(data) * 1e3:.1f} ms (max "
              f"{max(data) * 1e3:.1f}); t_iter p50 / the step's p50 before and after: "
              f"{statistics.median(it) * 1e3 / before:.3f}, "
              f"{statistics.median(it) * 1e3 / after:.3f}; first step t_iter {rows[0][5]} s, "
              f"t_data {rows[0][6]} s; losses finite {finite}")


if __name__ == "__main__":
    main()
