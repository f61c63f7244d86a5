"""Time the port's reader of the JAX package's checkpoints:
``python tools/torch_jax_ckpt_read.py [DIR ...] [--repeat N]``.

Each ``DIR`` (default: the two epochs of the committed fixture,
``tests/fixtures/jax_run``) is an orbax checkpoint directory of the JAX
package. ``train/jax_ckpt.py::read_checkpoint`` reads it ``N`` times (default
3); the line of each gives its bytes on disk, the bytes of the tensors read,
the number of tensors, each read's seconds and the median's seconds per GB of
tensors. The reader runs on the host CPU alone, so on the card's machine the
figure is that host's; ``nvidia-smi``'s name and power limit are printed
where there is a card. Run from the repository root.
"""

import argparse
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "jax_run"


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if hasattr(tree, "untyped_storage") else []


def cpu_name() -> str:
    """The host CPU: its model name where /proc/cpuinfo gives one, its
    architecture and its number of cores."""
    name = "model unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"{name}, {platform.machine()}, {os.cpu_count()} cores"


def read_rate(path, repeat: int = 3) -> dict:
    """``repeat`` reads of the checkpoint directory ``path``: bytes on disk,
    bytes and number of the tensors read, each read's seconds, the median's
    seconds per GB (1e9 bytes) of tensors, and the last read's tree."""
    from radardistill_tpu_torch.train.jax_ckpt import read_checkpoint

    path = Path(path)
    seconds = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        tree = read_checkpoint(path)
        seconds.append(time.perf_counter() - t0)
    tensors = _tensors(tree)
    decoded = sum(t.numel() * t.element_size() for t in tensors)
    disk = sum(p.stat().st_size for p in path.rglob("*") if p.is_file())
    return {"path": str(path), "disk_bytes": disk, "tensor_bytes": decoded,
            "tensors": len(tensors), "seconds": seconds,
            "s_per_gb": statistics.median(seconds) / (decoded / 1e9), "tree": tree}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("dirs", nargs="*", default=[str(FIXTURE / "checkpoint_epoch_1"),
                                                    str(FIXTURE / "checkpoint_epoch_2")])
    parser.add_argument("--repeat", type=int, default=3)
    args = parser.parse_args(argv)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        smi = "no card"
    print(f"host CPU: {cpu_name()}; card: {smi}")
    out = []
    for d in args.dirs:
        r = read_rate(d, args.repeat)
        r.pop("tree")
        print(f"{r['path']}: {r['disk_bytes']} bytes on disk, {r['tensors']} tensors of "
              f"{r['tensor_bytes']} bytes; reads {', '.join(f'{s:.4f}' for s in r['seconds'])} "
              f"s; {r['s_per_gb']:.4f} s per GB of tensors")
        out.append(r)
    return out


if __name__ == "__main__":
    main()
