"""Teacher->student init checkpoint surgery for the PyTorch port:
``python tools/torch_ckpt_surgery.py --src TEACHER --dst INIT``.

Counterpart of ``tools/ckpt_surgery.py`` (reference ckpt.py:1-22: load the
LiDAR teacher checkpoint and duplicate every weight under its radar twin, so
the student branch starts from the LiDAR weights) on the port's checkpoint
file (``train/checkpoint.py``): ``duplicate_teacher_to_radar`` over its
``model_state``, parameters and BN statistics alike, copying where the shapes
match (the radar VFE's first linear keeps its own init: 6 raw radar features
against the lidar's 5). An orbax checkpoint of the JAX package is not read
here: ``orbax`` imports ``jax``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", required=True, help="teacher checkpoint file")
    parser.add_argument("--dst", required=True, help="output init checkpoint file")
    args = parser.parse_args(argv)

    import torch

    from radardistill_tpu_torch.train.checkpoint import duplicate_teacher_to_radar

    payload = torch.load(args.src, map_location="cpu", weights_only=True)
    payload["model_state"] = duplicate_teacher_to_radar(payload["model_state"])
    torch.save(payload, args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
