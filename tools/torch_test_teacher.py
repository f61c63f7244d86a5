"""Teacher-only evaluation of the PyTorch port: ``python
tools/torch_test_teacher.py --teacher_ckpt FILE``, run from the repository
root.

Counterpart of ``tools/test_teacher.py`` (reference tools/test_teacher.py:
evaluate the LiDAR teacher with the lidar-only ``pillarnet.yaml`` from
``--teacher_ckpt``): ``tools/torch_test.py`` with that configuration, that
checkpoint and the tag ``teacher``. Other arguments (``--device``,
``--infer_time``, ``--set ...``) pass through to it. Returns its evaluation's
dict.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
TEACHER_YAML = str(Path(__file__).resolve().parent / "cfgs" / "nuscenes_models" / "pillarnet.yaml")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, default=TEACHER_YAML)
    parser.add_argument("--teacher_ckpt", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--extra_tag", type=str, default="teacher")
    args, extra = parser.parse_known_args(argv)

    from tools import torch_test

    return torch_test.main(["--cfg_file", args.cfg_file, "--ckpt", args.teacher_ckpt,
                            "--batch_size", str(args.batch_size),
                            "--extra_tag", args.extra_tag] + extra)


if __name__ == "__main__":
    main()
