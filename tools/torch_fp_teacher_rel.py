#!/usr/bin/env python3
"""The ``FP_STAGES: 5`` teacher in bfloat16 against the card's own float32
forward of the same batch and weights, on one CUDA card:

    python3 tools/torch_fp_teacher_rel.py [ROOT]

Builds the distillation model of ``radar_distill_train.yaml`` with
``BACKBONE_3D`` ``INT8_STAGES: 1, FP_STAGES: 5`` twice from one seed
(bfloat16 and float32 compute, TF32 off), runs both on the synthetic batch at
grid 512 (20 000 lidar points and 400 radar returns per scene, batch 2), and
prints the rel-L2 of the teacher's ``x_conv4``, ``x_conv5`` and
``spatial_features_2d`` between the two, with K6's launches. ``ROOT`` is the
checkout whose ``radardistill_tpu_torch`` runs (default: this one), so
another commit's tree unpacked with ``git archive`` reads the same figure.
``chip_smoke.py`` reads it through :func:`teacher_rel` and holds this tree's
to at most 1.5x the figure read with every K6 link on ``mma.sync``
(``FP_TEACHER_BF16_REL_BEFORE``). Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

BATCH = dict(grid=512, num_lidar=20000, num_radar=400, num_boxes=10)
KEYS = ("x_conv4", "x_conv5", "spatial_features_2d")


def teacher_rel(torch, dev, batch_kw=None):
    """Both forwards on ``dev`` at ``batch_kw`` (default :data:`BATCH`) ->
    ({feature: rel-L2 of bfloat16 against float32}, {"bfloat16" / "float32":
    K6's launches in that forward, in all and by route where the tree counts
    routes}). Leaves TF32 off for matmuls and cuDNN as it found it."""
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.ops.conv_block import conv_block_fp
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, info, batch = make_batch(TRAIN_YAML, backbone_3d={"INT8_STAGES": 1, "FP_STAGES": 5},
                                  **(BATCH if batch_kw is None else batch_kw))
    bdev = batch_to_torch(batch, dev)
    outs, launches, weights = {}, {}, None

    def counts():
        return {"all": conv_block_fp.launches,
                **getattr(conv_block_fp, "route_launches", {})}  # trees before K6's routes

    for dtype in (torch.bfloat16, torch.float32):
        model = init_random_(build_network(cfg, info, compute_dtype=dtype, device=dev),
                             torch.Generator().manual_seed(0))
        if weights is not None and not all(
                torch.equal(a, b) for a, b in zip(model.state_dict().values(), weights)):
            raise RuntimeError("FP_STAGES: 5 bf16 vs f32: the two models' weights differ")
        weights = list(model.state_dict().values())
        before = counts()
        with torch.no_grad():
            out = model(bdev)
        torch.cuda.synchronize()
        launches[str(dtype)[6:]] = {k: n - before[k] for k, n in counts().items()}
        outs[dtype] = {k: out[k].double() for k in KEYS}
        del model
    rel = {k: (torch.linalg.norm(outs[torch.bfloat16][k] - outs[torch.float32][k])
               / torch.linalg.norm(outs[torch.float32][k])).item() for k in KEYS}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return rel, launches


def report(rel, launches):
    for dtype, n in launches.items():
        print(f"FP_STAGES: 5 teacher, {dtype}: K6 x {n['all']}"
              + "".join(f", {k} {v}" for k, v in n.items() if k != "all"))
    print("FP_STAGES: 5 teacher, bfloat16 forward vs the card's float32 forward, rel-L2: "
          + ", ".join(f"{k} {v:.4e}" for k, v in rel.items()))


def main() -> int:
    here = Path(__file__).resolve().parents[1]
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else here
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_fp_teacher_rel.py: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"the port of {root}")
    report(*teacher_rel(torch, torch.device("cuda", 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
