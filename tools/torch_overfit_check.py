"""Single-scene overfit check of the PyTorch port: ``python
tools/torch_overfit_check.py [steps] [grid] [--device cuda|cpu]``, run from the
repository root.

Counterpart of ``tools/overfit_check.py`` (the reference's ``_single`` pkl
smoke as a correctness gate): train the full distillation graph of
``utils/testing.make_model_cfg`` (the dense LiDAR teacher unfrozen beside the
radar student, bfloat16) on ONE synthetic scene and check that the
detections converge onto its boxes: the loss halves and the centre-distance
AP of the scene exceeds 0.25. Prints a line every 50 steps, then ``final mAP
on the overfit scene: ...`` and ``OVERFIT CHECK PASSED``; a failed check
raises. ``main`` returns ``{"ap": ..., "losses": [...], "seconds": ...}``.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

OPTIM = dict(OPTIMIZER="adam_onecycle", LR=1e-3, WEIGHT_DECAY=0.01, MOMS=[0.95, 0.85],
             PCT_START=0.4, DIV_FACTOR=10, GRAD_NORM_CLIP=10)
CAPS = {"MAX_LIDAR_POINTS": 8192, "MAX_RADAR_POINTS": 1024, "NUM_MAX_OBJS": 64}


def scene_batch(seed, info, device):
    """One synthetic scene (6000 lidar points, 900 radar returns, 8 boxes)
    and its collated batch on ``device``, without host tables (the model
    builds them on the device)."""
    from radardistill_tpu_torch.data.collate import collate_batch
    from radardistill_tpu_torch.data.synthetic import make_scene
    from radardistill_tpu_torch.models.detector import batch_to_torch

    scene = make_scene(seed, num_lidar=6000, num_radar=900, num_boxes=8,
                       pc_range=info["point_cloud_range"])
    b = collate_batch([scene], CAPS)
    b.pop("_host", None)
    return scene, batch_to_torch(b, device)


def scene_ap(model, batch, scene):
    """Mean centre-distance AP of the eval forward's detections on ``scene``."""
    from radardistill_tpu_torch.data.nuscenes.eval_bridge import center_distance_ap
    from radardistill_tpu_torch.train.train_step import make_eval_step
    from radardistill_tpu_torch.utils.testing import CLASS_NAMES

    fb = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
          for k, v in make_eval_step(model)(batch)["final_box_dicts"].items()}
    v = fb["valid"][0]
    det_names = np.array([CLASS_NAMES[int(lab) - 1] for lab in fb["labels"][0][v]])
    gt_names = np.array([CLASS_NAMES[int(c) - 1] for c in scene["gt_boxes"][:, 9]])
    aps = center_distance_ap([scene["gt_boxes"]], [gt_names], [fb["boxes"][0][v]],
                             [fb["scores"][0][v]], [det_names], CLASS_NAMES)
    vals = [np.mean(list(x.values())) for x in aps.values()]
    return float(np.mean(vals)) if vals else 0.0


def main(argv=None):
    p = argparse.ArgumentParser()
    # 600 (not 300), as the reference's tool: at 300 steps its best score sat
    # just under SCORE_THRESH
    p.add_argument("steps", type=int, nargs="?", default=600)
    p.add_argument("grid", type=int, nargs="?", default=256)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    import torch

    from radardistill_tpu_torch.config import ConfigDict
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.train_step import create_train_state, make_train_step
    from radardistill_tpu_torch.utils.testing import CLASS_NAMES, make_model_cfg

    cfg, info = make_model_cfg(grid=args.grid, num_max_objs=64, k_per_head=128, nms_post=32)
    # unfreeze the teacher so it can learn the scene too (it starts random)
    cfg.FREEZE_PIPELINE = []
    model = build_network(cfg, info, compute_dtype=torch.bfloat16, device=args.device)
    scene, batch = scene_batch(0, info, args.device)
    state, _ = create_train_state(model, ConfigDict(OPTIM), args.steps)
    step = make_train_step(model, state.optimizer, cfg, CLASS_NAMES, info["voxel_size"],
                           info["point_cloud_range"])

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        m = step(batch)
        if i % 50 == 0 or i == args.steps - 1:
            losses.append(float(m["loss"]))
            print(f"step {i}: loss {losses[-1]:.3f} ({time.time() - t0:.0f}s)", flush=True)
    ap = scene_ap(model, batch, scene)
    seconds = time.time() - t0
    print(f"final mAP on the overfit scene: {ap:.3f}; loss {losses[0]:.1f} -> {losses[-1]:.1f} "
          f"({args.steps} steps, grid {args.grid}, {seconds:.1f} s on {args.device})")
    assert losses[-1] < losses[0] * 0.5, "loss did not drop enough"
    assert ap > 0.25, f"overfit AP too low: {ap}"
    print("OVERFIT CHECK PASSED")
    return {"ap": ap, "losses": losses, "seconds": seconds}


if __name__ == "__main__":
    main()
