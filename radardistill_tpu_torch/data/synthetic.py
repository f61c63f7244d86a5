"""Synthetic scenes and the two synthetic batches the port's entry points use.

``make_scene`` is the port's copy of ``radardistill_tpu/data/synthetic.py``
(deterministic scenes from a seed). ``make_batch`` builds, for a shipped yaml,
the collated and host-precomputed batch that the JAX package's ``bench.py``
feeds its model (or, with ``host_precompute=False``, the collated batch alone,
whose tables the model then builds on the device):

  - ``radar_distill_val.yaml`` (the default): one scene, 3000 radar returns,
    40 boxes, the lidar points dropped, 8192 radar slots;
  - ``radar_distill_train.yaml``: two scenes of 160 000 lidar points and 3000
    radar returns, 60 boxes, 4096 radar slots, 500 box slots.
"""

from __future__ import annotations

import numpy as np

from ..utils.production import TRAIN_YAML, VAL_YAML, production_cfg
from .collate import collate_batch
from .host_precompute import HostPrecompute

# the sizes of each yaml's batch: scenes, lidar points (None = dropped), radar
# returns, boxes, radar slots
BATCH_SIZES = {
    VAL_YAML: dict(batch_size=1, num_lidar=None, num_radar=3000, num_boxes=40,
                   max_radar_points=8192),
    TRAIN_YAML: dict(batch_size=2, num_lidar=160_000, num_radar=3000, num_boxes=60,
                     max_radar_points=4096),
}


def make_scene(
    seed: int,
    num_lidar: int = 2000,
    num_radar: int = 200,
    num_boxes: int = 10,
    num_classes: int = 10,
    pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
    lidar_feats: int = 5,
    radar_feats: int = 6,
):
    """Returns dict(points (N,5) xyzit, radar_points (M,6) xyz+rcs+vxy,
    gt_boxes (K, 10) [x,y,z,dx,dy,dz,heading,vx,vy,cls])."""
    rng = np.random.RandomState(seed)
    lo = np.array(pc_range[:3])
    hi = np.array(pc_range[3:])

    boxes = np.zeros((num_boxes, 10), np.float32)
    boxes[:, 0:2] = rng.uniform(lo[0] * 0.8, hi[0] * 0.8, (num_boxes, 2))
    boxes[:, 2] = rng.uniform(-2, 0.5, num_boxes)
    boxes[:, 3:5] = rng.uniform(0.5, 6.0, (num_boxes, 2))
    boxes[:, 5] = rng.uniform(0.8, 3.0, num_boxes)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, num_boxes)
    boxes[:, 7:9] = rng.uniform(-3, 3, (num_boxes, 2))
    boxes[:, 9] = rng.randint(1, num_classes + 1, num_boxes)

    def cloud(n, nf):
        pts = np.zeros((n, nf), np.float32)
        # half background, half on objects (so detection is learnable)
        nb = n // 2
        pts[:nb, 0:3] = rng.uniform(lo, hi, (nb, 3))
        per_box = max((n - nb) // max(num_boxes, 1), 1)
        i = nb
        for b in boxes:
            k = min(per_box, n - i)
            if k <= 0:
                break
            local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
            c, s = np.cos(b[6]), np.sin(b[6])
            pts[i : i + k, 0] = local[:, 0] * c - local[:, 1] * s + b[0]
            pts[i : i + k, 1] = local[:, 0] * s + local[:, 1] * c + b[1]
            pts[i : i + k, 2] = local[:, 2] + b[2]
            i += k
        pts[:, 3:] = rng.uniform(0, 1, (n, nf - 3))
        return pts

    return {
        "points": cloud(num_lidar, lidar_feats),
        "radar_points": cloud(num_radar, radar_feats),
        "gt_boxes": boxes,
        "frame_id": f"synthetic_{seed}",
    }


def make_batch(yaml_name=VAL_YAML, grid=None, seed=0, backbone_3d=None, radar_backbone_3d=None,
               host_precompute=True, **sizes):
    """(model cfg, dataset info, host-precomputed numpy batch) for a shipped
    yaml. ``grid`` rescales the range, for small runs; ``backbone_3d``
    overrides keys of the yaml's ``MODEL.BACKBONE_3D`` (another configuration
    of the teacher, e.g. ``{"INT8_STAGES": 5}`` or ``{"FP_STAGES": 5}``);
    ``sizes`` override the yaml's entry of ``BATCH_SIZES`` (e.g.
    ``num_lidar=4000`` for a small grid). Scene ``i`` of the batch is
    ``make_scene(seed + i, ...)``."""
    sz = dict(BATCH_SIZES[yaml_name], **sizes)
    full, info = production_cfg(yaml_name, grid=grid)
    cfg = full.MODEL
    if backbone_3d:
        cfg.BACKBONE_3D.update(backbone_3d)
    if radar_backbone_3d:
        cfg.RADAR_BACKBONE_3D.update(radar_backbone_3d)
    scenes = []
    for i in range(sz["batch_size"]):
        scene = make_scene(seed + i, num_lidar=sz["num_lidar"] or 100,
                           num_radar=sz["num_radar"], num_boxes=sz["num_boxes"],
                           pc_range=info["point_cloud_range"])
        if sz["num_lidar"] is None:
            del scene["points"]
        scenes.append(scene)
    caps = {"MAX_RADAR_POINTS": sz["max_radar_points"], "NUM_MAX_OBJS": 500}
    if sz["num_lidar"] is not None:
        caps["MAX_LIDAR_POINTS"] = sz["num_lidar"]
    batch = collate_batch(scenes, caps)
    batch.pop("_host", None)
    if host_precompute:
        batch = HostPrecompute(cfg, info["grid_size"], info["voxel_size"],
                               info["point_cloud_range"])(batch)
    return cfg, info, batch
