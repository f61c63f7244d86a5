"""The synthetic serving batch of the radar-only val configuration.

The scene and collation are the JAX package's jax-free ``make_scene`` and
``collate_batch``, with the inputs ``bench.py::infer_bench`` uses (one scene,
3000 radar returns, 40 boxes, the lidar points dropped, 8192 radar slots);
``data.host_precompute.HostPrecompute`` then adds the pillar and site tables.
"""

from __future__ import annotations

from radardistill_tpu.data.collate import collate_batch
from radardistill_tpu.data.synthetic import make_scene
from radardistill_tpu.utils.production import VAL_YAML, production_cfg

from .host_precompute import HostPrecompute


def make_batch(grid=None, seed=0):
    """(model cfg, dataset info, host-precomputed numpy batch) for the shipped
    ``radar_distill_val.yaml``; ``grid`` rescales the range, for small runs."""
    full, info = production_cfg(VAL_YAML, grid=grid)
    cfg = full.MODEL
    scene = make_scene(seed, num_lidar=100, num_radar=3000, num_boxes=40,
                       pc_range=info["point_cloud_range"])
    del scene["points"]
    batch = collate_batch([scene], {"MAX_RADAR_POINTS": 8192, "NUM_MAX_OBJS": 500})
    batch.pop("_host", None)
    batch = HostPrecompute(cfg, info["grid_size"], info["voxel_size"],
                           info["point_cloud_range"])(batch)
    return cfg, info, batch
