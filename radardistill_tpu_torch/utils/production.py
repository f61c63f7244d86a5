"""The shipped model configurations, as the port's entry points load them.

The port's copy of ``radardistill_tpu/utils/production.py``: it loads the
shipped yaml files under ``tools/cfgs/radar_distill/`` (data, shared by both
packages) with the port's own ``config`` module and derives ``dataset_info``
the way the data layer does, so the port builds what ``tools/train.py
--cfg_file .../radar_distill_train.yaml`` builds. ``tests/test_torch_host.py``
holds it equal to the original.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CFG_DIR = os.path.join(REPO_ROOT, "tools", "cfgs", "radar_distill")

TRAIN_YAML = "radar_distill_train.yaml"
VAL_YAML = "radar_distill_val.yaml"


def load_shipped_cfg(yaml_name: str = TRAIN_YAML):
    from ..config import ConfigDict, cfg_from_yaml_file

    cfg = ConfigDict()
    cfg_from_yaml_file(os.path.join(CFG_DIR, yaml_name), cfg)
    return cfg


def production_cfg(yaml_name: str = TRAIN_YAML, grid: Optional[int] = None) -> Tuple[object, dict]:
    """(full cfg, dataset_info) from the shipped yaml.

    `grid` is a DEV-ONLY override that rescales the point-cloud range at the
    shipped voxel size (used by small-grid smoke runs); grid=None or the
    native 1440 returns the yaml untouched — asserted by
    tests/test_torch_host.py.
    """
    cfg = load_shipped_cfg(yaml_name)
    proc = [
        p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
        if p["NAME"].startswith("transform_points_to_voxels")
    ][0]
    voxel = [float(v) for v in proc["VOXEL_SIZE"]]
    pc = [float(v) for v in cfg.DATA_CONFIG.POINT_CLOUD_RANGE]
    native = int(round((pc[3] - pc[0]) / voxel[0]))
    if grid is not None and grid != native:
        assert grid % 32 == 0, grid
        extent = grid * voxel[0] / 2
        pc = [-extent, -extent, pc[2], extent, extent, pc[5]]
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(pc)
        rb2 = cfg.MODEL.get("RADAR_BACKBONE_2D", None)
        if rb2 is not None and "GRID_SIZE" in rb2:
            rb2.POINT_CLOUD_RANGE = list(pc)
            rb2.GRID_SIZE = [grid, grid, 1]

    return cfg, dataset_info(cfg)


def dataset_info(cfg) -> dict:
    """The ``dataset_info`` a full config's data layer gives the model: grid,
    voxel size and range from ``DATA_CONFIG`` as float32 values floated back
    (processor.py:74, dataset.py:40, as tools/train.py reads them), and the
    class names."""
    import numpy as np

    proc = [
        p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
        if p["NAME"].startswith("transform_points_to_voxels")
    ][0]
    voxel32 = [float(v) for v in np.asarray(proc["VOXEL_SIZE"], np.float64).astype(np.float32)]
    pc32 = [float(v) for v in np.asarray(cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                                         np.float64).astype(np.float32)]
    g = int(round((pc32[3] - pc32[0]) / voxel32[0]))
    return {
        "grid_size": (g, g),
        "voxel_size": tuple(voxel32),
        "point_cloud_range": tuple(pc32),
        "class_names": tuple(cfg.CLASS_NAMES),
    }
