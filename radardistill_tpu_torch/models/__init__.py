"""Model layer of the port: ``build_network`` for the PillarNet detector."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .detector import PillarNet

DETECTORS = {"PillarNet": PillarNet}


def build_network(model_cfg, dataset_info: Dict[str, Any], compute_dtype=torch.float32,
                  device="cuda") -> PillarNet:
    """dataset_info: grid_size (nx, ny), voxel_size, point_cloud_range,
    class_names (as ``utils.production.production_cfg`` returns them). The
    model is built in eval mode on ``device``: the card unless the caller asks
    for ``"cpu"``. Parameters are created empty: load them with
    ``convert.load_jax_variables`` or fill them with ``layers.init_random_``."""
    cls = DETECTORS[model_cfg["NAME"]]
    model = cls(model_cfg, tuple(dataset_info["grid_size"]), tuple(dataset_info["voxel_size"]),
                tuple(dataset_info["point_cloud_range"]), tuple(dataset_info["class_names"]),
                compute_dtype=compute_dtype)
    return model.to(device).eval()
