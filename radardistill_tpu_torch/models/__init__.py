"""Model layer of the port: ``build_network`` for the PillarNet detector and
the assembly of its training loss (``compute_training_loss``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from .center_head import (HeadSpec, centerhead_loss, flatten_class_channels,
                          flatten_target_heatmaps)
from .detector import PillarNet
from .distill import distill_loss

DETECTORS = {"PillarNet": PillarNet}
ANCHOR_DETECTORS = ("PointPillar", "SECONDNet")


def build_network(model_cfg, dataset_info: Dict[str, Any], compute_dtype=torch.float32,
                  device="cuda", remat=False) -> PillarNet:
    """dataset_info: grid_size (nx, ny), voxel_size, point_cloud_range,
    class_names (as ``utils.production.production_cfg`` returns them). The
    model is built in eval mode on ``device``: the card unless the caller asks
    for ``"cpu"``; ``model.train()`` switches it to the train forward.
    Parameters are created empty: load them with
    ``convert.load_jax_variables`` or fill them with ``layers.init_random_``."""
    if remat:
        raise NotImplementedError("remat (activation rematerialization) is not ported")
    cls = DETECTORS[model_cfg["NAME"]]
    model = cls(model_cfg, tuple(dataset_info["grid_size"]), tuple(dataset_info["voxel_size"]),
                tuple(dataset_info["point_cloud_range"]), tuple(dataset_info["class_names"]),
                compute_dtype=compute_dtype)
    return model.to(device).eval()


def compute_training_loss(model_cfg, out: Dict[str, Any], class_names, voxel_size,
                          point_cloud_range):
    """The reference's mode dispatch over a train forward's outputs:

      DISTILL absent  -> teacher head loss only
      DISTILL: True   -> distillation (AFD + PFD) + radar head loss
      DISTILL: False  -> radar head loss only

    Returns (loss, tb): the scalar to differentiate and a dict of its terms."""
    if model_cfg["NAME"] in ANCHOR_DETECTORS:
        raise NotImplementedError(
            f"anchor_training_loss (the {model_cfg['NAME']} anchor family) is not ported")
    distill_flag = model_cfg.get("DISTILL", None)
    # the radar head carries the supervised loss whenever a radar branch is
    # trained (distillation or student only)
    use_radar = "RADAR_DENSE_HEAD" in model_cfg and (
        distill_flag is not None or "DENSE_HEAD" not in model_cfg)
    head_cfg = model_cfg["RADAR_DENSE_HEAD" if use_radar else "DENSE_HEAD"]
    spec = HeadSpec(head_cfg["CLASS_NAMES_EACH_HEAD"], class_names)
    preds = out["radar_preds" if use_radar else "lidar_preds"]
    targets = out["target_dicts"]
    hw = tuple(targets["heatmaps"].shape[2:4])

    lw = head_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    heads = head_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]
    loss, tb = centerhead_loss(
        preds, targets, spec, code_weights=lw["code_weights"], cls_weight=lw["cls_weight"],
        loc_weight=lw["loc_weight"], hw=hw,
        feature_map_stride=head_cfg["TARGET_ASSIGNER_CONFIG"]["FEATURE_MAP_STRIDE"],
        voxel_size=voxel_size, point_cloud_range=point_cloud_range,
        with_iou="iou" in heads, iou_reg=bool(head_cfg.get("IOU_REG", False)))

    if distill_flag:
        d_in = {k: out[k] for k in (
            "x_conv4", "radar_spatial_features_8x_2", "radar_spatial_features_8x_1",
            "spatial_features_2d", "spatial_features_2d_8x",
            "radar_spatial_features_2d", "radar_spatial_features_2d_8x")}
        d_in["heatmaps"] = flatten_target_heatmaps(spec, targets["heatmaps"])
        d_in["radar_hm_preds"] = flatten_class_channels(spec, preds["hm"])
        d_loss, d_tb = distill_loss(d_in)
        loss = loss + d_loss
        tb.update(d_tb)
    if "as_overflow" in out:
        # active-site capacity monitoring: sites dropped this step (should be 0)
        tb["as_overflow"] = out["as_overflow"]
    return loss, tb
