"""Model layer of the port: ``build_network`` for the PillarNet detector and
the anchor family (``PointPillar``, ``SECONDNet``), and the assembly of their
training loss (``compute_training_loss``)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils.profiler import mark_backward, span
from .anchor_detector import AnchorDetector, anchor_training_loss
from .center_head import (HeadSpec, centerhead_loss, flatten_class_channels,
                          flatten_target_heatmaps)
from .detector import PillarNet
from .distill import distill_loss
from .layers import init_reference_

DETECTORS = {"PillarNet": PillarNet, "PointPillar": AnchorDetector, "SECONDNet": AnchorDetector}
ANCHOR_DETECTORS = ("PointPillar", "SECONDNet")


def build_network(model_cfg, dataset_info: Dict[str, Any], compute_dtype=torch.float32,
                  device="cuda", remat=False, generator: torch.Generator | None = None
                  ) -> torch.nn.Module:
    """dataset_info: grid_size (nx, ny), voxel_size, point_cloud_range,
    class_names (as ``utils.production.production_cfg`` returns them). The
    model is built in eval mode on ``device``: the card unless the caller asks
    for ``"cpu"``; ``model.train()`` switches it to the train forward.
    With ``generator`` every parameter is drawn from the reference's
    initializers (``layers.init_reference_``); without, parameters are created
    empty: load them with ``convert.load_jax_variables`` (or, in a test, fill
    them with ``layers.init_random_``). ``remat`` (``MODEL.REMAT``) runs the
    3D backbones and the CMA (``PillarNet``) or the BEV backbone (the anchor
    family) under ``torch.utils.checkpoint`` in a train forward
    (``utils.remat``)."""
    cls = DETECTORS[model_cfg["NAME"]]
    model = cls(model_cfg, tuple(dataset_info["grid_size"]), tuple(dataset_info["voxel_size"]),
                tuple(dataset_info["point_cloud_range"]), tuple(dataset_info["class_names"]),
                compute_dtype=compute_dtype, remat=remat)
    if generator is not None:
        init_reference_(model, generator)
    return model.to(device).eval()


def compute_training_loss(model_cfg, out: Dict[str, Any], class_names, voxel_size,
                          point_cloud_range):
    """The reference's mode dispatch over a train forward's outputs:

      DISTILL absent  -> teacher head loss only
      DISTILL: True   -> distillation (AFD + PFD) + radar head loss
      DISTILL: False  -> radar head loss only

    Returns (loss, tb): the scalar to differentiate and a dict of its terms.
    It runs in the span ``losses`` (the head's loss in ``losses.head``, the
    distillation's in ``losses.distill``), and the loss's backward in
    ``losses.backward``."""
    with span("losses"):
        loss, tb = _training_loss(model_cfg, out, class_names, voxel_size, point_cloud_range)
    mark_backward("losses.backward", loss)
    return loss, tb


def _training_loss(model_cfg, out, class_names, voxel_size, point_cloud_range):
    if model_cfg["NAME"] in ANCHOR_DETECTORS:
        grid = tuple(int(round((point_cloud_range[3 + i] - point_cloud_range[i])
                               / voxel_size[i])) for i in (0, 1))
        return anchor_training_loss(model_cfg, out, class_names, grid, point_cloud_range)
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
    with span("losses.head"):
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
        with span("losses.distill"):
            d_loss, d_tb = distill_loss(d_in)
        loss = loss + d_loss
        tb.update(d_tb)
    if "as_overflow" in out:
        # active-site capacity monitoring: sites dropped this step (should be 0)
        tb["as_overflow"] = out["as_overflow"]
    return loss, tb
