"""The anchor-based single-branch detectors (PointPillar / SECONDNet).

Counterpart of ``radardistill_tpu/models/anchor_detector.py``: a VFE chosen
by ``VFE.NAME`` (``PillarVFE`` on fixed voxels, else the dense
``DynamicPillarVFESimple2D``, whose densify is kernel K5 on the card) ->
``BaseBEVBackbone`` -> ``AnchorHeadSingle``. In train mode
``target_dicts`` (axis-aligned anchor assignment) joins the output when the
batch has ``gt_boxes``; in eval mode the residuals are decoded against the
anchors and the samples go through one call of
``ops.nms.class_agnostic_nms_batched`` (a problem a sample) into the
fixed-shape ``final_box_dicts`` of ``PillarNet``. ``anchor_training_loss``
is the loss (``models.compute_training_loss`` routes ``PointPillar`` and
``SECONDNet`` to it). The model has no frozen scopes: ``frozen`` is empty.
With ``remat`` the BEV backbone runs under ``torch.utils.checkpoint`` in a
train forward (``utils.remat``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..ops.nms import class_agnostic_nms_batched
from .anchor_head import (AnchorHeadSingle, ResidualCoder, anchor_head_loss,
                          assign_anchor_targets, decode_anchor_predictions, generate_anchors)
from .bev_backbone import BaseBEVBackbone
from ..utils.profiler import mark_backward, span
from ..utils.remat import remat_call
from .vfe import DynamicPillarVFESimple2D, PillarVFE

LIDAR_FEATURES = 5  # x, y, z, intensity, time


def build_anchor_assets(head_cfg, grid_size, point_cloud_range, class_names, device="cpu"):
    """The static anchor stack and the per-class thresholds of
    ``ANCHOR_GENERATOR_CONFIG``: (anchors_per_class [(H, W, n, 7)...],
    anchors_flat (A, 7), class_ids 1-based, matched_thr, unmatched_thr,
    n_per_loc, coder), the tensors on ``device``."""
    gen_cfgs = head_cfg["ANCHOR_GENERATOR_CONFIG"]
    ta = head_cfg["TARGET_ASSIGNER_CONFIG"]
    anchors = [torch.from_numpy(a).to(device) for a in generate_anchors(
        gen_cfgs, grid_size, point_cloud_range, ta.get("FEATURE_MAP_STRIDE", 2))]
    name_to_id = {n: i + 1 for i, n in enumerate(class_names)}
    class_ids = [name_to_id[c["class_name"]] for c in gen_cfgs]
    matched = [c.get("matched_threshold", 0.6) for c in gen_cfgs]
    unmatched = [c.get("unmatched_threshold", 0.45) for c in gen_cfgs]
    coder = ResidualCoder(code_size=7,
                          encode_angle_by_sincos=ta.get("ENCODE_ANGLE_BY_SINCOS", False))
    n_per_loc = sum(a.shape[2] for a in anchors)
    flat = torch.cat(anchors, dim=-2).reshape(-1, 7)
    return anchors, flat, class_ids, matched, unmatched, n_per_loc, coder


class AnchorDetector(nn.Module):
    """Build with ``models.build_network`` (``NAME: PointPillar`` or
    ``SECONDNet``). The batch holds ``points`` / ``points_mask`` (the dense
    VFE) or ``voxels`` / ``voxel_num_points`` / ``voxel_coords``
    (``PillarVFE``), and ``gt_boxes`` to train."""

    def __init__(self, model_cfg, grid_size, voxel_size, point_cloud_range, class_names,
                 compute_dtype=torch.float32, remat=False,
                 num_point_features: int = LIDAR_FEATURES):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.grid_size = tuple(grid_size)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.class_names = tuple(class_names)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.frozen = set()
        vfe = cfg["VFE"]
        common = dict(num_filters=tuple(vfe["NUM_FILTERS"]), voxel_size=self.voxel_size,
                      point_cloud_range=self.point_cloud_range, grid_size=self.grid_size,
                      num_point_features=num_point_features, use_norm=vfe.get("USE_NORM", True),
                      with_distance=vfe.get("WITH_DISTANCE", False),
                      use_absolute_xyz=vfe.get("USE_ABSLOTE_XYZ", True))
        if vfe.get("NAME", "DynamicPillarVFESimple2D") == "PillarVFE":
            self.vfe = PillarVFE(**common)
        else:
            self.vfe = DynamicPillarVFESimple2D(
                use_cluster_xyz=vfe.get("USE_CLUSTER_XYZ", True), dtype=compute_dtype, **common)
        b2d = cfg["BACKBONE_2D"]
        self.backbone_2d = BaseBEVBackbone(
            self.vfe.output_dim, tuple(b2d["LAYER_NUMS"]), tuple(b2d["LAYER_STRIDES"]),
            tuple(b2d["NUM_FILTERS"]), tuple(b2d.get("UPSAMPLE_STRIDES", ())),
            tuple(b2d.get("NUM_UPSAMPLE_FILTERS", ())))
        hc = cfg["DENSE_HEAD"]
        assets = build_anchor_assets(hc, self.grid_size, self.point_cloud_range,
                                     self.class_names)
        anchors, flat, self.anchor_class_ids, self.matched_thr, self.unmatched_thr, n_per_loc, \
            self.coder = assets
        for i, a in enumerate(anchors):
            self.register_buffer(f"anchors_{i}", a, persistent=False)
        self.n_anchor_classes = len(anchors)
        self.register_buffer("anchors_flat", flat, persistent=False)
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.out_channels, len(self.class_names), n_per_loc,
            self.coder.code_size, hc.get("NUM_DIR_BINS", 2),
            hc.get("USE_DIRECTION_CLASSIFIER", True))

    @property
    def anchors_per_class(self):
        return [getattr(self, f"anchors_{i}") for i in range(self.n_anchor_classes)]

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self._forward(batch)

    def _forward(self, batch):
        cfg = self.model_cfg
        out: Dict[str, Any] = {}
        with span("vfe"):
            if "voxels" in batch:
                bev, _ = self.vfe(batch["voxels"], batch["voxel_num_points"],
                                  batch["voxel_coords"])
            else:
                bev, _ = self.vfe(batch["points"], batch["points_mask"])
            mark_backward("vfe.backward", bev)
        with span("backbone_2d"):
            sp2d, _ = remat_call(self.remat and self.training, self.backbone_2d,
                                 bev.to(self.compute_dtype))
            mark_backward("backbone_2d.backward", sp2d)
        out["spatial_features_2d"] = sp2d
        with span("dense_head"):
            preds = self.dense_head(sp2d)
            mark_backward("dense_head.backward", preds)
        out["anchor_preds"] = preds
        if self.training:
            if "gt_boxes" in batch:
                with span("assign_targets"):
                    out["target_dicts"] = assign_anchor_targets(
                        self.anchors_per_class, batch["gt_boxes"].float(),
                        self.anchor_class_ids, self.coder, self.matched_thr, self.unmatched_thr)
            return out

        hc = cfg["DENSE_HEAD"]
        pp = cfg.get("POST_PROCESSING", hc.get("POST_PROCESSING", {}))
        with span("decode_and_nms"):
            scores, boxes = decode_anchor_predictions(
                {k: v.float() for k, v in preds.items()}, self.anchors_flat, self.coder,
                dir_offset=hc.get("DIR_OFFSET", 0.78539),
                dir_limit_offset=hc.get("DIR_LIMIT_OFFSET", 0.0),
                num_dir_bins=hc.get("NUM_DIR_BINS", 2))
            best, labels = scores.max(dim=-1)
            labels1 = labels + 1
            nms_cfg = pp.get("NMS_CONFIG", {})
            sel, sel_valid = class_agnostic_nms_batched(
                boxes, best, torch.ones_like(best, dtype=torch.bool),
                nms_thresh=float(nms_cfg.get("NMS_THRESH", 0.2)),
                pre_max=int(nms_cfg.get("NMS_PRE_MAXSIZE", 1024)),
                post_max=int(nms_cfg.get("NMS_POST_MAXSIZE", 83)),
                score_thresh=float(pp.get("SCORE_THRESH", 0.1)))
            out["final_box_dicts"] = {
                "boxes": torch.gather(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1])),
                "scores": torch.gather(best, 1, sel),
                "labels": torch.gather(labels1, 1, sel),
                "valid": sel_valid}
        return out


_LOSS_ASSETS = {}  # the last configuration's anchors, on its device


def anchor_training_loss(model_cfg, out, class_names, grid_size, point_cloud_range):
    """The anchor head's loss over a train forward's outputs
    (anchor_head_template.get_loss). Returns (loss, tb)."""
    hc = model_cfg["DENSE_HEAD"]
    dev = out["anchor_preds"]["cls_preds"].device
    key = (repr(hc["ANCHOR_GENERATOR_CONFIG"]), repr(hc["TARGET_ASSIGNER_CONFIG"]),
           tuple(grid_size), tuple(point_cloud_range), tuple(class_names), str(dev))
    if key not in _LOSS_ASSETS:
        _LOSS_ASSETS.clear()
        _LOSS_ASSETS[key] = build_anchor_assets(hc, grid_size, point_cloud_range, class_names,
                                                dev)
    _, flat, _, _, _, _, coder = _LOSS_ASSETS[key]
    lw = hc["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    return anchor_head_loss(
        out["anchor_preds"], out["target_dicts"], flat, num_class=len(class_names), coder=coder,
        cls_weight=lw.get("cls_weight", 1.0), loc_weight=lw.get("loc_weight", 2.0),
        dir_weight=lw.get("dir_weight", 0.2), code_weights=lw.get("code_weights", None),
        dir_offset=hc.get("DIR_OFFSET", 0.78539), num_dir_bins=hc.get("NUM_DIR_BINS", 2))
