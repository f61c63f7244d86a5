"""PillarNet, radar-only branch, eval.

Counterpart of ``radardistill_tpu/models/detector.py::PillarNet`` for the
radar-only serving configuration (``radar_distill_val.yaml``): radar VFE
table -> active-site backbone (DENSE_FROM 5) -> CMA hourglass -> neck ->
merged-hidden CenterHead -> decode + NMS. Submodule names are the flax scope
names (``radar_vfe``, ``radar_backbone_3d``, ``radar_cma``, ``radar_neck``,
``radar_dense_head``), and the output dict uses the JAX package's keys.

The input is a collated batch after ``data.host_precompute.HostPrecompute``
(sorted points, pillar tables, tap tables), as tensors on the model's device
(``batch_to_torch``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from torch.profiler import record_function

from ..caps import as_caps
from .backbone_as import PillarRes18BackBone8xAS
from .bev_backbone import BaseBEVBackboneV2
from .center_head import CenterHead, HeadSpec, decode_and_nms
from .distill import CMAHourglass
from .vfe import DynamicPillarVFESparse

RADAR_FEATURES = 6  # x, y, z, rcs, vx, vy
STAGES = ("radar_vfe", "radar_backbone_3d", "radar_cma", "radar_neck", "radar_dense_head",
          "decode_and_nms")


class PillarNet(nn.Module):
    """Radar-only detector. Build with ``models.build_network``."""

    def __init__(self, model_cfg, grid_size, voxel_size, point_cloud_range, class_names,
                 compute_dtype=torch.float32):
        super().__init__()
        cfg = model_cfg
        if "VFE" in cfg or "RADAR_VFE" not in cfg:
            raise NotImplementedError("the port serves the radar-only configuration")
        bk = cfg["RADAR_BACKBONE_3D"]
        if not bk.get("NAME", "").endswith("_AS"):
            raise NotImplementedError(f"radar backbone {bk.get('NAME')} is not ported")
        self.model_cfg = cfg
        self.grid_size = tuple(grid_size)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        nx, ny = self.grid_size
        caps = as_caps(bk, self.grid_size)
        vfe = cfg["RADAR_VFE"]
        self.radar_vfe = DynamicPillarVFESparse(
            num_filters=tuple(vfe["NUM_FILTERS"]), voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range, grid_size=self.grid_size,
            num_point_features=RADAR_FEATURES, capacity=caps[0],
            use_norm=vfe.get("USE_NORM", True), with_distance=vfe.get("WITH_DISTANCE", False),
            use_absolute_xyz=vfe.get("USE_ABSLOTE_XYZ", True),
            use_cluster_xyz=vfe.get("USE_CLUSTER_XYZ", True), dtype=compute_dtype)
        self.radar_backbone_3d = PillarRes18BackBone8xAS(
            (ny, nx), caps, int(bk.get("DENSE_FROM", 3)))
        self.radar_cma = CMAHourglass(256)
        neck = cfg["RADAR_BACKBONE_2D"]
        self.radar_neck = BaseBEVBackboneV2(
            (256, 256), tuple(neck["LAYER_NUMS"]), tuple(neck["NUM_FILTERS"]),
            tuple(neck["UPSAMPLE_STRIDES"]), tuple(neck["NUM_UPSAMPLE_FILTERS"]))
        head = cfg["RADAR_DENSE_HEAD"]
        self.head_spec = HeadSpec(head["CLASS_NAMES_EACH_HEAD"], class_names)
        self.radar_dense_head = CenterHead(
            self.head_spec, neck["NUM_FILTERS"][0], head["SHARED_CONV_CHANNEL"],
            head["NUM_HM_CONV"], head.get("USE_BIAS_BEFORE_NORM", False),
            with_iou="iou" in head["SEPARATE_HEAD_CFG"]["HEAD_DICT"])

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Each stage runs inside a ``torch.profiler`` span named after it
        (``STAGES``), so a profile attributes host and device time per stage."""
        out: Dict[str, Any] = {}
        # radar-only eval datasets carry the radar returns in `points`
        key = "radar_points" if "radar_points" in batch else "points"
        with record_function("radar_vfe"):
            rfeats, ruids, rcnt = self.radar_vfe(batch[key], batch[f"{key}_mask"],
                                                 batch["hp_radar"])
        with record_function("radar_backbone_3d"):
            rms = self.radar_backbone_3d(rfeats, ruids, batch.get("hp_as"))
        out["as_overflow"] = rms["as_overflow"] + torch.clamp(
            rcnt - self.radar_vfe.capacity, min=0).sum().to(torch.int32)
        out["radar_x_conv4"] = rms["x_conv4"]
        with record_function("radar_cma"):
            dense_8x_2, dense_8x_1 = self.radar_cma(rms["x_conv4"])
        out["radar_spatial_features_8x_2"] = dense_8x_2
        out["radar_spatial_features_8x_1"] = dense_8x_1
        with record_function("radar_neck"):
            rsp2d, rsp2d_8x = self.radar_neck(dense_8x_2, rms["x_conv5"])
        out["radar_spatial_features_2d"] = rsp2d
        out["radar_spatial_features_2d_8x"] = rsp2d_8x
        with record_function("radar_dense_head"):
            out["radar_preds"] = self.radar_dense_head(rsp2d)

        head_cfg = self.model_cfg["RADAR_DENSE_HEAD"]
        pp = head_cfg["POST_PROCESSING"]
        heads = head_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]
        with record_function("decode_and_nms"):
            out["final_box_dicts"] = decode_and_nms(
                out["radar_preds"], self.head_spec, (rsp2d.shape[1], rsp2d.shape[2]),
                head_cfg["TARGET_ASSIGNER_CONFIG"]["FEATURE_MAP_STRIDE"],
                self.voxel_size, self.point_cloud_range, pp["POST_CENTER_LIMIT_RANGE"],
                k_per_head=pp["MAX_OBJ_PER_SAMPLE"], score_thresh=pp["SCORE_THRESH"],
                rectifier=head_cfg.get("RECTIFIER", 0.0),
                nms_thresh=pp["NMS_CONFIG"]["NMS_THRESH"],
                nms_pre=pp["NMS_CONFIG"]["NMS_PRE_MAXSIZE"],
                nms_post=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"],
                with_iou="iou" in heads, with_vel="vel" in heads)
        return out


def batch_to_torch(batch: Dict[str, Any], device):
    """Collated + host-precomputed numpy batch -> tensors on ``device``
    (nested dicts and tuples kept, dtypes kept)."""
    if isinstance(batch, dict):
        return {k: batch_to_torch(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(batch_to_torch(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    return batch
