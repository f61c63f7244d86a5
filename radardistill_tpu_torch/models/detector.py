"""PillarNet, the dual-branch teacher/student detector.

Counterpart of ``radardistill_tpu/models/detector.py::PillarNet``: the
topology slots of the JAX ``setup``, built by name from the same registries
(``VFE_REGISTRY``, ``BACKBONE3D_REGISTRY``, ``NECK_REGISTRY``; a ``Radar_``
twin is the same class in its own scope). Each branch's VFE and 3D backbone
come in three kinds:

- dense input: a dense VFE (``DynamicPillarVFESimple2D``, ``DynamicPillarVFE``
  or ``MeanVFE``) -> ``PillarRes18BackBone8x`` or ``PillarBackBone8x``: the
  LiDAR teacher of ``pillarnet.yaml``, the radar baseline of
  ``pillarnet_radar.yaml`` and both branches of ``synthetic/smoke.yaml``;
- active-site: a pillar-table VFE -> ``PillarRes18BackBone8x_AS`` (``DENSE_FROM``
  2..5): the radar student of ``radar_distill_*.yaml``, or a LiDAR teacher;
- space-to-depth (teacher only): ``PillarRes18BackBone8x_S2D`` or ``_S2D2``
  (``INT8`` false, true or ``static``, ``INT8_STAGES``, ``FP_STAGES``) fed by
  a pillar table (``TABLE_INPUT``, packed or linear order: the frozen teacher
  of ``radar_distill_train.yaml``) or by a dense VFE's grid.

Then the neck (``BaseBEVBackboneV2`` or ``V1``; the radar branch runs the CMA
hourglass before it) and a ``CenterHead``. The widths flax infers are computed
here: the first PFN linear's input (``vfe.vfe_input_dim``), the backbone's
input (the VFE's output: 32, or 5 / 6 raw features after ``MeanVFE``) and the
head's (the neck's output). The teacher's ``x_conv4``, ``x_conv5``,
``spatial_features_2d``, ``spatial_features_2d_8x`` and ``lidar_preds`` are
what the distillation losses and the teacher's eval consume.

Submodule names are the flax scope names (``vfe``, ``backbone_3d``,
``backbone_2d``, ``dense_head`` and their ``radar_`` twins, ``radar_cma``,
``radar_neck``), and the output dict uses the JAX package's keys.

The reference's ``train`` flag is ``nn.Module.training``. ``model.eval()``:
the whole forward runs without gradients and ends in decode + NMS.
``model.train()``: the scopes of ``FREEZE_PIPELINE`` (kept as ``frozen``) stay
in eval mode (running BN statistics); a frozen *teacher* scope also runs
without gradients, which is the reference's ``stop_gradient`` on its outputs,
and a teacher outside ``FREEZE_PIPELINE`` trains (``pillarnet.yaml``, or the
S2D teacher of the accuracy gates, ``FREEZE_PIPELINE: []``); the teacher's
head is skipped when a radar branch exists; ``assign_targets``
puts ``target_dicts`` into the output when the batch has ``gt_boxes``; nothing
is decoded. One quirk of the reference is kept: the CMA and the radar neck ask
for the scope ``radar_backbone_2d``, which ``FREEZE_NAME_TO_SCOPE`` never
yields, so they are in BN train mode whenever the model trains, also under
``FREEZE_PIPELINE: [Radar_Distill]`` (which still keeps them out of the
optimizer).

The input is a collated batch as tensors on the model's device
(``batch_to_torch``), with or without the keys that
``data.host_precompute.HostPrecompute`` adds (``hp_radar``, ``hp_as``,
``hp_lidar``, ``hp_masks``, ``hp_as_lidar``: sorted points, pillar tables,
tap tables, occupancy masks). Whatever is absent is built on the device: the
VFEs sort the points and compact the pillar ids, the active-site backbones
build their tap tables, the teacher dilates its masks. A dense VFE always
sorts on the device.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..caps import as_caps, is_as, is_table_s2d
from .backbone_as import PillarRes18BackBone8xAS
from .backbone_s2d import PillarRes18BackBone8xS2D
from .backbone_sparse2d import PillarBackBone8x, PillarRes18BackBone8x
from .backbone_tile_sparse import PillarRes18BackBone8xTileSparse
from .bev_backbone import BaseBEVBackboneV1, BaseBEVBackboneV2
from .center_head import CenterHead, HeadSpec, assign_targets, decode_and_nms
from ..utils.profiler import mark_backward, span
from ..utils.remat import remat_call
from .distill import CMAHourglass
from .vfe import DynamicPillarVFE, DynamicPillarVFESimple2D, DynamicPillarVFESparse, MeanVFE

LIDAR_FEATURES = 5  # x, y, z, intensity, time
RADAR_FEATURES = 6  # x, y, z, rcs, vx, vy
TEACHER_STAGES = ("vfe", "backbone_3d", "backbone_2d", "dense_head")
RADAR_STAGES = ("radar_vfe", "radar_backbone_3d", "radar_cma", "radar_neck", "radar_dense_head")
STAGES = TEACHER_STAGES + RADAR_STAGES + ("assign_targets", "decode_and_nms")

# the reference's per-stage registries; a Radar_ twin is the same class in
# another scope
VFE_REGISTRY = {
    "DynamicPillarVFESimple2D": DynamicPillarVFESimple2D,
    "Radar_DynamicPillarVFESimple2D": DynamicPillarVFESimple2D,
    "Radar_DynamicPillarVFESimple2D_Test": DynamicPillarVFESimple2D,
    "DynamicPillarVFE": DynamicPillarVFE,
    "MeanVFE": MeanVFE,
    "RADAR_MeanVFE": MeanVFE,
    "DynamicMeanVFE": MeanVFE,
}
BACKBONE3D_REGISTRY = {
    "PillarRes18BackBone8x": PillarRes18BackBone8x,
    "Radar_PillarRes18BackBone8x": PillarRes18BackBone8x,
    "PillarBackBone8x": PillarBackBone8x,
    "PillarRes18BackBone8x_S2D": PillarRes18BackBone8xS2D,
    "Radar_PillarRes18BackBone8x_S2D": PillarRes18BackBone8xS2D,
    "PillarRes18BackBone8x_S2D2": PillarRes18BackBone8xS2D,
    "Radar_PillarRes18BackBone8x_S2D2": PillarRes18BackBone8xS2D,
    "PillarRes18BackBone8x_AS": PillarRes18BackBone8xAS,
    "Radar_PillarRes18BackBone8x_AS": PillarRes18BackBone8xAS,
    "PillarRes18BackBone8x_TileSparse": PillarRes18BackBone8xTileSparse,
    "Radar_PillarRes18BackBone8x_TileSparse": PillarRes18BackBone8xTileSparse,
}
NECK_REGISTRY = {
    "BaseBEVBackboneV2": BaseBEVBackboneV2,
    "BaseBEVBackboneV1": BaseBEVBackboneV1,
    "Radar_Distill": BaseBEVBackboneV2,  # Radar_Distill = CMA + the inherited V2 neck
}

# FREEZE_PIPELINE class names of the reference -> the scopes they freeze
FREEZE_NAME_TO_SCOPE = {
    "DynamicPillarVFESimple2D": ("vfe",),
    "PillarRes18BackBone8x": ("backbone_3d",),
    "BaseBEVBackboneV2": ("backbone_2d",),
    "CenterHead": ("dense_head",),
    "Radar_DynamicPillarVFESimple2D": ("radar_vfe",),
    "Radar_PillarRes18BackBone8x": ("radar_backbone_3d",),
    # Radar_Distill = CMA hourglass + inherited neck -> two scopes
    "Radar_Distill": ("radar_cma", "radar_neck"),
    "Radar_CenterHead": ("radar_dense_head",),
}


def _registered(registry, kind, name):
    if name not in registry:
        raise ValueError(f"unknown {kind} {name!r}: the registry has {sorted(registry)}")
    return registry[name]



class PillarNet(nn.Module):
    """Build with ``models.build_network``."""

    def __init__(self, model_cfg, grid_size, voxel_size, point_cloud_range, class_names,
                 compute_dtype=torch.float32, remat=False):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.remat = remat
        self.grid_size = tuple(grid_size)
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.has_teacher = "VFE" in cfg
        self.has_radar = "RADAR_VFE" in cfg
        self.frozen = {scope for n in cfg.get("FREEZE_PIPELINE", [])
                       for scope in FREEZE_NAME_TO_SCOPE.get(n, ())}
        nx, ny = self.grid_size
        dt = compute_dtype

        def make_vfe(sub, bk, num_point_features):
            """The VFE of a branch; an active-site or table-input S2D backbone
            takes the pillar table (``DynamicPillarVFESparse``) instead of the
            grid."""
            cls = _registered(VFE_REGISTRY, "VFE", sub.get("NAME", "DynamicPillarVFESimple2D"))
            if cls is MeanVFE:
                return MeanVFE(self.voxel_size, self.point_cloud_range, self.grid_size,
                               num_point_features)
            kwargs = dict(
                num_filters=tuple(sub["NUM_FILTERS"]), voxel_size=self.voxel_size,
                point_cloud_range=self.point_cloud_range, grid_size=self.grid_size,
                num_point_features=num_point_features, use_norm=sub.get("USE_NORM", True),
                with_distance=sub.get("WITH_DISTANCE", False),
                use_absolute_xyz=sub.get("USE_ABSLOTE_XYZ", True),
                use_cluster_xyz=sub.get("USE_CLUSTER_XYZ", True), dtype=dt)
            if cls is DynamicPillarVFESimple2D and is_as(bk):
                return DynamicPillarVFESparse(capacity=as_caps(bk, self.grid_size)[0], **kwargs)
            if cls is DynamicPillarVFESimple2D and is_table_s2d(bk):
                return DynamicPillarVFESparse(capacity=int(bk.get("TABLE_CAPACITY", 163840)),
                                              packed_order=bool(bk.get("PACKED_TABLE", True)),
                                              **kwargs)
            return cls(**kwargs)

        def make_backbone(bk, in_ch):
            name = bk.get("NAME", "PillarRes18BackBone8x")
            cls = _registered(BACKBONE3D_REGISTRY, "3D backbone", name)
            int8_mode = bk.get("INT8", False)
            if int8_mode and cls not in (PillarRes18BackBone8x, PillarRes18BackBone8xS2D):
                raise ValueError(f"INT8: {int8_mode} takes a PillarRes18 teacher, not {name}")
            if int8_mode == "static" and cls is not PillarRes18BackBone8xS2D:
                raise ValueError("INT8: static takes the space-to-depth teacher")
            if cls is PillarRes18BackBone8xAS:
                return PillarRes18BackBone8xAS((ny, nx), as_caps(bk, self.grid_size),
                                               int(bk.get("DENSE_FROM", 3)))
            if cls is PillarRes18BackBone8xS2D:
                if in_ch != 32:
                    raise ValueError(f"{name}: its first residual block takes 32 channels, "
                                     f"not {in_ch}")
                # pack_stage2 beside the INT8 switches: the JAX detector sets
                # kwargs = dict(pack_stage2=True) for _S2D2, which drops them
                # and silently runs a float teacher (a fault kept there)
                return PillarRes18BackBone8xS2D(
                    (ny, nx), dtype=dt, int8=bool(int8_mode) and int8_mode != "static",
                    int8_static=int8_mode == "static", int8_stages=int(bk.get("INT8_STAGES", 1)),
                    fp_stages=int(bk.get("FP_STAGES", 0)), table_input=is_table_s2d(bk),
                    packed_table=bool(bk.get("PACKED_TABLE", True)),
                    pack_stage2=name.endswith("_S2D2"))
            if cls is PillarRes18BackBone8x:
                return PillarRes18BackBone8x(in_ch, dt, int8=bool(int8_mode))
            if cls is PillarRes18BackBone8xTileSparse:
                return cls(in_ch, dt, tile=int(bk.get("TILE", 32)),
                           max_tiles=int(bk.get("MAX_TILES", 512)))
            return cls(in_ch, dt)

        def make_neck(sub):
            cls = _registered(NECK_REGISTRY, "neck", sub.get("NAME", "BaseBEVBackboneV2"))
            neck = cls((256, 256), tuple(sub["LAYER_NUMS"]), tuple(sub["NUM_FILTERS"]),
                       tuple(sub["UPSAMPLE_STRIDES"]), tuple(sub["NUM_UPSAMPLE_FILTERS"]))
            out_ch = (sum(sub["NUM_UPSAMPLE_FILTERS"]) if cls is BaseBEVBackboneV1
                      else sub["NUM_FILTERS"][0])
            return neck, out_ch

        def make_head(sub, in_ch):
            spec = HeadSpec(sub["CLASS_NAMES_EACH_HEAD"], class_names)
            return spec, CenterHead(
                spec, in_ch, sub["SHARED_CONV_CHANNEL"], sub["NUM_HM_CONV"],
                sub.get("USE_BIAS_BEFORE_NORM", False),
                with_iou="iou" in sub["SEPARATE_HEAD_CFG"]["HEAD_DICT"])

        if self.has_teacher:
            bk = cfg.get("BACKBONE_3D", {})
            self.as_teacher, self.s2dt_teacher = is_as(bk), is_table_s2d(bk)
            self.vfe = make_vfe(cfg["VFE"], bk, LIDAR_FEATURES)
            self.backbone_3d = make_backbone(bk, self.vfe.output_dim)
            self.backbone_2d, neck_ch = make_neck(cfg["BACKBONE_2D"])
            self.head_spec, self.dense_head = make_head(cfg["DENSE_HEAD"], neck_ch)
        if self.has_radar:
            bk = cfg.get("RADAR_BACKBONE_3D", {})
            self.as_radar = is_as(bk)
            self.radar_vfe = make_vfe(cfg["RADAR_VFE"], bk, RADAR_FEATURES)
            self.radar_backbone_3d = make_backbone(bk, self.radar_vfe.output_dim)
            self.radar_cma = CMAHourglass(256)
            self.radar_neck, neck_ch = make_neck(cfg["RADAR_BACKBONE_2D"])
            self.radar_head_spec, self.radar_dense_head = make_head(
                cfg["RADAR_DENSE_HEAD"], neck_ch)
            if not self.has_teacher:
                self.head_spec = self.radar_head_spec
            # the classes serve both branches: their child spans take the
            # branch's stage name
            self.radar_vfe.stage, self.radar_backbone_3d.stage = "radar_vfe", "radar_backbone_3d"

    def train(self, mode: bool = True):
        """Frozen scopes stay in eval mode; the CMA and the radar neck follow
        ``mode`` whatever ``FREEZE_PIPELINE`` says (see the module docstring)."""
        super().train(mode)
        for scope in self.frozen - {"radar_cma", "radar_neck"}:
            if hasattr(self, scope):
                getattr(self, scope).train(False)
        return self

    def _remat(self, module, *args):
        """``module(*args)``; with ``remat``, in a train forward that takes
        gradients, under ``torch.utils.checkpoint`` (``utils.remat``), as the
        reference's ``nn.remat`` of the 3D backbones and the CMA."""
        return remat_call(self.remat and self.training, module, *args)

    @contextlib.contextmanager
    def _scope(self, scope: str):
        """Profiler span of a teacher scope; without gradients when frozen
        (the reference stops the gradient of a frozen teacher scope's outputs,
        which cuts everything upstream of them as well)."""
        grad = torch.is_grad_enabled() and scope not in self.frozen
        with span(scope), torch.set_grad_enabled(grad):
            yield

    def _teacher(self, batch, out):
        # a trained teacher's stages hook their outputs for the backward's
        # spans (``utils.profiler.mark_backward``); a frozen one takes no
        # gradient and hooks nothing
        with self._scope("vfe"):
            if self.as_teacher or self.s2dt_teacher:
                tfeats, tuids, tcnt = self.vfe(batch["points"], batch["points_mask"],
                                               batch.get("hp_lidar"))
                _overflow(out, torch.clamp(tcnt - self.vfe.capacity, min=0).sum())
                mark_backward("vfe.backward", tfeats)
            else:
                bev, mask = self.vfe(batch["points"], batch["points_mask"])
                mark_backward("vfe.backward", bev)
        with self._scope("backbone_3d"):
            if self.as_teacher:
                ms = self._remat(self.backbone_3d, tfeats, tuids, batch.get("hp_as_lidar"))
                _overflow(out, ms["as_overflow"])
            elif self.s2dt_teacher:
                ms = self._remat(self.backbone_3d, tfeats, tuids, batch.get("hp_masks"))
            else:
                ms = self._remat(self.backbone_3d, bev, mask)
            mark_backward("backbone_3d.backward", ms)
        out["x_conv4"], out["x_conv5"] = ms["x_conv4"], ms["x_conv5"]
        with self._scope("backbone_2d"):
            sp2d, sp2d_8x = self.backbone_2d(ms["x_conv4"], ms["x_conv5"])
            mark_backward("backbone_2d.backward", (sp2d, sp2d_8x))
        out["spatial_features_2d"], out["spatial_features_2d_8x"] = sp2d, sp2d_8x
        # the teacher's head is dead compute while a student trains
        if not (self.has_radar and self.training):
            with self._scope("dense_head"):
                out["lidar_preds"] = self.dense_head(sp2d)
                mark_backward("dense_head.backward", out["lidar_preds"])

    def _radar(self, batch, out):
        # radar-only eval datasets carry the radar returns in `points`
        key = "radar_points" if "radar_points" in batch else "points"
        # each stage hooks its outputs for the backward's spans
        # (``utils.profiler.mark_backward``)
        with span("radar_vfe"):
            if self.as_radar:
                rfeats, ruids, rcnt = self.radar_vfe(batch[key], batch[f"{key}_mask"],
                                                     batch.get("hp_radar"))
                _overflow(out, torch.clamp(rcnt - self.radar_vfe.capacity, min=0).sum())
                mark_backward("radar_vfe.backward", rfeats)
            else:
                rbev, rmask = self.radar_vfe(batch[key], batch[f"{key}_mask"])
                mark_backward("radar_vfe.backward", rbev)
        with span("radar_backbone_3d"):
            if self.as_radar:
                rms = self._remat(self.radar_backbone_3d, rfeats, ruids, batch.get("hp_as"))
                _overflow(out, rms["as_overflow"])
            else:
                rms = self._remat(self.radar_backbone_3d, rbev, rmask)
            mark_backward("radar_backbone_3d.backward", rms)
        out["radar_x_conv4"] = rms["x_conv4"]
        with span("radar_cma"):
            dense_8x_2, dense_8x_1 = self._remat(self.radar_cma, rms["x_conv4"])
            mark_backward("radar_cma.backward", (dense_8x_2, dense_8x_1))
        out["radar_spatial_features_8x_2"] = dense_8x_2
        out["radar_spatial_features_8x_1"] = dense_8x_1
        with span("radar_neck"):
            rsp2d, rsp2d_8x = self.radar_neck(dense_8x_2, rms["x_conv5"])
            mark_backward("radar_neck.backward", (rsp2d, rsp2d_8x))
        out["radar_spatial_features_2d"] = rsp2d
        out["radar_spatial_features_2d_8x"] = rsp2d_8x
        with span("radar_dense_head"):
            out["radar_preds"] = self.radar_dense_head(rsp2d)
            mark_backward("radar_dense_head.backward", out["radar_preds"])

    def forward(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Each stage runs inside a ``torch.profiler`` span named after it
        (``STAGES``, ``utils.profiler.span``), so a profile attributes host
        and device time per stage; steps inside a stage have child spans
        ``<stage>.<step>``, and each trained stage's backward a span
        ``<stage>.backward``."""
        with torch.set_grad_enabled(self.training and torch.is_grad_enabled()):
            return self._forward(batch)

    def _forward(self, batch):
        out: Dict[str, Any] = {}
        if self.has_teacher:
            self._teacher(batch, out)
        if self.has_radar:
            self._radar(batch, out)

        # the radar head wins when present, as in the reference
        side = "RADAR_" if self.has_radar else ""
        head_cfg = self.model_cfg[f"{side}DENSE_HEAD"]
        spec = self.radar_head_spec if self.has_radar else self.head_spec
        fmap = out["radar_spatial_features_2d" if self.has_radar else "spatial_features_2d"]
        ta = head_cfg["TARGET_ASSIGNER_CONFIG"]
        if self.training:
            # one assignment shared by the head loss and the PFD loss
            if "gt_boxes" in batch:
                with span("assign_targets"):
                    out["target_dicts"] = assign_targets(
                        batch["gt_boxes"], spec, (fmap.shape[1], fmap.shape[2]),
                        ta["FEATURE_MAP_STRIDE"], self.voxel_size, self.point_cloud_range,
                        num_max_objs=ta["NUM_MAX_OBJS"], gaussian_overlap=ta["GAUSSIAN_OVERLAP"],
                        min_radius=ta["MIN_RADIUS"])
            return out

        preds = out["radar_preds" if self.has_radar else "lidar_preds"]
        pp = head_cfg["POST_PROCESSING"]
        heads = head_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"]
        with span("decode_and_nms"):
            out["final_box_dicts"] = decode_and_nms(
                preds, spec, (fmap.shape[1], fmap.shape[2]), ta["FEATURE_MAP_STRIDE"],
                self.voxel_size, self.point_cloud_range, pp["POST_CENTER_LIMIT_RANGE"],
                k_per_head=pp["MAX_OBJ_PER_SAMPLE"], score_thresh=pp["SCORE_THRESH"],
                rectifier=head_cfg.get("RECTIFIER", 0.0),
                nms_thresh=pp["NMS_CONFIG"]["NMS_THRESH"],
                nms_pre=pp["NMS_CONFIG"]["NMS_PRE_MAXSIZE"],
                nms_post=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"],
                with_iou="iou" in heads, with_vel="vel" in heads)
        return out


def _overflow(out, n):
    """Add ``n`` sites dropped by a capacity to ``out["as_overflow"]``, which
    exists, as in the reference, only where a branch takes pillar tables."""
    n = n.to(torch.int32)
    out["as_overflow"] = out["as_overflow"] + n if "as_overflow" in out else n


def batch_to_torch(batch: Dict[str, Any], device="cuda"):
    """Collated numpy batch, host-precomputed or not -> tensors on ``device`` (the
    card unless the caller asks for the CPU; nested dicts and tuples kept,
    dtypes kept), in the span ``h2d``."""
    with span("h2d"):
        return _to_torch(batch, device)


def _to_torch(batch, device):
    if isinstance(batch, dict):
        return {k: _to_torch(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_torch(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    return batch
