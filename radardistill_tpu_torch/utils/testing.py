"""The small-configuration factory of the tests and the accuracy gates.

The port's own copy of ``CLASS_NAMES``, ``head_cfg`` and ``make_model_cfg``
of ``radardistill_tpu/utils/testing.py``: a structurally faithful
RadarDistill model config (the keys of
``tools/cfgs/radar_distill/radar_distill_train.yaml``) at a configurable grid,
so that tests run on tiny grids and ``tools/torch_overfit_check.py`` /
``tools/torch_quality_gate.py`` on theirs.
``tests/test_torch_s2d_modules.py`` holds it equal to the original.
"""

from __future__ import annotations

from ..config import ConfigDict

CLASS_NAMES = [
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone",
]

HEADS_GROUPS = [
    ["car"],
    ["truck", "construction_vehicle"],
    ["bus", "trailer"],
    ["barrier"],
    ["motorcycle", "bicycle"],
    ["pedestrian", "traffic_cone"],
]


def head_cfg(distill_pred=True):
    return ConfigDict(
        NAME="Radar_CenterHead",
        DISTILL_PRED=distill_pred,
        CLASS_AGNOSTIC=False,
        IOU_REG="DIoU",
        CLASS_NAMES_EACH_HEAD=[list(g) for g in HEADS_GROUPS],
        SHARED_CONV_CHANNEL=64,
        USE_BIAS_BEFORE_NORM=True,
        NUM_HM_CONV=2,
        SEPARATE_HEAD_CFG=ConfigDict(
            HEAD_ORDER=["center", "center_z", "dim", "rot", "vel", "iou"],
            HEAD_DICT={
                "center": {"out_channels": 2, "num_conv": 2},
                "center_z": {"out_channels": 1, "num_conv": 2},
                "dim": {"out_channels": 3, "num_conv": 2},
                "rot": {"out_channels": 2, "num_conv": 2},
                "vel": {"out_channels": 2, "num_conv": 2},
                "iou": {"out_channels": 1, "num_conv": 2},
            },
        ),
        RECTIFIER=0.5,
        TARGET_ASSIGNER_CONFIG=ConfigDict(
            FEATURE_MAP_STRIDE=8, NUM_MAX_OBJS=500, GAUSSIAN_OVERLAP=0.1, MIN_RADIUS=2
        ),
        LOSS_CONFIG=ConfigDict(
            LOSS_WEIGHTS={
                "cls_weight": 1.0,
                "loc_weight": 0.25,
                "code_weights": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0],
            }
        ),
        POST_PROCESSING=ConfigDict(
            SCORE_THRESH=0.1,
            POST_CENTER_LIMIT_RANGE=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
            MAX_OBJ_PER_SAMPLE=500,
            NMS_CONFIG=ConfigDict(
                NMS_TYPE="nms_gpu", NMS_THRESH=0.2, NMS_PRE_MAXSIZE=1000, NMS_POST_MAXSIZE=83
            ),
        ),
    )


def make_model_cfg(
    grid: int = 160,
    teacher: bool = True,
    radar: bool = True,
    distill=True,
    num_max_objs: int = 500,
    k_per_head: int = 500,
    nms_post: int = 83,
):
    """grid must be divisible by 32 (stride 16 + CMA /4 at stride 8)."""
    assert grid % 32 == 0
    extent = grid * 0.075 / 2
    pc_range = [-extent, -extent, -5.0, extent, extent, 3.0]
    vfe = ConfigDict(
        NAME="DynamicPillarVFESimple2D",
        WITH_DISTANCE=False,
        USE_ABSLOTE_XYZ=True,
        USE_CLUSTER_XYZ=True,
        USE_NORM=True,
        NUM_FILTERS=[32],
    )
    neck = ConfigDict(
        NAME="BaseBEVBackboneV2",
        LAYER_NUMS=[5, 5],
        LAYER_STRIDES=[1, 2],
        NUM_FILTERS=[256, 256],
        UPSAMPLE_STRIDES=[1, 2],
        NUM_UPSAMPLE_FILTERS=[128, 128],
    )
    cfg = ConfigDict(NAME="PillarNet")
    if distill is not None:
        cfg.DISTILL = distill
    if teacher:
        cfg.FREEZE_PIPELINE = [
            "DynamicPillarVFESimple2D", "PillarRes18BackBone8x", "BaseBEVBackboneV2", "CenterHead",
        ]
        cfg.VFE = vfe
        cfg.BACKBONE_3D = ConfigDict(NAME="PillarRes18BackBone8x")
        cfg.BACKBONE_2D = neck
        h = head_cfg()
        h.NAME = "CenterHead"
        cfg.DENSE_HEAD = h
    if radar:
        rvfe = ConfigDict(vfe)
        rvfe.NAME = "Radar_DynamicPillarVFESimple2D"
        cfg.RADAR_VFE = rvfe
        cfg.RADAR_BACKBONE_3D = ConfigDict(NAME="Radar_PillarRes18BackBone8x")
        rneck = ConfigDict(neck)
        rneck.NAME = "Radar_Distill"
        rneck.VOXEL_SIZE = [0.075, 0.075, 8.0]
        rneck.POINT_CLOUD_RANGE = pc_range
        rneck.GRID_SIZE = [grid, grid, 1]
        cfg.RADAR_BACKBONE_2D = rneck
        cfg.RADAR_DENSE_HEAD = head_cfg()

    # shrink capacities for small-grid tests
    for key in ("DENSE_HEAD", "RADAR_DENSE_HEAD"):
        if key in cfg:
            cfg[key].TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = num_max_objs
            cfg[key].POST_PROCESSING.MAX_OBJ_PER_SAMPLE = k_per_head
            cfg[key].POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE = nms_post
            cfg[key].POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = min(
                1000, k_per_head * 2
            )

    dataset_info = {
        "grid_size": (grid, grid),
        "voxel_size": (0.075, 0.075, 8.0),
        "point_cloud_range": tuple(pc_range),
        "class_names": tuple(CLASS_NAMES),
    }
    return cfg, dataset_info
