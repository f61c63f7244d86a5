"""The small-configuration factory of the tests and the accuracy gates.

The port's own copy of ``CLASS_NAMES``, ``head_cfg`` and ``make_model_cfg``
of ``radardistill_tpu/utils/testing.py``: a structurally faithful
RadarDistill model config (the keys of
``tools/cfgs/radar_distill/radar_distill_train.yaml``) at a configurable grid,
so that tests run on tiny grids and ``tools/torch_overfit_check.py`` /
``tools/torch_quality_gate.py`` on theirs.
``tests/test_torch_s2d_modules.py`` holds it equal to the original. And
``reference_state_dict``, the port's copy of the synthetic pcdet checkpoint of
``tests/test_convert.py``, for the reference-checkpoint import's tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

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


def reference_state_dict(rng, scale=None):
    """A synthetic reference pcdet ``model_state`` of the RadarDistill topology
    (teacher and radar branch, the full widths of ``make_model_cfg``: VFE
    inputs 14 / 15, 6 heads of ``[1, 2, 2, 1, 2, 2]`` classes), numpy arrays
    drawn from the ``numpy.random.RandomState`` ``rng``. The shipped yamls'
    models have the same widths.

    The port's copy of ``tests/test_convert.py::reference_state_dict``: with
    ``scale=None`` it draws the same values in the same order (standard
    normal weights, BN scales and running variances uniform on [0.5, 1.5)).
    ``scale="fan_in"`` keeps the keys and shapes and draws values that keep
    an eval forward finite through the deep stacks: weights N(0, 1/fan_in),
    biases, BN shifts and running means N(0, 0.1²), BN and LayerNorm scales
    and running variances uniform on [0.9, 1.1), GRN gamma / beta N(0, 0.1²).
    """
    if scale not in (None, "fan_in"):
        raise ValueError(f"scale: None or 'fan_in', not {scale!r}")
    fan = scale == "fan_in"
    sd = {}

    def weight(shape, fan_in):
        v = rng.randn(*shape).astype(np.float32)
        return v / np.float32(np.sqrt(fan_in)) if fan else v

    def shift(shape):  # a bias, BN shift or running mean, GRN gamma / beta
        v = rng.randn(*shape).astype(np.float32)
        return np.float32(0.1) * v if fan else v

    def positive(c):  # a BN scale or running variance
        v = rng.rand(c).astype(np.float32)
        return np.float32(0.2) * v + np.float32(0.9) if fan else v + 0.5

    def conv(key, o, i, k=3, bias=False):
        sd[f"{key}.weight"] = weight((o, i, k, k), i * k * k)
        if bias:
            sd[f"{key}.bias"] = shift((o,))

    def spconv_w(key, o, i, k=3, bias=False):
        sd[f"{key}.weight"] = weight((o, k, k, i), i * k * k)  # spconv2 layout
        if bias:
            sd[f"{key}.bias"] = shift((o,))

    def bn(key, c):
        sd[f"{key}.weight"] = positive(c)
        sd[f"{key}.bias"] = shift((c,))
        sd[f"{key}.running_mean"] = shift((c,))
        sd[f"{key}.running_var"] = positive(c)
        sd[f"{key}.num_batches_tracked"] = np.asarray(7)

    def linear(key, o, i, bias=True):
        sd[f"{key}.weight"] = weight((o, i), i)
        if bias:
            sd[f"{key}.bias"] = shift((o,))

    # VFE (lidar in=14, radar in=15)
    for scope, cin in (("vfe", 14), ("radar_vfe", 15)):
        linear(f"{scope}.pfn_layers.0.linear", 32, cin, bias=False)
        bn(f"{scope}.pfn_layers.0.norm", 32)

    # backbones
    for scope in ("backbone_3d", "radar_backbone_3d"):
        # conv1: 2 res blocks
        for b in (0, 1):
            for m in ("conv1", "conv2"):
                spconv_w(f"{scope}.conv1.{b}.{m}", 32, 32, bias=True)
                bn(f"{scope}.conv1.{b}.bn{m[-1]}", 32)
        for stage, (cin, cout) in (("conv2", (32, 64)), ("conv3", (64, 128)),
                                   ("conv4", (128, 256))):
            spconv_w(f"{scope}.{stage}.0.0", cout, cin)
            bn(f"{scope}.{stage}.0.1", cout)
            for b in (1, 2):
                for m in ("conv1", "conv2"):
                    spconv_w(f"{scope}.{stage}.{b}.{m}", cout, cout, bias=True)
                    bn(f"{scope}.{stage}.{b}.bn{m[-1]}", cout)
        # conv5 dense
        conv(f"{scope}.conv5.0.0", 256, 256)
        bn(f"{scope}.conv5.0.1", 256)
        for b in (1, 2):
            for m in ("conv1", "conv2"):
                conv(f"{scope}.conv5.{b}.{m}", 256, 256, bias=True)
                bn(f"{scope}.conv5.{b}.bn{m[-1]}", 256)

    # necks (teacher + the one inside Radar_Distill)
    for scope in ("backbone_2d", "radar_backbone_2d"):
        for blk, cin in (("0", 512), ("1", 256)):
            conv(f"{scope}.blocks.{blk}.1", 256, cin)
            bn(f"{scope}.blocks.{blk}.2", 256)
            for k in range(5):
                conv(f"{scope}.blocks.{blk}.{4 + 3 * k}", 256, 256)
                bn(f"{scope}.blocks.{blk}.{5 + 3 * k}", 256)
        sd[f"{scope}.deblocks.0.0.weight"] = weight((256, 256, 2, 2), 256)
        bn(f"{scope}.deblocks.0.1", 256)

    # CMA (inside radar_backbone_2d)
    for e in (1, 2, 3):
        for b, down in ((0, True), (1, False)):
            base = f"radar_backbone_2d.encoder_{e}.{b}"
            sd[f"{base}.dwconv.weight"] = weight((256, 1, 7, 7), 49)
            sd[f"{base}.dwconv.bias"] = shift((256,))
            sd[f"{base}.norm.weight"] = (positive(256) if fan else
                                         rng.randn(256).astype(np.float32))
            sd[f"{base}.norm.bias"] = shift((256,))
            linear(f"{base}.pwconv1", 1024, 256)
            linear(f"{base}.pwconv2", 256, 1024)
            sd[f"{base}.grn.gamma"] = shift((1, 1, 1, 1024))
            sd[f"{base}.grn.beta"] = shift((1, 1, 1, 1024))
            if down:
                conv(f"{base}.conv_offset_mask1", 27, 256, bias=True)
                sd[f"{base}.down_layer.weight"] = weight((256, 256, 3, 3), 256 * 9)
                # frozen-at-init DCN bias (exists despite bias=False)
                sd[f"{base}.down_layer.bias"] = shift((256,))
        sd[f"radar_backbone_2d.decoder_{e}.0.weight"] = weight((256, 256, 4, 4), 256)
        sd[f"radar_backbone_2d.decoder_{e}.0.bias"] = shift((256,))
        bn(f"radar_backbone_2d.decoder_{e}.1", 256)
        conv(f"radar_backbone_2d.agg_{e}.0", 256, 512, k=1, bias=True)
        bn(f"radar_backbone_2d.agg_{e}.1", 256)

    # heads
    head_classes = [len(g) for g in HEADS_GROUPS]
    subheads = {"center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2, "iou": 1}
    for scope in ("dense_head", "radar_dense_head"):
        conv(f"{scope}.shared_conv.0", 64, 256, bias=True)
        bn(f"{scope}.shared_conv.1", 64)
        for h, ncls in enumerate(head_classes):
            for sub, oc in list(subheads.items()) + [("hm", ncls)]:
                conv(f"{scope}.heads_list.{h}.{sub}.0.0", 64, 64, bias=True)
                bn(f"{scope}.heads_list.{h}.{sub}.0.1", 64)
                conv(f"{scope}.heads_list.{h}.{sub}.1", oc, 64, bias=True)
    return sd


# The JAX checkpoint fixture (tests/fixtures/jax_run/, tools/make_jax_ckpt_fixture.py)
JAX_CKPT_PERIOD = 61  # a prime: no channel count is a multiple of it
JAX_CKPT_LEVELS = 16
JAX_CKPT_STEPS_PER_EPOCH = 52
JAX_CKPT_RANDOM = ("radar_vfe", "radar_neck.deblock1_bn.bn")  # drawn, not periodic
_JAX_CKPT_STATES = ("params", "batch_stats", "mu", "nu", "trace")


def jax_ckpt_count(epoch: int) -> int:
    """The update count of the fixture's checkpoint of ``epoch``."""
    return JAX_CKPT_STEPS_PER_EPOCH * epoch


def jax_ckpt_leaf(path, shape, dtype, epoch: int) -> np.ndarray:
    """The value of the leaf at the key path ``path`` (a tuple of strings, as
    the JAX checkpoint's ``_METADATA`` names it) in the fixture's checkpoint of
    ``epoch``, from numpy alone.

    Integer leaves: ``epoch`` for ``epoch``, else the update count (``step``,
    ``it`` and optax's counts). Float leaves of a parameter tree (``params``,
    ``batch_stats``, Adam's ``mu`` / ``nu``, SGD's ``trace``) repeat a table
    of ``JAX_CKPT_PERIOD`` values drawn from ``JAX_CKPT_LEVELS`` levels evenly
    spread over (-1, 1), from a seed of their path and epoch, so that zstd
    stores any of them in a few hundred bytes; under the
    scopes of ``JAX_CKPT_RANDOM`` they are standard normal draws of that seed
    instead, which do not compress. Either draw ``u`` is scaled by the leaf's
    kind: kernels ``u · sqrt(3 / fan in)`` (normal draws ``u / sqrt(fan
    in)``), BatchNorm and LayerNorm scales ``1 + 0.1 u`` and running
    variances ``1 + 0.5 u`` (normal draws: ``1 + 0.1 u``), both clipped to
    [0.5, 1.5], ``mu`` ``1e-4 u``, ``nu`` ``1e-8 (1 + 0.5 u)`` clipped to
    [0.5e-8, 1.5e-8], ``trace`` ``1e-3 u``, every other leaf ``0.1 u``."""
    import zlib

    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    name = ".".join(path)
    if dtype.kind in "iu":
        value = epoch if path[-1] == "epoch" else jax_ckpt_count(epoch)
        return np.full(shape, value, dtype)
    rng = np.random.RandomState(zlib.crc32(f"{name}:{epoch}".encode()))
    state = next((k for k in _JAX_CKPT_STATES if k in path), None)
    scope = ".".join(path[path.index(state) + 1:]) if state else ""
    n = int(np.prod(shape))
    drawn = any(scope.startswith(r + ".") for r in JAX_CKPT_RANDOM)
    if drawn:
        u = rng.standard_normal(n)
    else:
        half = JAX_CKPT_LEVELS / 2
        table = (rng.randint(0, JAX_CKPT_LEVELS, JAX_CKPT_PERIOD) - (half - 0.5)) / half
        u = np.resize(table, n)
    leaf = path[-1]
    if state == "mu":
        v = 1e-4 * u
    elif state == "nu":
        v = np.clip(1e-8 * (1 + 0.5 * u), 0.5e-8, 1.5e-8)
    elif state == "trace":
        v = 1e-3 * u
    elif leaf in ("kernel", "down_weight") and len(shape) > 1:
        fan_in = int(np.prod(shape[:-1]))
        v = u / np.sqrt(fan_in) if drawn else u * np.sqrt(3.0 / fan_in)
    elif leaf in ("scale", "var"):
        v = np.clip(1 + (0.5 if leaf == "var" and not drawn else 0.1) * u, 0.5, 1.5)
    else:
        v = 0.1 * u
    return v.astype(dtype).reshape(shape)
