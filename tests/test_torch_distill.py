"""The port's LiDAR teacher and its whole distillation forward against the JAX
package, float32, CPU.

``radar_distill_train.yaml`` at grid 128, batch 2 (4000 lidar points and 300
radar returns per scene), run in eval mode on both sides, with ``INT8: false``
and with the shipped ``INT8: static``. The batch is collated once and goes
through each package's ``HostPrecompute``; the JAX variables come from
``model.init`` with every BN statistic and scale and every bias overwritten
by seeded numpy values, and are bridged into the port by ``convert.py``. The
JAX side reaches the Pallas int8 link in interpret mode on its own; the port
takes its plain versions on the CPU.

Tolerances. ``INT8: false``: rel-L2 <= 1e-4 on every feature and prediction
(float32 summation order over ~60 layers; this holds the packing algebra
free of quantization; measured ~1e-6). ``INT8: static``: rel-L2 <= 1e-3. The
int8 codes themselves are integers and agree exactly unless a float32
epilogue value lands within an ulp of a rounding boundary; one flipped code
moves a stage-1 activation by bound/254, which the later float stages carry
to about 1e-4 relative at worst. The share of differing stage-1 codes is
measured and held under 1e-3 (measured 3e-6 on the backbone alone). Detections are compared as
``tests/test_torch_slice.py`` compares them, over those with a score above 0.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.data.host_precompute import HostPrecompute as JaxHostPrecompute
from radardistill_tpu.models import build_network as jax_build_network
from radardistill_tpu.models.backbone_s2d import PillarRes18BackBone8xS2D as JaxS2D
from radardistill_tpu_torch.convert import load_jax_variables
from radardistill_tpu_torch.data import collate, synthetic
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.backbone_s2d import PillarRes18BackBone8xS2D
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg
from tests.test_torch_slice import _perturb, _rel_l2, assert_same_detections

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)

GRID = 128
TOL = {False: 1e-4, "static": 1e-3}
TEACHER_FEATURES = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x")
RADAR_FEATURES = ("radar_x_conv4", "radar_spatial_features_8x_2", "radar_spatial_features_2d")
PREDS = ("center", "center_z", "dim", "rot", "vel", "iou", "hm")


@pytest.fixture(scope="module")
def inputs():
    """cfg, info, the collated batch, and one set of JAX variables (the
    parameter tree does not depend on the INT8 mode)."""
    full, info = production_cfg(TRAIN_YAML, grid=GRID)
    cfg = full.MODEL
    scenes = [synthetic.make_scene(s, num_lidar=4000, num_radar=300, num_boxes=10,
                                   pc_range=info["point_cloud_range"]) for s in (0, 1)]
    batch = collate.collate_batch(scenes, {"MAX_LIDAR_POINTS": 4000, "MAX_RADAR_POINTS": 512,
                                           "NUM_MAX_OBJS": 50})
    batch.pop("_host", None)
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    jbatch = jax.tree.map(jnp.asarray, JaxHostPrecompute(cfg, *geo)(copy.deepcopy(batch)))
    tbatch = batch_to_torch(HostPrecompute(cfg, *geo)(copy.deepcopy(batch)), "cpu")
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    variables = jax.jit(lambda k, b: jmodel.init(k, b, False))(jax.random.PRNGKey(0), jbatch)
    variables = _perturb(jax.tree.map(np.asarray, {k: v for k, v in variables.items()
                                                   if k in ("params", "batch_stats")}))
    return cfg, info, jbatch, tbatch, variables


@pytest.fixture(scope="module", params=[False, "static"], ids=["int8-false", "int8-static"])
def run(request, inputs):
    cfg, info, jbatch, tbatch, variables = inputs
    cfg = copy.deepcopy(cfg)
    cfg.BACKBONE_3D.INT8 = request.param
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    jout = jax.tree.map(np.asarray, jax.jit(lambda v, b: jmodel.apply(v, b, False))(variables, jbatch))
    model = load_jax_variables(build_network(cfg, info, device="cpu"), variables)
    return request.param, model, jout, model(tbatch)


@pytest.mark.parametrize("key", TEACHER_FEATURES + RADAR_FEATURES)
def test_distill_features_match_jax(run, key):
    mode, _, jout, tout = run
    assert tuple(tout[key].shape) == jout[key].shape
    assert _rel_l2(tout[key].numpy(), jout[key]) <= TOL[mode]


@pytest.mark.parametrize("branch", ["lidar_preds", "radar_preds"])
@pytest.mark.parametrize("key", PREDS)
def test_distill_preds_match_jax(run, branch, key):
    mode, _, jout, tout = run
    got, want = tout[branch][key].numpy(), jout[branch][key]
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= TOL[mode]


def test_distill_overflow_and_boxes_match_jax(run):
    _, model, jout, tout = run
    assert int(tout["as_overflow"]) == int(jout["as_overflow"]) == 0
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = jout["final_box_dicts"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    # with these random weights many candidates score exactly 0 (the IoU
    # rectifier clamps at 0), and which of the tied ones top-k keeps is
    # arbitrary: compare the detections that scored
    scored = lambda d: dict(d, valid=d["valid"] & (d["scores"] > 1e-6))  # noqa: E731
    assert scored(want)["valid"].sum() > 20
    assert_same_detections(scored(got), scored(want), tol=1e-4)
    assert model.frozen == {"vfe", "backbone_3d", "backbone_2d", "dense_head"}


def test_bridge_maps_the_teacher_leaves(run):
    _, model, _, _ = run
    sd = model.state_dict()
    assert tuple(sd["backbone_3d.conv1_0.conv1.conv.kernel"].shape) == (3, 3, 32, 32)  # HWIO
    assert tuple(sd["backbone_3d.conv2_down.conv.conv.kernel"].shape) == (3, 3, 32, 64)
    assert tuple(sd["backbone_3d.conv1_0.bn1.running_var"].shape) == (32,)
    assert tuple(sd["backbone_3d.conv3_down.conv.conv.weight"].shape) == (128, 64, 3, 3)  # OIHW
    assert tuple(sd["vfe.pfn_0.linear.weight"].shape) == (32, 14)
    assert tuple(sd["dense_head.hm.conv_out.weight"].shape) == (12, 64, 3, 3)


# ------------------------------------------------ the teacher backbone alone


@pytest.fixture(scope="module", params=[False, True], ids=["int8-false", "int8-static"])
def backbone_run(request, inputs):
    """The S2D backbone on a seeded packed-order table (values unlike the
    VFE's, rows of absent sites zero), with the stage-1 output tapped."""
    _, _, jbatch, tbatch, variables = inputs
    static = request.param
    uids = np.array(jbatch["hp_lidar"]["uids"])
    rng = np.random.RandomState(11)
    table = (rng.rand(*uids.shape, 32) * 2.0).astype(np.float32)
    table *= (uids < GRID * GRID)[..., None]
    jm = JaxS2D(int8_static=static, table_input=True, hw=(GRID, GRID), packed_table=True)
    sub = {k: v["backbone_3d"] for k, v in variables.items()}
    jout = jax.tree.map(np.asarray, jax.jit(lambda v, t, u, m: jm.apply(v, t, u, False, m))(
        sub, jnp.asarray(table), jnp.asarray(uids), jbatch["hp_masks"]))
    tm = load_jax_variables(PillarRes18BackBone8xS2D((GRID, GRID), int8_static=static).eval(), sub)
    tapped = {}
    tm.conv1_1.register_forward_hook(lambda mod, args, out: tapped.update(x1p=out))
    with torch.no_grad():
        tout = tm(torch.from_numpy(table), torch.from_numpy(uids), tbatch["hp_masks"])
        # without host masks the backbone dilates them itself
        tout["no_host_masks"] = tm(torch.from_numpy(table), torch.from_numpy(uids), None)
    return static, jout, tout, tapped["x1p"]


@pytest.mark.parametrize("key", ["x_conv2", "x_conv3", "x_conv4", "x_conv5"])
def test_teacher_backbone_matches_jax(backbone_run, key):
    static, jout, tout, _ = backbone_run
    assert _rel_l2(tout[key].numpy(), jout[key]) <= (1e-3 if static else 1e-4)
    assert np.abs(jout[key]).max() > 0


def test_teacher_backbone_stage1_and_masks_match_jax(backbone_run):
    static, jout, tout, x1p = backbone_run
    for k in ("mask2", "mask3", "mask4"):
        np.testing.assert_array_equal(tout[k].numpy(), jout[k])
        np.testing.assert_array_equal(tout["no_host_masks"][k].numpy(), jout[k])
    assert torch.equal(tout["no_host_masks"]["x_conv5"], tout["x_conv5"])
    want = jout["x_conv1_packed"]
    if not static:
        assert _rel_l2(x1p.numpy(), want) <= 1e-4
        return
    q, bound, zero = x1p
    assert q.dtype == torch.int8 and zero == 127.0
    # the JAX side returns the carry dequantized: (q + 127) * bound / 254
    want_codes = np.round(want.astype(np.float64) * 254.0 / float(bound) - 127.0).astype(np.int32)
    diff = np.abs(q.numpy().astype(np.int32) - want_codes)
    share = float((diff != 0).mean())
    print(f"share of differing stage-1 codes: {share:.2e}")
    assert diff.max() <= 1 and share <= 1e-3
    assert (want_codes > -127).mean() > 0.01


# ------------------------------------------- the runtime around the forward


def test_prediction_dicts_and_recall_match_jax(run, inputs):
    """Both packages' final_box_dicts through their own
    ``generate_prediction_dicts`` and ``update_recall_record``: the same
    detections per sample (the near-tie rule above, over those that scored)
    and the same recall counts."""
    from radardistill_tpu.data.dataset import DatasetTemplate as JTemplate
    from radardistill_tpu.train.eval_utils import update_recall_record as j_recall
    from radardistill_tpu_torch.data.dataset import DatasetTemplate
    from radardistill_tpu_torch.train.eval_utils import update_recall_record

    _, model, jout, tout = run
    cfg, info, jbatch, _, _ = inputs
    host = {"frame_id": ["synthetic_0", "synthetic_1"]}
    names = list(info["class_names"])
    ds = type("DS", (), {"class_names": names,
                         "generate_prediction_dicts": DatasetTemplate.generate_prediction_dicts})
    jds = type("JDS", (), {"class_names": names,
                           "generate_prediction_dicts": JTemplate.generate_prediction_dicts})
    got = ds().generate_prediction_dicts(
        host, {k: v.numpy() for k, v in tout["final_box_dicts"].items()})
    want = jds().generate_prediction_dicts(host, jout["final_box_dicts"])
    gt = np.asarray(jbatch["gt_boxes"])
    thresh = tuple(cfg.POST_PROCESSING.RECALL_THRESH_LIST)
    rec, jrec = {}, {}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["frame_id"] == w["frame_id"] and len(g["pred_boxes"]) == len(w["pred_boxes"])
        for a in (g, w):
            np.testing.assert_array_equal(a["name"], [names[k - 1] for k in a["pred_labels"]])
        as_fixed = lambda a: {  # noqa: E731
            "boxes": a["pred_boxes"][None], "scores": a["pred_scores"][None],
            "labels": a["pred_labels"][None], "valid": a["pred_scores"][None] > 1e-6}
        assert_same_detections(as_fixed(g), as_fixed(w), tol=1e-4)
        gt_i = gt[i][gt[i][:, -1] > 0][:, :7]
        rec = update_recall_record(rec, g["pred_boxes"][:, :7], gt_i, thresh)
        jrec = j_recall(jrec, w["pred_boxes"][:, :7], gt_i, thresh)
    assert rec == jrec and jrec["gt"] == 20


def test_duplicate_teacher_to_radar_matches_jax(inputs):
    """The ``ckpt.py`` surgery on the bridged JAX variables equals the JAX
    surgery bridged, parameters and BN statistics alike."""
    from radardistill_tpu.train.checkpoint import duplicate_teacher_to_radar as j_duplicate
    from radardistill_tpu_torch.convert import state_dict_from_jax
    from radardistill_tpu_torch.train.checkpoint import duplicate_teacher_to_radar

    cfg, info, _, _, variables = inputs
    model = build_network(cfg, info, device="cpu")
    want = state_dict_from_jax(model, {k: j_duplicate(v) for k, v in variables.items()})
    raw = state_dict_from_jax(model, variables)
    got = duplicate_teacher_to_radar(raw)
    assert sorted(got) == sorted(want)
    copied = [k for k in want if not torch.equal(want[k], raw[k])]
    assert copied and all(torch.equal(got[k], want[k]) for k in want), copied[:5]
    assert torch.equal(got["radar_vfe.pfn_0.linear.weight"], raw["radar_vfe.pfn_0.linear.weight"])
