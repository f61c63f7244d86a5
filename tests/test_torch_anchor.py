"""The anchor family of the port against the JAX package, float32, CPU:
``ResidualCoder``, ``generate_anchors``, ``nearest_bev_iou`` and the
assignment, the losses and the decode (``models/anchor_head.py``), the head
module and its initializer laws, ``BaseBEVBackbone`` (the multi-level FPN
with a strided-conv deblock and ``deblock_final``), the map-to-BEV layers,
``PillarVFE``, and the whole ``AnchorDetector`` as ``PointPillar`` (the
dense VFE) and as ``SECONDNet`` (``PillarVFE`` on fixed voxels): train loss,
gradients and running statistics, and eval detections, from weights carried
across by ``convert.py``. The cases are those the JAX package's own tests
name (``tests/test_anchor_head.py``, ``test_anchor_detector.py``,
``test_pillar_vfe_fixed.py``, ``test_necks_and_misc.py``).

The two detectors run in JAX under one ``jit`` (train forward, loss and
gradient, and the eval forward, of both); every other JAX function runs op by
op.

Tolerances: features and predictions rel-L2 <= 1e-5 (float32 summation
order), losses rtol 1e-5, running statistics atol 1e-5, the detectors'
gradients rel-L2 <= 1e-4 (measured ~1e-6). Assignment is decided by exact
float comparisons (the forced match ``iou == best IoU of its GT`` and the
first ``argmax`` over GTs). The boxes sit on the anchor grid, so the IoUs tie
exactly between anchors and between GTs; the port computes the IoU in the
JAX order of operations: the IoUs, every label and every regression target
agree exactly against the assignment jitted alone. Inside the whole
detector's ``jit`` XLA fuses the encoding into its neighbours, and 13 of
14 336 targets move by one ulp (6e-8): the labels stay equal, the targets
are held to 1e-6.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.config import ConfigDict as JConfigDict
from radardistill_tpu.models import anchor_head as jah
from radardistill_tpu.models import bev_backbone as jbev
from radardistill_tpu.models import build_network as jbuild
from radardistill_tpu.models import compute_training_loss as jloss
from radardistill_tpu.models import map_to_bev as jm2b
from radardistill_tpu.models import vfe as jvfe
from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.models import anchor_head as ah
from radardistill_tpu_torch.models import bev_backbone as bev
from radardistill_tpu_torch.models import build_network, compute_training_loss
from radardistill_tpu_torch.models import map_to_bev as m2b
from radardistill_tpu_torch.models import vfe
from radardistill_tpu_torch.models.layers import init_reference_
from tests.test_geometry import random_boxes
from tests.test_torch_slice import _perturb, _rel_l2, assert_same_detections

torch.set_num_threads(1)

PCR = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
INFO = {"grid_size": (32, 32), "voxel_size": (0.5, 0.5, 8.0), "point_cloud_range": PCR,
        "class_names": ("car", "pedestrian")}
ANCHOR_CFGS = [
    {"class_name": "car", "anchor_sizes": [[4.6, 1.9, 1.7]], "anchor_rotations": [0, 1.57],
     "anchor_bottom_heights": [-1.8], "align_center": True, "matched_threshold": 0.55,
     "unmatched_threshold": 0.4},
    {"class_name": "pedestrian", "anchor_sizes": [[0.8, 0.6, 1.7]],
     "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [-1.8], "align_center": True,
     "matched_threshold": 0.4, "unmatched_threshold": 0.25},
]
T = torch.from_numpy


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy_variables(shapes, seed=0):
    """A variable tree of the shapes ``jax.eval_shape`` gave: kernels uniform
    on +-1 / sqrt(fan in), every BN statistic and scale and every bias from
    ``_perturb``."""
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict({k: dict(v) for k, v in shapes.items()})
    for k, v in flat.items():
        bound = 1.0 / np.sqrt(np.prod(v.shape[:-1])) if k[-1].endswith("kernel") else 0.0
        flat[k] = (rng.uniform(-bound, bound, v.shape) if bound else np.ones(v.shape)).astype(
            np.float32)
    return _perturb(flax.traverse_util.unflatten_dict(flat), seed=seed + 1)


def _grid_boxes():
    """GT boxes with the anchors' own sizes centred on anchor centres, or
    halfway between two, so that IoUs tie exactly; sample 1 has none."""
    gt = np.zeros((2, 5, 8), np.float32)
    gt[0, 0] = [0.5, 0.5, -0.95, 4.6, 1.9, 1.7, 0.0, 1]
    gt[0, 1] = [2.5, 3.5, -0.95, 0.8, 0.6, 1.7, 1.57, 2]
    gt[0, 2] = [-3.5, 1.5, -0.95, 4.6, 1.9, 1.7, 1.57, 1]
    gt[0, 3] = [-3.5, 2.5, -0.95, 4.6, 1.9, 1.7, 0.0, 1]  # overlaps box 2: GT ties
    gt[0, 4] = [1.0, -4.5, -0.95, 4.6, 1.9, 1.7, 0.0, 1]  # between anchors: ties, ignore band
    return gt


# ------------------------------------------------------------- head pieces


def test_residual_coder_matches_jax():
    boxes, anchors = random_boxes(20, seed=1), random_boxes(20, seed=2)
    coders = [jah.ResidualCoder(encode_angle_by_sincos=sincos) for sincos in (False, True)]
    runs = _np(jax.jit(lambda b, a: [(c.encode(b, a), c.decode(c.encode(b, a), a))
                                     for c in coders])(boxes, anchors))
    for sincos, jc, (jenc, jdec) in zip((False, True), coders, runs):
        tc = ah.ResidualCoder(encode_angle_by_sincos=sincos)
        tenc = tc.encode(T(boxes), T(anchors)).numpy()
        np.testing.assert_allclose(tenc, jenc, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tc.decode(T(tenc), T(anchors)).numpy(), jdec, rtol=1e-5,
                                   atol=1e-5)
        assert tc.code_size == jc.code_size == 7 + sincos


def test_anchors_iou_and_assignment_match_jax_exactly():
    """``generate_anchors`` (both centre rules), ``nearest_bev_iou`` and the
    batched assignment on boxes placed on the anchor grid: IoUs bit-equal,
    every label and regression target equal, ties included."""
    pcr, grid = [-8, -8, -5, 8, 8, 3], (32, 32)
    for align in (True, False):
        cfgs = [dict(c, align_center=align) for c in ANCHOR_CFGS]
        for j, t in zip(jah.generate_anchors(cfgs, grid, pcr, 2),
                        ah.generate_anchors(cfgs, grid, pcr, 2)):
            np.testing.assert_array_equal(t, np.asarray(j))
    anchors = ah.generate_anchors(ANCHOR_CFGS, grid, pcr, 2)
    gt = _grid_boxes()
    flat = anchors[0].reshape(-1, 7)
    coder = jah.ResidualCoder()
    kw = dict(class_ids=[1, 2], matched_thr=[0.55, 0.4], unmatched_thr=[0.4, 0.25])
    # the single-class form: a perfect match, background, the ignore band
    a3 = np.array([[0, 0, 0, 4, 2, 1.5, 0], [10, 10, 0, 4, 2, 1.5, 0],
                   [0.5, 0, 0, 4, 2, 1.5, 0]], np.float32)
    g1 = a3[:1]
    jiou, want, singles = _np(jax.jit(lambda a, g: (
        jah.nearest_bev_iou(a[0].reshape(-1, 7), g[0, :, :7]),
        jah.assign_anchor_targets(a, g, coder=coder, **kw),
        [jah.assign_targets_single(jnp.asarray(a3), jnp.asarray(g1), jnp.asarray([2]), jnp.asarray([valid]), coder, 0.9,
                                   0.5) for valid in (True, False)]))(anchors, gt))
    tiou = ah.nearest_bev_iou(T(flat), T(gt[0, :, :7])).numpy()
    np.testing.assert_array_equal(tiou, jiou)
    assert (jiou == 1.0).sum() >= 2 and np.isin(jiou[:, 2], jiou[:, 3]).any()
    got = ah.assign_anchor_targets([T(a) for a in anchors], T(gt), coder=ah.ResidualCoder(), **kw)
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), want["box_cls_labels"])
    np.testing.assert_array_equal(got["box_reg_targets"].numpy(), want["box_reg_targets"])
    labels = want["box_cls_labels"]
    assert (labels[0] == 1).sum() >= 2 and (labels[0] == 2).sum() >= 1
    assert (labels[0] == -1).any() and (labels[1] == 0).all()
    for valid, (jl, jr) in zip((True, False), singles):
        tl, tr = ah.assign_targets_single(T(a3), T(g1), torch.tensor([2]), torch.tensor([valid]),
                                          ah.ResidualCoder(), 0.9, 0.5)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tl.tolist() == [0, 0, 0]


def test_losses_and_decode_match_jax():
    rng = np.random.RandomState(0)
    a = 8 * 8 * 4
    preds = {"cls_preds": rng.randn(2, a, 2).astype(np.float32),
             "box_preds": (rng.randn(2, a, 7) * 0.3).astype(np.float32),
             "dir_cls_preds": rng.randn(2, a, 2).astype(np.float32)}
    labels = rng.randint(-1, 3, (2, a)).astype(np.int32)
    labels[1] = np.where(labels[1] > 0, 0, labels[1])  # a sample without positives
    targets = {"box_cls_labels": labels,
               "box_reg_targets": (rng.randn(2, a, 7) * 0.1).astype(np.float32)}
    anchors = random_boxes(a, seed=5)
    kw = dict(num_class=2, code_weights=[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5])
    jl, jtb, jdir, (js, jb) = jax.jit(lambda p, t, a: (
        *jah.anchor_head_loss(p, t, a, coder=jah.ResidualCoder(), **kw),
        jah.get_direction_target(a, t["box_reg_targets"]),
        jah.decode_anchor_predictions(p, a, jah.ResidualCoder())))(preds, targets, anchors)
    tl, ttb = ah.anchor_head_loss({k: T(v) for k, v in preds.items()},
                                  {k: T(v) for k, v in targets.items()}, T(anchors),
                                  coder=ah.ResidualCoder(), **kw)
    assert sorted(ttb) == sorted(jtb) == ["rpn_loss", "rpn_loss_cls", "rpn_loss_dir",
                                          "rpn_loss_loc"]
    for k in jtb:
        np.testing.assert_allclose(float(ttb[k]), float(jtb[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(
        ah.get_direction_target(T(anchors), T(targets["box_reg_targets"])).numpy(),
        np.asarray(jdir))
    ts, tb = ah.decode_anchor_predictions({k: T(v) for k, v in preds.items()}, T(anchors),
                                          ah.ResidualCoder())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)


def test_head_module_and_its_initializer():
    """``AnchorHeadSingle`` on flax ``nn.Conv`` weights carried across, and
    the reference's laws: ``conv_cls`` bias at the focal prior -log(99),
    ``conv_box`` kernel normal with std 1e-3, the other kernels lecun normal,
    biases 0."""
    x = np.random.RandomState(0).randn(2, 8, 8, 64).astype(np.float32)
    jh = jah.AnchorHeadSingle(num_class=2, num_anchors_per_location=4, code_size=7)
    variables = _numpy_variables(jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), x, True)))
    want = jh.apply(variables, x, True)
    th = load_jax_variables(ah.AnchorHeadSingle(64, 2, 4, 7), variables)
    got = th(T(x))
    for k in want:
        assert got[k].shape == want[k].shape
        assert _rel_l2(got[k].detach().numpy(), np.asarray(want[k])) <= 1e-6, k
    init_reference_(th, torch.Generator().manual_seed(0))
    assert torch.allclose(th.conv_cls.bias, torch.full((8,), -np.log(99.0)))
    assert 0.8e-3 < th.conv_box.weight.std().item() < 1.2e-3
    # lecun: std 1 / sqrt(64) after a truncation at 2 std of the untruncated law
    assert th.conv_dir_cls.weight.abs().max() <= 2 / 8.0 / 0.87962566 + 1e-6
    assert not th.conv_box.bias.any() and not th.conv_dir_cls.bias.any()


# ------------------------------------------------- backbone, map to BEV, VFE


@pytest.mark.parametrize("case", ["multilevel", "strided_deblock"])
def test_bev_backbone_matches_jax(case):
    """``BaseBEVBackbone`` in eval and train mode (outputs, the per-stride
    intermediates, the running statistics it leaves): three levels with a
    final deconv (``test_bev_backbone_v0_multilevel``), and two levels with a
    0.5 upsample stride (a strided conv deblock) and no upsample on the
    last."""
    kw = {"multilevel": dict(layer_nums=(1, 1, 1), layer_strides=(1, 2, 2),
                             num_filters=(16, 32, 64), upsample_strides=(1, 2, 4, 2),
                             num_upsample_filters=(32, 32, 32)),
          "strided_deblock": dict(layer_nums=(1, 2), layer_strides=(1, 2), num_filters=(16, 32),
                                  upsample_strides=(0.5,), num_upsample_filters=(24,))}[case]
    x = np.random.RandomState(1).randn(2, 16, 16, 8).astype(np.float32)
    jm = jbev.BaseBEVBackbone(**kw)
    variables = _numpy_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, False)))
    tm = load_jax_variables(bev.BaseBEVBackbone(8, **kw), variables)
    runs = _np(jax.jit(lambda v: [jm.apply(v, x, train, mutable=["batch_stats"])
                                  for train in (False, True)])(variables))
    for train, ((jy, jret), upd) in zip((False, True), runs):
        ty, tret = tm.train(train)(T(x))
        assert ty.shape == jy.shape and sorted(tret) == sorted(jret)
        assert _rel_l2(ty.detach().numpy(), np.asarray(jy)) <= 1e-5
        for k in jret:
            assert _rel_l2(tret[k].detach().numpy(), np.asarray(jret[k])) <= 1e-5, k
    assert tm.out_channels == jy.shape[-1]
    for k, v in state_dict_from_jax(tm, _np(dict(upd))).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def test_map_to_bev_matches_jax():
    rng = np.random.RandomState(0)
    v = rng.randn(2, 4, 5, 3, 6).astype(np.float32)
    got = m2b.HeightCompression(18)(T(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm2b.HeightCompression().apply({}, v)))
    assert got.shape == (2, 4, 5, 18)
    bev_x, mask = rng.randn(2, 4, 5, 7).astype(np.float32), rng.rand(2, 4, 5) > 0.5
    np.testing.assert_array_equal(
        m2b.PointPillarScatter()(T(bev_x), T(mask)).numpy(),
        np.asarray(jm2b.PointPillarScatter().apply({}, bev_x, mask)))


def _voxels(pts, mask, max_pts=8):
    """A seeded batch of fixed voxels from points: (B, V, P, F), the point
    counts and (z, y, x) coords, -1 rows padding (the data processor's
    ``transform_points_to_voxels`` layout, padded per sample)."""
    b, _, f = pts.shape
    per = []
    for i in range(b):
        p = pts[i][mask[i]]
        c = np.floor((p[:, :2] - np.float32(PCR[0])) / np.float32(0.5)).astype(np.int32)
        ok = ((c >= 0) & (c < 32)).all(1)
        p, c = p[ok], c[ok]
        key = c[:, 1] * 32 + c[:, 0]
        uniq, inv = np.unique(key, return_inverse=True)
        per.append((p, c, uniq, inv))
    v = max(len(u) for _, _, u, _ in per) + 3
    voxels = np.zeros((b, v, max_pts, f), np.float32)
    nums = np.zeros((b, v), np.int32)
    coords = np.full((b, v, 3), -1, np.int32)
    for i, (p, c, uniq, inv) in enumerate(per):
        for j in range(len(uniq)):
            rows = p[inv == j][:max_pts]
            voxels[i, j, :len(rows)] = rows
            nums[i, j] = len(rows)
            coords[i, j] = (0, uniq[j] // 32, uniq[j] % 32)
    voxels[:, -2:] = 7.0  # garbage in padding rows
    return voxels, nums, coords


def _points(b=2, n=400, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-7.5, 7.5, (b, n, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 0, (b, n))
    pts[:, ::50, :2] = pts[:, 1::50, :2]  # a few tied pillars
    mask = np.ones((b, n), bool)
    mask[:, -20:] = False
    return pts, mask


@pytest.mark.parametrize("filters", [(16,), (8, 16)])
def test_pillar_vfe_matches_jax(filters):
    """``PillarVFE`` in eval and train mode (the grid, its occupancy, the
    running statistics), and the gradient of the train forward, against the
    JAX module; padding rows with garbage change nothing."""
    voxels, nums, coords = _voxels(*_points())
    geo = dict(voxel_size=(0.5, 0.5, 8.0), point_cloud_range=PCR, grid_size=(32, 32))
    jm = jvfe.PillarVFE(num_filters=filters, **geo)
    args = (voxels, nums, coords)
    variables = _numpy_variables(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args,
                                                                False)))
    tm = load_jax_variables(vfe.PillarVFE(filters, num_point_features=5, **geo), variables)
    w = np.random.RandomState(3).randn(2, 32, 32, filters[-1]).astype(np.float32)

    def run(v):
        outs = [jm.apply(v, *args, train, mutable=["batch_stats"]) for train in (False, True)]
        grad = jax.grad(lambda p: jnp.sum(jm.apply({**v, "params": p}, *args, True,
                                                   mutable=["batch_stats"])[0][0] * w))
        return outs, grad(v["params"])

    outs, jg = _np(jax.jit(run)(variables))
    for train, ((jbev_x, jmask), upd) in zip((False, True), outs):
        tbev, tmask = tm.train(train)(*map(T, args))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert _rel_l2(tbev.detach().numpy(), np.asarray(jbev_x)) <= 1e-5
        assert tmask.sum() > 200 and (tbev.detach().numpy()[~tmask.numpy()] == 0).all()
    for k, v in state_dict_from_jax(tm, dict(upd)).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    tm = load_jax_variables(vfe.PillarVFE(filters, num_point_features=5, **geo), variables).train()
    (tm(*map(T, args))[0] * T(w)).sum().backward()
    want = state_dict_from_jax(tm, {"params": jg})
    got = dict(tm.named_parameters())
    for k, v in want.items():
        assert _rel_l2(got[k].grad.numpy(), v.numpy()) <= 1e-5, k


# ------------------------------------------------------------ the detector


def _model_cfg(name, vfe_name):
    d = dict(
        NAME=name, VFE=dict(NAME=vfe_name, NUM_FILTERS=[32]),
        BACKBONE_2D=dict(LAYER_NUMS=[1, 1], LAYER_STRIDES=[2, 2], NUM_FILTERS=[32, 64],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[32, 32]),
        DENSE_HEAD=dict(
            NAME="AnchorHeadSingle", USE_DIRECTION_CLASSIFIER=True, DIR_OFFSET=0.78539,
            NUM_DIR_BINS=2, ANCHOR_GENERATOR_CONFIG=ANCHOR_CFGS,
            TARGET_ASSIGNER_CONFIG=dict(FEATURE_MAP_STRIDE=2),
            LOSS_CONFIG=dict(LOSS_WEIGHTS={"cls_weight": 1.0, "loc_weight": 2.0,
                                           "dir_weight": 0.2, "code_weights": [1.0] * 7})),
        POST_PROCESSING=dict(SCORE_THRESH=0.1, NMS_CONFIG=dict(
            NMS_THRESH=0.2, NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=50)))
    return JConfigDict(d), ConfigDict(d)


DETECTORS = {"PointPillar": "DynamicPillarVFESimple2D", "SECONDNet": "PillarVFE"}


def _batch(vfe_name):
    pts, mask = _points(seed=4)
    gt = _grid_boxes()
    if vfe_name == "PillarVFE":
        v, n, c = _voxels(pts, mask)
        return {"voxels": v, "voxel_num_points": n, "voxel_coords": c, "gt_boxes": gt}
    return {"points": pts, "points_mask": mask, "gt_boxes": gt}


@pytest.fixture(scope="module")
def detector_runs():
    """Both JAX detectors under one ``jit``: the train forward's loss terms,
    targets, updated statistics and gradient, and the eval forward."""
    cases = {}
    for name, vfe_name in DETECTORS.items():
        jcfg, _ = _model_cfg(name, vfe_name)
        model, batch = jbuild(jcfg, INFO), _batch(vfe_name)
        shapes = jax.eval_shape(lambda m=model, b=batch: m.init(jax.random.PRNGKey(0), b, True))
        cases[name] = (jcfg, model, batch, _numpy_variables(shapes, seed=7))

    @jax.jit
    def run(variables):
        res = {}
        for name, (jcfg, model, batch, _) in cases.items():
            v = variables[name]

            def loss_fn(p, model=model, batch=batch, jcfg=jcfg, v=v):
                out, upd = model.apply({**v, "params": p}, batch, True, mutable=["batch_stats"])
                loss, tb = jloss(jcfg, out, INFO["class_names"], INFO["voxel_size"], PCR)
                return loss, (tb, out["target_dicts"], upd)

            (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
            res[name] = (loss, aux, g, model.apply(v, batch, False)["final_box_dicts"])
        return res

    variables = {name: c[3] for name, c in cases.items()}
    return cases, _np(run(variables))


@pytest.mark.parametrize("name", list(DETECTORS))
def test_anchor_detector_matches_jax(detector_runs, name):
    """``build_network`` builds the model from the config; on the JAX
    weights its train loss terms, targets, gradients and running statistics
    and its eval detections equal the JAX ``AnchorDetector``'s."""
    cases, runs = detector_runs
    _, _, batch, variables = cases[name]
    loss, (tb, targets, upd), grads, dets = runs[name]
    _, cfg = _model_cfg(name, DETECTORS[name])
    model = load_jax_variables(build_network(cfg, INFO, device="cpu"), variables)
    assert model.frozen == set()
    tbatch = {k: T(v) for k, v in batch.items()}
    out = model.train()(tbatch)
    tloss, ttb = compute_training_loss(cfg, out, INFO["class_names"], INFO["voxel_size"], PCR)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    for k in tb:
        np.testing.assert_allclose(ttb[k].item(), float(tb[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out["target_dicts"]["box_cls_labels"].numpy(),
                                  targets["box_cls_labels"])
    np.testing.assert_allclose(out["target_dicts"]["box_reg_targets"].numpy(),
                               targets["box_reg_targets"], rtol=1e-6, atol=1e-6)
    assert (targets["box_cls_labels"] > 0).sum() >= 3
    params = dict(model.named_parameters())
    want = state_dict_from_jax(model, {"params": grads})
    got = np.concatenate([params[k].grad.numpy().ravel() for k in want])
    assert _rel_l2(got, np.concatenate([v.numpy().ravel() for v in want.values()])) <= 1e-4
    for k, v in state_dict_from_jax(model, dict(upd)).items():
        if "running" in k:
            np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), atol=1e-5,
                                       err_msg=k)
    model = load_jax_variables(build_network(cfg, INFO, device="cpu"), variables)
    tdets = {k: v.numpy() for k, v in model(tbatch)["final_box_dicts"].items()}
    assert tdets["boxes"].shape == (2, 50, 7) and tdets["valid"].dtype == bool
    assert tdets["valid"].sum() >= 5
    assert_same_detections(tdets, dets, 1e-4)
