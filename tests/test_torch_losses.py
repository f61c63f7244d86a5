"""The port's train-mode BatchNorms, target assignment, losses and optimizer
against the JAX package, float32, CPU. Inputs are made from a seed with numpy
and go through both.

Tolerances: BN outputs and running statistics 1e-6 (one reduction order
apart); integer targets exact, float targets 1e-6 (XLA's and PyTorch's ``exp``
/ ``log`` / ``cos`` differ in the last ulp); each loss rtol 1e-5; the
schedules and one AdamW update 1e-6.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from radardistill_tpu.models import center_head as jch
from radardistill_tpu.models import distill as jdistill
from radardistill_tpu.models import layers as jlayers
from radardistill_tpu.train import optim as joptim
from radardistill_tpu.utils.production import TRAIN_YAML as J_TRAIN_YAML
from radardistill_tpu.utils.production import production_cfg as j_production_cfg
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.data.synthetic import make_scene
from radardistill_tpu_torch.models import center_head as tch
from radardistill_tpu_torch.models import distill as tdistill
from radardistill_tpu_torch.models import layers as tlayers
from radardistill_tpu_torch.ops import geometry as tgeo
from radardistill_tpu_torch.train import optim as toptim
from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)

HEADS = [["car"], ["truck", "construction_vehicle"], ["bus", "trailer"], ["barrier"],
         ["motorcycle", "bicycle"], ["pedestrian", "traffic_cone"]]
CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
           "bicycle", "pedestrian", "traffic_cone"]
PC_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
VOXEL = (0.075, 0.075, 0.2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _seeded_bn_vars(rng, c, nested):
    p = {"scale": rng.uniform(0.75, 1.25, c), "bias": rng.uniform(-0.1, 0.1, c)}
    s = {"mean": rng.uniform(-0.1, 0.1, c), "var": rng.uniform(0.75, 1.25, c)}
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    p, s = f32(p), f32(s)
    return {"params": {"bn": p} if nested else p, "batch_stats": {"bn": s} if nested else s}


# ------------------------------------------------------- train-mode BatchNorms


def test_masked_batchnorm_train_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 50, 16).astype(np.float32) * 2 + 0.5
    mask = rng.rand(2, 50) < 0.6
    variables = _seeded_bn_vars(rng, 16, nested=False)
    jbn = jlayers.MaskedBatchNorm()
    want, mutated = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), True,
                              mutable=["batch_stats"])
    bn = tlayers.MaskedBatchNorm(16).train()
    bn.load_state_dict(state_dict_from_jax(bn, variables))
    got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    stats = _np(mutated["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-6, rtol=0)
    # the running variance takes the unbiased batch variance, momentum 0.01
    n = mask.sum()
    unbiased = x[mask].var(axis=0) * n / (n - 1)
    np.testing.assert_allclose(
        stats["var"], 0.99 * variables["batch_stats"]["var"] + 0.01 * unbiased, atol=1e-6)
    with pytest.raises(ValueError):
        bn(torch.from_numpy(x))  # train mode needs the mask
    assert bn.eval()(torch.from_numpy(x)).shape == x.shape


@pytest.mark.parametrize("eps,momentum", [(1e-5, 0.1), (1e-3, 0.01)], ids=["head", "backbone"])
def test_batchnorm_train_matches_jax(eps, momentum):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 8).astype(np.float32) * 1.5 - 0.3
    variables = _seeded_bn_vars(rng, 8, nested=True)
    want, mutated = jlayers.BatchNormTorch(eps=eps, momentum=momentum).apply(
        variables, jnp.asarray(x), True, mutable=["batch_stats"])
    bn = tlayers.BatchNormTorch(8, eps, momentum).train()
    bn.load_state_dict(state_dict_from_jax(bn, variables))
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    stats = _np(mutated["batch_stats"]["bn"])
    np.testing.assert_allclose(bn.bn.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.bn.running_var.numpy(), stats["var"], atol=1e-6, rtol=0)
    # flax updates with the biased variance
    biased = x.reshape(-1, 8).var(axis=0)
    np.testing.assert_allclose(stats["var"], (1 - momentum) * variables["batch_stats"]["bn"]["var"]
                               + momentum * biased, atol=1e-6)


@pytest.fixture(scope="module")
def head_case():
    """The merged-hidden CenterHead at 32 input channels on a 12 x 10 map."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 10, 32).astype(np.float32)
    jspec = jch.HeadSpec(HEADS, CLASSES)
    jhead = jch.CenterHead(spec=jspec, shared_channels=16, num_hm_conv=2,
                           use_bias_before_norm=True, with_iou=True)
    variables = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    flat = flax.traverse_util.flatten_dict(_np(dict(variables)))
    for k, v in flat.items():  # seeded statistics, scales and biases
        if k[-1] in ("mean", "bias"):
            flat[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif k[-1] in ("var", "scale"):
            flat[k] = rng.uniform(0.75, 1.25, v.shape).astype(np.float32)
    variables = flax.traverse_util.unflatten_dict(flat)
    want, mutated = jhead.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    spec = tch.HeadSpec(HEADS, CLASSES)
    head = load_jax_variables(tch.CenterHead(spec, 32, 16, 2, True, True), variables).train()
    got = head(torch.from_numpy(x))
    return _np(want), _np(mutated["batch_stats"]), head, got, variables


def test_merged_head_bn_train_output_matches_jax(head_case):
    want, _, _, got, _ = head_case
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, atol=2e-6, rtol=1e-5)


def test_merged_head_bn_train_statistics_match_jax(head_case):
    _, stats, head, _, variables = head_case
    after = state_dict_from_jax(head, {"batch_stats": stats})
    before = state_dict_from_jax(head, {"batch_stats": variables["batch_stats"]})
    assert len(after) == 2 * 8  # shared_bn and seven subheads
    for name, want in after.items():
        np.testing.assert_allclose(head.state_dict()[name].numpy(), want.numpy(), atol=1e-6, rtol=0)
        assert not np.allclose(want.numpy(), before[name].numpy(), atol=1e-4)


# --------------------------------------------------------------------- targets


@pytest.fixture(scope="module")
def target_case():
    """Two synthetic scenes' boxes in 40 slots on the 180 x 180 map of the
    shipped grid, plus a zero-size box, a box outside the range and one of a
    class no head lists."""
    boxes = np.zeros((2, 40, 10), np.float32)
    for i in range(2):
        boxes[i, :30] = make_scene(5 + i, num_lidar=10, num_radar=10, num_boxes=30)["gt_boxes"]
    boxes[0, 30] = [3.0, 4.0, 0.0, 0.0, 2.0, 1.5, 0.3, 0.1, 0.2, 1]      # dx == 0
    boxes[0, 31] = [70.0, -80.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.1, 0.2, 4]   # clipped to the edge
    boxes[1, 30] = [5.0, 5.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.1, 0.2, 11]     # no such class
    args = ((180, 180), 8, VOXEL, PC_RANGE)
    kwargs = dict(num_max_objs=500, gaussian_overlap=0.1, min_radius=2)
    want = _np(jch.assign_targets(jnp.asarray(boxes), jch.HeadSpec(HEADS, CLASSES), *args, **kwargs))
    got = tch.assign_targets(torch.from_numpy(boxes), tch.HeadSpec(HEADS, CLASSES), *args, **kwargs)
    return boxes, want, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("key", ["inds", "masks"])
def test_assign_targets_integers_match_jax(target_case, key):
    _, want, got = target_case
    assert got[key].shape == want[key].shape
    np.testing.assert_array_equal(got[key], want[key])
    assert want["masks"].sum() == 60 + 1  # every scene box and the clipped one, once each


def test_assign_targets_heatmaps_match_jax(target_case):
    """Same support (the Chebyshev square of each box), same peaks (exactly
    1), values within 1e-6: the two ``exp`` differ in the last ulp."""
    _, want, got = target_case
    np.testing.assert_array_equal(got["heatmaps"] > 0, want["heatmaps"] > 0)
    np.testing.assert_array_equal(got["heatmaps"] == 1.0, want["heatmaps"] == 1.0)
    np.testing.assert_allclose(got["heatmaps"], want["heatmaps"], atol=1e-6, rtol=0)
    assert (want["heatmaps"] == 1.0).sum() >= 50


@pytest.mark.parametrize("key", ["target_boxes", "gt_box7"])
def test_assign_targets_floats_match_jax(target_case, key):
    _, want, got = target_case
    np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0)


def test_gaussian_radius_matches_jax():
    from radardistill_tpu.ops import geometry as jgeo

    rng = np.random.RandomState(3)
    h, w = (rng.rand(2, 200).astype(np.float32) * 12 + 0.05)
    want = np.asarray(jgeo.gaussian_radius(jnp.asarray(h), jnp.asarray(w), 0.1))
    got = tgeo.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w), 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got.astype(np.int32), want.astype(np.int32))


# ---------------------------------------------------------------------- losses


def test_afd_low_loss_matches_jax():
    rng = np.random.RandomState(4)
    lidar = np.maximum(rng.randn(2, 20, 20, 16), 0).astype(np.float32)
    lidar *= (rng.rand(2, 20, 20, 1) < 0.5)
    radar = rng.randn(2, 20, 20, 16).astype(np.float32)
    want = jdistill.afd_low_loss(jnp.asarray(lidar), jnp.asarray(radar))
    rt = torch.from_numpy(radar).requires_grad_()
    got = tdistill.afd_low_loss(torch.from_numpy(lidar), rt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    grad_want = jax.grad(lambda r: sum(jdistill.afd_low_loss(jnp.asarray(lidar), r)))(
        jnp.asarray(radar))
    (grad,) = torch.autograd.grad(got[0] + got[1], rt)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_want), rtol=1e-4, atol=1e-9)


def test_pfd_high_loss_matches_jax():
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, 20, 20, 16).astype(np.float32) for _ in range(4)]
    # heatmap values away from the 0.1 thresholds, all four of tp / fn / fp / tn
    gt = rng.choice([0.0, 0.05, 0.5, 1.0], (2, 20, 20, 1)).astype(np.float32)
    radar = rng.choice([0.01, 0.05, 0.3, 0.9], (2, 20, 20, 1)).astype(np.float32)
    want = jdistill.pfd_high_loss(*map(jnp.asarray, feats), jnp.asarray(gt), jnp.asarray(radar))
    got = tdistill.pfd_high_loss(*map(torch.from_numpy, feats), torch.from_numpy(gt),
                                 torch.from_numpy(radar))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def loss_case(target_case):
    boxes, jtargets, _ = target_case
    rng = np.random.RandomState(6)
    preds = {k: (0.5 * rng.randn(2, 180, 180, 6, c)).astype(np.float32)
             for k, c in (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2), ("vel", 2),
                          ("iou", 1), ("hm", 2))}
    preds["hm"] -= 2.0
    # put the decoded boxes near their targets so that the IoU terms are not all 0
    tb, inds, masks = jtargets["target_boxes"], jtargets["inds"], jtargets["masks"]
    for b, h, m in zip(*np.nonzero(masks)):
        y, x = divmod(int(inds[b, h, m]), 180)
        preds["center"][b, y, x, h] = tb[b, h, m, 0:2] + 0.05
        preds["center_z"][b, y, x, h] = tb[b, h, m, 2:3] + 0.1
        preds["dim"][b, y, x, h] = tb[b, h, m, 3:6] + 0.1
        preds["rot"][b, y, x, h] = tb[b, h, m, 6:8] + 0.05  # not on the kink of the L1
    kwargs = dict(code_weights=[1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0], cls_weight=1.0,
                  loc_weight=0.25, hw=(180, 180), feature_map_stride=8, voxel_size=VOXEL,
                  point_cloud_range=PC_RANGE, with_iou=True, iou_reg=True)
    jspec, spec = jch.HeadSpec(HEADS, CLASSES), tch.HeadSpec(HEADS, CLASSES)
    jfn = lambda p: jch.centerhead_loss(p, jax.tree.map(jnp.asarray, jtargets), jspec, **kwargs)  # noqa: E731
    (want, want_tb), want_grad = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, preds))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    ttargets = tch.assign_targets(torch.from_numpy(boxes), spec, (180, 180), 8, VOXEL, PC_RANGE)
    got, got_tb = tch.centerhead_loss(tp, ttargets, spec, **kwargs)
    grads = dict(zip(tp, torch.autograd.grad(got, list(tp.values()))))
    return float(want), _np(want_tb), _np(want_grad), got.item(), got_tb, grads


def test_centerhead_loss_matches_jax(loss_case):
    want, want_tb, _, got, got_tb, _ = loss_case
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(got_tb) == set(want_tb) and len(want_tb) == 1 + 4 * 6
    for k, v in want_tb.items():
        np.testing.assert_allclose(got_tb[k].item(), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    assert sum(float(want_tb[f"iou_reg_loss_head_{h}"]) for h in range(6)) < 5.5  # boxes overlap


@pytest.mark.parametrize("key", ["center", "center_z", "dim", "rot", "vel", "iou", "hm"])
def test_centerhead_loss_gradients_match_jax(loss_case, key):
    _, _, want_grad, _, _, grads = loss_case
    got, want = grads[key].numpy(), want_grad[key]
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want) > 0


def test_distill_loss_matches_jax():
    rng = np.random.RandomState(7)
    f = lambda c=16: rng.randn(2, 20, 20, c).astype(np.float32)  # noqa: E731
    outputs = {k: f() for k in (
        "radar_spatial_features_8x_2", "radar_spatial_features_8x_1", "spatial_features_2d",
        "spatial_features_2d_8x", "radar_spatial_features_2d", "radar_spatial_features_2d_8x")}
    outputs["x_conv4"] = np.maximum(f(), 0) * (rng.rand(2, 20, 20, 1) < 0.5)
    outputs["heatmaps"] = rng.choice([0.0, 0.05, 0.5, 1.0], (2, 20, 20, 10)).astype(np.float32)
    outputs["radar_hm_preds"] = (2 * f(10) - 2).astype(np.float32)
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    want, want_tb = jdistill.distill_loss(jax.tree.map(jnp.asarray, outputs))
    got, got_tb = tdistill.distill_loss({k: torch.from_numpy(v) for k, v in outputs.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(got_tb) == set(want_tb)
    for k, v in want_tb.items():
        np.testing.assert_allclose(got_tb[k].item(), float(v), rtol=1e-5, err_msg=k)


# ------------------------------------------------------------------- optimizer


@pytest.mark.parametrize("step", [0, 399, 400, 999])
def test_one_cycle_schedules_match_jax(step):
    """Steps 0, a1 - 1, a1 and total - 1 of a 1000-step cycle, pct_start 0.4."""
    want_lr = float(joptim.one_cycle_lr(1000, 1e-3, 10, 0.4)(step))
    want_mom = float(joptim.one_cycle_mom(1000, [0.95, 0.85], 0.4)(step))
    np.testing.assert_allclose(toptim.one_cycle_lr(1000, 1e-3, 10, 0.4)(step), want_lr,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(toptim.one_cycle_mom(1000, [0.95, 0.85], 0.4)(step), want_mom,
                               rtol=1e-6)


class _Tree(nn.Module):
    """a/w, a/down_bias (never trained) and the frozen scope frozen/w."""

    def __init__(self, values):
        super().__init__()
        self.a, self.frozen = nn.Module(), nn.Module()
        self.a.w = nn.Parameter(torch.from_numpy(values["a"]["w"].copy()))
        self.a.down_bias = nn.Parameter(torch.from_numpy(values["a"]["down_bias"].copy()))
        self.frozen.w = nn.Parameter(torch.from_numpy(values["frozen"]["w"].copy()))


def test_adam_onecycle_updates_match_jax():
    """Two updates on a small tree: the first with a gradient norm above the
    clip of 10, the second below it; the frozen scope and ``down_bias`` keep
    their values (no decay either) although their gradients are not zero."""
    rng = np.random.RandomState(8)
    shapes = {"a": {"w": (7, 5), "down_bias": (5,)}, "frozen": {"w": (4, 3)}}
    draw = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (scale * rng.randn(*s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params, grads = draw(1.0), [draw(5.0), draw(0.1)]
    jcfg = j_production_cfg(J_TRAIN_YAML)[0].OPTIMIZATION
    tx, _ = joptim.build_optimizer(jcfg, params, 1000, ("frozen",))
    jparams, state = jax.tree.map(jnp.asarray, params), None
    state = tx.init(jparams)
    model = _Tree(params)
    opt, lr_sched = toptim.build_optimizer(production_cfg(TRAIN_YAML)[0].OPTIMIZATION, model, 1000,
                                           ("frozen",))
    assert [n for n, p in model.named_parameters() if p.requires_grad] == ["a.w"]
    np.testing.assert_allclose(lr_sched(0), 1e-4, rtol=1e-6)
    for g in grads:
        masked = {"a": {"w": g["a"]["w"], "down_bias": np.zeros(5, np.float32)},
                  "frozen": {"w": np.zeros((4, 3), np.float32)}}  # what stop_gradient leaves
        updates, state = tx.update(jax.tree.map(jnp.asarray, masked), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        model.a.w.grad = torch.from_numpy(g["a"]["w"].copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), np.linalg.norm(g["a"]["w"]), rtol=1e-6)
        np.testing.assert_allclose(model.a.w.detach().numpy(), np.asarray(jparams["a"]["w"]),
                                   atol=1e-6, rtol=0)
    assert opt.count == 2
    assert np.abs(model.a.w.detach().numpy() - params["a"]["w"]).max() > 1e-4
    for got, want, init in ((model.a.down_bias, jparams["a"]["down_bias"], params["a"]["down_bias"]),
                            (model.frozen.w, jparams["frozen"]["w"], params["frozen"]["w"])):
        np.testing.assert_array_equal(got.detach().numpy(), init)
        np.testing.assert_array_equal(np.asarray(want), init)


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_other_optimizers_raise_by_name(name):
    """``OPTIMIZER: adam`` (AdamW at a constant lr, optax's betas and eps,
    decoupled decay) and ``sgd`` (decay added to the gradient, heavy-ball
    momentum): three updates on a small tree against the JAX package's optax
    chain, the first above the clip of 10; the frozen scope and
    ``down_bias`` keep their values. Within 1e-6 per update."""
    rng = np.random.RandomState(9)
    shapes = {"a": {"w": (7, 5), "down_bias": (5,)}, "frozen": {"w": (4, 3)}}
    draw = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (scale * rng.randn(*s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params, grads = draw(1.0), [draw(5.0), draw(0.1), draw(0.3)]
    cfg = dict(production_cfg(TRAIN_YAML)[0].OPTIMIZATION, OPTIMIZER=name, LR=3e-3,
               MOMENTUM=0.9)
    tx, _ = joptim.build_optimizer(jlayers_cfg(cfg), params, 1000, ("frozen",))
    jparams = jax.tree.map(jnp.asarray, params)
    state = tx.init(jparams)
    model = _Tree(params)
    opt, lr_sched = toptim.build_optimizer(cfg, model, 1000, ("frozen",))
    assert [n for n, p in model.named_parameters() if p.requires_grad] == ["a.w"]
    assert lr_sched(0) == lr_sched(999) == 3e-3 and opt.kind == {"adam": "adamw",
                                                                   "sgd": "sgd"}[name]
    for g in grads:
        masked = {"a": {"w": g["a"]["w"], "down_bias": np.zeros(5, np.float32)},
                  "frozen": {"w": np.zeros((4, 3), np.float32)}}
        updates, state = tx.update(jax.tree.map(jnp.asarray, masked), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        model.a.w.grad = torch.from_numpy(g["a"]["w"].copy())
        opt.step()
        np.testing.assert_allclose(model.a.w.detach().numpy(), np.asarray(jparams["a"]["w"]),
                                   atol=1e-6, rtol=0)
    assert opt.count == 3 and np.abs(model.a.w.detach().numpy() - params["a"]["w"]).max() > 1e-4
    np.testing.assert_array_equal(model.a.down_bias.detach().numpy(), params["a"]["down_bias"])
    np.testing.assert_array_equal(model.frozen.w.detach().numpy(), params["frozen"]["w"])


def jlayers_cfg(cfg):
    """A dict as the JAX package's attribute-style config."""
    from radardistill_tpu.config import ConfigDict as JConfigDict

    return JConfigDict(cfg)