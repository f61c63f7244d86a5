"""The dense-input route of the port against the JAX package, float32, CPU:
the configurations, batch and weights that ``tests/test_torch_dense_*.py``
share, and the train-step case that ``tests/test_torch_dense_teacher.py``
(``pillarnet.yaml``'s topology: the dense LiDAR teacher alone, ``DISTILL``
absent, trained), ``tests/test_torch_dense_radar.py``
(``pillarnet_radar.yaml``'s: the dense radar branch alone, ``DISTILL:
False``) and ``tests/test_torch_s2d_teacher.py`` (``pillarnet.yaml``'s
topology with the space-to-depth teacher ``PillarRes18BackBone8x_S2D`` on
the dense VFE's grid) run, one configuration a file so that the JAX compiles
land on separate workers. Importing the tests below into a test module collects them
there; this module holds no tests of its own.

The configurations come from ``radardistill_tpu.utils.testing.make_model_cfg``
at grid 96 (the shipped heads and necks, 16 box slots, 32 candidates a head),
as ``tests/test_teacher_only.py`` builds them. The batch: two seeded
``make_scene`` scenes of 1500 lidar points and 150 radar returns, 5 boxes,
collated once and passed through each package's ``HostPrecompute``. The JAX
variables are not drawn by ``model.init`` (its compile costs more than the
tests): their shapes come from ``jax.eval_shape`` of it, the kernels from a
numpy seed at the scale of torch's conv default (uniform, +-1 / sqrt(fan in)),
and every BN statistic and scale and every bias from ``_perturb``.

The train case: both packages take two steps from the same weights. The JAX
package runs its own ``make_train_step``, jitted once together with the eval
forward at the initial weights; its optimizer is ``build_optimizer``'s chain
behind a transformation that passes the gradients through and keeps them in
its state, which is how the gradients at init leave the step. Tolerances, as
``tests/torch_train_case.py`` states them: loss and each term at init rtol
1e-4 (the IoU terms 1e-3), gradients rel-L2 <= 2e-2 per leaf and their global
norm rtol 1e-3, BN statistics after the first step within 1e-4 (and 1e-5
relative: the radar branch's CMA variances reach thousands), every
parameter within ``2.1 * sum(lr)`` of the JAX package's after each step, and
every trainable parameter moved. The leaves whose true gradient is zero (conv
biases that feed a train-mode BatchNorm, and in the radar branch the CMA's of
``tests/torch_train_case.py``) are held to ``1e-5`` of the global norm.
"""

import copy
import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.flatten_util import ravel_pytree

from radardistill_tpu.config import ConfigDict as JConfigDict
from radardistill_tpu.data.host_precompute import HostPrecompute as JaxHostPrecompute
from radardistill_tpu.models import build_network as jax_build_network
from radardistill_tpu.train import optim as joptim
from radardistill_tpu.train import train_step as jstep
from radardistill_tpu.utils.testing import make_model_cfg
from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.data import collate, synthetic
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import make_train_step
from tests.test_torch_slice import _perturb, _rel_l2, assert_same_detections

GRID, STEPS = 96, 2
OPTIM = dict(OPTIMIZER="adam_onecycle", LR=1e-3, WEIGHT_DECAY=0.01, MOMS=[0.95, 0.85],
             PCT_START=0.4, DIV_FACTOR=10, GRAD_NORM_CLIP=10)
TEACHER = ("x_conv4", "x_conv5", "spatial_features_2d", "spatial_features_2d_8x")
RADAR = ("radar_x_conv4", "radar_spatial_features_8x_2", "radar_spatial_features_8x_1",
         "radar_spatial_features_2d", "radar_spatial_features_2d_8x")
PREDS = ("center", "center_z", "dim", "rot", "vel", "iou", "hm")
# conv biases that feed a train-mode BatchNorm, and the CMA leaves of
# tests/torch_train_case.py: a true gradient of zero
ZERO_GRAD = re.compile(
    r"(radar_)?backbone_3d\.conv\d_\d\.conv[12]\.conv\.bias"
    r"|(radar_)?dense_head\.(shared_conv|\w+\.conv_0)\.conv\.bias"
    r"|radar_cma\.(decoder_\d\.deconv|agg_\d\.conv\.conv)\.bias"
    r"|radar_cma\.encoder_3_1\.(pwconv2\.bias|grn\.beta)")


def model_cfg(kind):
    """(JAX cfg, port cfg, dataset info) of a topology: ``teacher`` (the dense
    LiDAR teacher alone, trained), ``radar`` (the dense radar branch alone,
    ``DISTILL: False``), ``smoke`` (both dense, the teacher frozen,
    ``DISTILL: True``: ``synthetic/smoke.yaml``), ``as_teacher`` (an
    ``_AS`` LiDAR teacher alone) or ``s2d_teacher`` (the space-to-depth
    teacher alone on the dense VFE's grid, trained)."""
    teacher = kind in ("teacher", "smoke", "as_teacher", "s2d_teacher")
    distill = {"teacher": None, "as_teacher": None, "s2d_teacher": None, "radar": False,
               "smoke": True}[kind]
    cfg, info = make_model_cfg(grid=GRID, teacher=teacher, radar=kind in ("radar", "smoke"),
                               distill=distill, num_max_objs=16, k_per_head=32, nms_post=8)
    if kind in ("teacher", "as_teacher", "s2d_teacher"):
        cfg.pop("FREEZE_PIPELINE")
    if kind == "s2d_teacher":
        cfg.BACKBONE_3D = JConfigDict(NAME="PillarRes18BackBone8x_S2D")
    if kind == "as_teacher":
        cfg.BACKBONE_3D = JConfigDict(NAME="PillarRes18BackBone8x_AS",
                                      MAX_ACTIVE=[2048, 2048, 1024, 512], DENSE_FROM=3)
    return cfg, ConfigDict(copy.deepcopy(cfg)), info


def _numpy_variables(jmodel, jbatch, seed=0):
    """A variable tree of ``jmodel`` without compiling its ``init``."""
    # train mode: the same tree as eval mode's, without tracing the decode
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, True), jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict({k: shapes[k] for k in ("params", "batch_stats")})
    for k, v in flat.items():
        if k[-1] == "kernel":
            bound = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            flat[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
        else:
            flat[k] = np.ones(v.shape, np.float32)
    return _perturb(flax.traverse_util.unflatten_dict(flat))


def make_setup(kind):
    """Everything one topology's tests read: cfgs, info, both batches, the
    JAX model and variables, and the port's model with them loaded."""
    cfg, pcfg, info = model_cfg(kind)
    scenes = []
    for s in (0, 1):
        scene = synthetic.make_scene(s, num_lidar=1500, num_radar=150, num_boxes=5,
                                     pc_range=info["point_cloud_range"])
        scene["gt_boxes"][:, 3:6] = np.clip(scene["gt_boxes"][:, 3:6], 0.5, 2.0)
        scenes.append(scene)
    batch = collate.collate_batch(scenes, {"MAX_LIDAR_POINTS": 1536, "MAX_RADAR_POINTS": 256,
                                           "NUM_MAX_OBJS": 16})
    batch.pop("_host", None)
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    jbatch = jax.tree.map(jnp.asarray, JaxHostPrecompute(cfg, *geo)(copy.deepcopy(batch)))
    tbatch = batch_to_torch(HostPrecompute(pcfg, *geo)(copy.deepcopy(batch)), "cpu")
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    variables = _numpy_variables(jmodel, jbatch)
    model = load_jax_variables(build_network(pcfg, info, device="cpu"), variables)
    return dict(kind=kind, cfg=cfg, pcfg=pcfg, info=info, jbatch=jbatch, tbatch=tbatch,
                jmodel=jmodel, variables=variables, model=model)


def scored(d):
    """Detections with a score above 0: with random weights many candidates
    score exactly 0 (the IoU rectifier clamps there), and which of those
    top-k keeps is arbitrary."""
    d = {k: np.asarray(v) for k, v in d.items()}
    return dict(d, valid=d["valid"] & (d["scores"] > 1e-6))


def assert_eval_matches(jout, tout, branches):
    """Features and predictions rel-L2 <= 1e-4; the scored detections entry
    by entry (``tests/test_torch_slice.py``'s near-tie rule)."""
    for branch in branches:
        feats, preds = (TEACHER, "lidar_preds") if branch == "teacher" else (RADAR, "radar_preds")
        for k in feats:
            assert tuple(tout[k].shape) == jout[k].shape, k
            assert _rel_l2(tout[k].detach().numpy(), jout[k]) <= 1e-4, k
        if preds in jout:
            for k in PREDS:
                assert _rel_l2(tout[preds][k].detach().numpy(), jout[preds][k]) <= 1e-4, k
    # the overflow counter exists where a branch takes pillar tables, as in JAX
    assert ("as_overflow" in tout) == ("as_overflow" in jout)
    assert int(tout.get("as_overflow", 0)) == int(jout.get("as_overflow", 0)) == 0
    want, got = scored(jout["final_box_dicts"]), scored(tout["final_box_dicts"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() > 10
    assert_same_detections(got, want, tol=1e-4)


def _capture():
    """An optax transformation that passes the gradients on unchanged and
    keeps them in its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _flat(tx, mask):
    """``tx`` applied to one vector, the trainable leaves (``mask``) of the
    tree raveled; the other leaves' updates pass through, as
    ``optax.masked`` passes them. Elementwise the same update as ``tx`` on the
    tree (the global norm of the clip sums in another order), for a compile
    of one leaf where the tree's costs one per leaf."""
    keys = [k for k, v in flax.traverse_util.flatten_dict(mask).items() if v]

    def ravel(tree):
        flat = flax.traverse_util.flatten_dict(tree)
        return ravel_pytree([flat[k] for k in keys])

    def update(g, s, p=None):
        gv, unravel = ravel(g)
        u, s = tx.update(gv, s, None if p is None else ravel(p)[0])
        flat = flax.traverse_util.flatten_dict(g)
        flat.update(zip(keys, unravel(u)))
        return flax.traverse_util.unflatten_dict(flat), s

    return optax.GradientTransformation(lambda p: tx.init(ravel(p)[0]), update)


def make_run(setup):
    """The eval forward at the initial weights and two train steps of each
    package, and what the tests read of them."""
    cfg, pcfg, info, jmodel = setup["cfg"], setup["pcfg"], setup["info"], setup["jmodel"]
    variables = setup["variables"]
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])

    # build_optimizer's chain on the raveled leaves its mask trains (all but
    # the DCN's down_bias: neither topology freezes a scope)
    mask = joptim.freeze_mask(variables["params"], set())
    tx = optax.chain(_capture(), _flat(joptim.build_optimizer(JConfigDict(OPTIM), None, 50)[0],
                                       mask))
    train_step = jstep.make_train_step(jmodel, tx, cfg, *geo)

    @jax.jit
    def run(state, batch):
        ev = jmodel.apply({"params": state.params, "batch_stats": state.batch_stats}, batch,
                          False)
        return (ev,) + train_step(state, batch)

    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             opt_state=tx.init(params))
    jmetrics, jafter = [], []
    for i in range(STEPS):
        ev, state, metrics = run(state, setup["jbatch"])
        jeval = jax.tree.map(np.asarray, ev) if i == 0 else jeval
        jgrads = jax.tree.map(np.asarray, state.opt_state[0]) if i == 0 else jgrads
        jmetrics.append(jax.tree.map(np.asarray, metrics))
        jafter.append(jax.tree.map(np.asarray, {"params": state.params,
                                                "batch_stats": state.batch_stats}))

    model = setup["model"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    teval = model.eval()(setup["tbatch"])
    opt, _ = build_optimizer(ConfigDict(OPTIM), model, 50, model.frozen)
    step = make_train_step(model, opt, pcfg, *geo)
    tmetrics, tafter = [], []
    for i in range(STEPS):
        tmetrics.append({k: v.detach().numpy() for k, v in step(setup["tbatch"]).items()})
        tafter.append({k: v.clone() for k, v in model.state_dict().items()})
        if i == 0:  # the gradients before the clip, which scales them in place
            norm = opt.grad_norm.item()
            scale = min(1.0, OPTIM["GRAD_NORM_CLIP"] / norm)
            tgrads = {n: p.grad / scale for n, p in model.named_parameters() if p.requires_grad}
    return dict(model=model, before=before, jeval=jeval, teval=teval, jmetrics=jmetrics,
                tmetrics=tmetrics, jgrads=state_dict_from_jax(model, {"params": jgrads}),
                tgrads=tgrads, grad_norm0=norm, lr=[opt.lr_sched(t) for t in range(STEPS)],
                tafter=tafter, jafter=[state_dict_from_jax(model, a) for a in jafter])


def test_eval_forward_matches_jax(run, setup):
    branch = "radar" if setup["kind"] == "radar" else "teacher"
    assert_eval_matches(run["jeval"], run["teval"], [branch])


def test_loss_and_terms_at_init_match_jax(run):
    jm, tm = run["jmetrics"][0], run["tmetrics"][0]
    assert set(tm) == set(jm) and "distll_loss" not in jm
    for k, v in jm.items():
        rtol = 1e-3 if k.startswith("iou_loss_head_") else 1e-4
        np.testing.assert_allclose(tm[k], v, rtol=rtol, atol=1e-7, err_msg=k)


def test_gradients_at_init_match_jax(run):
    jg, tg = run["jgrads"], run["tgrads"]
    assert tg and all(n in jg for n in tg)
    jnorm = np.sqrt(sum(float((jg[n].double() ** 2).sum()) for n in tg))
    np.testing.assert_allclose(run["grad_norm0"], jnorm, rtol=1e-3)
    for n, g in tg.items():
        if ZERO_GRAD.fullmatch(n):  # zero true gradient: rounding noise on both sides
            assert g.abs().max() <= 1e-5 * jnorm and jg[n].abs().max() <= 1e-5 * jnorm, n
        else:
            assert _rel_l2(g.numpy(), jg[n].numpy()) <= 2e-2, n


def test_parameters_and_statistics_after_steps_match_jax(run):
    model, before = run["model"], run["before"]
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    stats = [n for n, _ in model.named_buffers() if "running_" in n]
    # everything trains but the DCN's frozen bias
    assert {n for n, _ in model.named_parameters()} - set(trained) == {
        n for n, _ in model.named_parameters() if n.endswith("down_bias")}
    assert stats
    for n in stats:  # the first step's BN update, from the same weights
        np.testing.assert_allclose(run["tafter"][0][n].numpy(), run["jafter"][0][n].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=n)
    for i in range(STEPS):
        reach = 2.1 * sum(run["lr"][:i + 1])
        after, want = run["tafter"][i], run["jafter"][i]
        for n in trained:
            assert not torch.equal(after[n], before[n]), n
            assert (after[n] - want[n]).abs().max() <= reach, (i, n)
    got = [float(m["loss"]) for m in run["tmetrics"]]
    want = [float(m["loss"]) for m in run["jmetrics"]]
    np.testing.assert_allclose(got, want, rtol=5e-3)
    assert got[1] != got[0]
