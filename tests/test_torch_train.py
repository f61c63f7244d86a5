"""The port's distillation train step against the JAX package, float32, CPU.

``radar_distill_train.yaml`` at grid 128, batch 2 (4000 lidar points and 300
radar returns per scene, 10 boxes, ``INT8: false`` and the shipped ``INT8:
static``). The batch is collated once and goes through each package's
``HostPrecompute``; the JAX variables come from ``model.init`` with every BN
statistic and scale and every bias overwritten by seeded numpy values and are
bridged into the port by ``convert.py``. Both sides then take the same three
steps: the JAX package's ``make_train_step`` (jitted once per mode, together
with ``jax.grad`` of the same loss so that the gradients at init cost no second
compile) and the port's. Updated JAX variables are bridged again and compared
with ``model.state_dict()``.

Tolerances, and why they are what they are. At init: loss and every ``tb``
entry rtol 1e-4 (the per-head IoU terms 1e-3: their targets come out of the
float32 polygon clipping); gradients rel-L2 <= 2e-2 per leaf, global norm rtol
1e-3. The gradients agree to about 1e-2 only, and not for a fault of either
package: with these weights the head's heatmap gradient nearly cancels in the
train-mode BatchNorm backward, and the port's own float32 gradient moves by
1e-2 when nothing but the number of CPU threads (the order of summation)
changes. After the first step, which both packages take from the same weights:
BN statistics <= 1e-4, parameters rel-L2 <= 2e-3, the updates' cosine >= 0.9.
Adam's first updates are ``lr * sign(g)`` for every element, so an element
whose gradient lies inside that noise may go the other way; each element
stays within ``2.1 * sum(lr)`` of the JAX package's (each side moves it by at
most about ``lr`` per step), and that is held for every element.
From the second step on the two trajectories drift apart at that rate: after 3
steps the loss of each step rtol 5e-3 (measured 1.3e-3), parameters rel-L2 <=
2e-2 (measured 1e-2), the updates' cosine >= 0.7 (measured 0.85 or more, less
on one 27-element bias), BN statistics
within 5e-2 (measured 2.5e-2), frozen leaves bit-equal.

36 leaves of the student have a true gradient of zero and are held to absolute
bounds only: the 34 conv biases that feed a train-mode BatchNorm (it subtracts
the mean they shift) and ``encoder_3_1``'s last bias and GRN beta (a constant
shift of the input of ``agg_2``'s 1x1 conv, which its BatchNorm removes). What
both packages compute for them is rounding noise, and Adam moves them by up to
the learning rate per step in a direction that the noise decides.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.data.host_precompute import HostPrecompute as JaxHostPrecompute
from radardistill_tpu.models import build_network as jax_build_network
from radardistill_tpu.models import compute_training_loss as jax_training_loss
from radardistill_tpu.train import optim as joptim
from radardistill_tpu.train import train_step as jstep
from radardistill_tpu.utils.production import production_cfg as j_production_cfg
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.data import collate, synthetic
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network, compute_training_loss
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.train.optim import build_optimizer, freeze_mask
from radardistill_tpu_torch.train.train_step import make_train_step
from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg
from tests.test_torch_slice import _perturb, _rel_l2

GRID, STEPS = 128, 3
SCOPES = ("radar_vfe", "radar_backbone_3d", "radar_cma", "radar_neck", "radar_dense_head")
FROZEN = {"vfe", "backbone_3d", "backbone_2d", "dense_head"}
ZERO_GRAD = re.compile(
    r"radar_backbone_3d\.conv\d_\d\.conv[12]\.conv\.bias"
    r"|radar_cma\.(decoder_\d\.deconv|agg_\d\.conv\.conv)\.bias"
    r"|radar_cma\.encoder_3_1\.(pwconv2\.bias|grn\.beta)"
    r"|radar_dense_head\.(shared_conv|\w+\.conv_0)\.conv\.bias")


@pytest.fixture(scope="module")
def inputs():
    full, info = production_cfg(TRAIN_YAML, grid=GRID)
    jfull, _ = j_production_cfg(TRAIN_YAML, grid=GRID)
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
    return full, jfull, info, jbatch, tbatch, variables


@pytest.fixture(scope="module", params=[False, "static"], ids=["int8-false", "int8-static"])
def run(request, inputs):
    full, jfull, info, jbatch, tbatch, variables = inputs
    cfg = copy.deepcopy(full.MODEL)
    cfg.BACKBONE_3D.INT8 = request.param
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])

    # ---- the JAX package: make_train_step, plus jax.grad of the same loss
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    tx, _ = joptim.build_optimizer(jfull.OPTIMIZATION, variables["params"], 1000, sorted(FROZEN))
    train_step = jstep.make_train_step(jmodel, tx, cfg, *geo)

    def loss_only(params, batch_stats, batch):
        out, _ = jmodel.apply({"params": params, "batch_stats": batch_stats}, batch, True,
                              mutable=["batch_stats", "diagnostics"])
        return jax_training_loss(cfg, out, *geo)[0]

    @jax.jit
    def step_and_grads(state, batch):
        grads = jax.grad(loss_only)(state.params, state.batch_stats, batch)
        return train_step(state, batch) + (grads,)

    jparams = jax.tree.map(jnp.asarray, variables["params"])
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                             batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             opt_state=tx.init(jparams))
    jmetrics, jafter = [], []
    for i in range(STEPS):
        state, metrics, grads = step_and_grads(state, jbatch)
        jmetrics.append(jax.tree.map(np.asarray, metrics))
        jafter.append(jax.tree.map(np.asarray, {"params": state.params,
                                                "batch_stats": state.batch_stats}))
        jgrads = jax.tree.map(np.asarray, grads) if i == 0 else jgrads

    # ---- the port
    model = load_jax_variables(build_network(cfg, info, device="cpu"), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    probe = copy.deepcopy(model).train()  # gradients at init, without touching the model
    loss0, _ = compute_training_loss(cfg, probe(tbatch), *geo)
    names = [n for n, p in probe.named_parameters() if p.requires_grad]
    tgrads = dict(zip(names, torch.autograd.grad(
        loss0, [p for p in probe.parameters() if p.requires_grad])))
    step = make_train_step(model, opt, cfg, *geo)
    tmetrics, tafter = [], []
    for _ in range(STEPS):
        tmetrics.append({k: v.numpy() for k, v in step(tbatch).items()})
        tafter.append({k: v.clone() for k, v in model.state_dict().items()})
    return dict(mode=request.param, model=model, before=before, jmetrics=jmetrics,
                tmetrics=tmetrics, jgrads=state_dict_from_jax(model, {"params": jgrads}),
                tgrads=tgrads, loss0=loss0.item(), lr=[opt.lr_sched(t) for t in range(STEPS)],
                # after the first and after the last step
                tafter={1: tafter[0], STEPS: tafter[-1]},
                jafter={1: state_dict_from_jax(model, jafter[0]),
                        STEPS: state_dict_from_jax(model, jafter[-1])})


def test_loss_and_terms_at_init_match_jax(run):
    jm, tm = run["jmetrics"][0], run["tmetrics"][0]
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-4)
    np.testing.assert_allclose(run["loss0"], jm["loss"], rtol=1e-4)
    assert set(tm) == set(jm) | {"grad_norm"}
    assert {"rpn_loss", "distll_loss", "dcn_offset_sat", "as_overflow"} <= set(jm)
    for k, v in jm.items():
        # the IoU targets come out of the float32 polygon clipping, whose
        # intersections XLA fuses (and rounds) differently: 1e-3 there
        rtol = 1e-3 if k.startswith("iou_loss_head_") else 1e-4
        np.testing.assert_allclose(tm[k], v, rtol=rtol, atol=1e-7, err_msg=k)
    assert int(tm["as_overflow"]) == 0 and 0.0 <= float(tm["dcn_offset_sat"]) <= 1.0


@pytest.mark.parametrize("scope", SCOPES)
def test_gradients_at_init_match_jax(run, scope):
    jg, tg = run["jgrads"], run["tgrads"]
    names = [n for n in tg if n.split(".", 1)[0] == scope]
    assert names and all(n in jg for n in names)
    gnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in tg.values()))
    for n in names:
        if ZERO_GRAD.fullmatch(n):  # zero true gradient: rounding noise on both sides
            assert tg[n].abs().max() <= 1e-5 * gnorm and jg[n].abs().max() <= 1e-5 * gnorm, n
        else:
            assert _rel_l2(tg[n].numpy(), jg[n].numpy()) <= 2e-2, n


def test_gradient_global_norm_and_frozen_leaves_match_jax(run):
    jg, tg = run["jgrads"], run["tgrads"]
    mask = freeze_mask(run["model"].named_parameters(), FROZEN)
    assert set(tg) == {n for n, ok in mask.items() if ok}
    assert all(not n.endswith("down_bias") and n.split(".", 1)[0] not in FROZEN for n in tg)
    jnorm = np.sqrt(sum(float((jg[n].double() ** 2).sum()) for n in tg))
    tnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in tg.values()))
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-3)
    np.testing.assert_allclose(run["tmetrics"][0]["grad_norm"], jnorm, rtol=1e-3)
    # what the JAX package stops: exactly zero gradients there
    for n, ok in mask.items():
        if not ok:
            assert float(jg[n].abs().max()) == 0.0, n


def test_loss_of_each_step_matches_jax(run):
    got = [float(m["loss"]) for m in run["tmetrics"]]
    want = [float(m["loss"]) for m in run["jmetrics"]]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=5e-3)
    assert len(set(want)) == STEPS  # the steps did change the loss


# after how many steps -> (parameter rel-L2, least cosine of the updates, BN statistics)
STEP_TOL = {1: (2e-3, 0.9, 1e-4), STEPS: (2e-2, 0.7, 5e-2)}


@pytest.mark.parametrize("n_steps", sorted(STEP_TOL))
@pytest.mark.parametrize("scope", SCOPES)
def test_parameters_after_steps_match_jax(run, scope, n_steps):
    after, before, want = run["tafter"][n_steps], run["before"], run["jafter"][n_steps]
    names = [n for n, p in run["model"].named_parameters()
             if p.requires_grad and n.split(".", 1)[0] == scope]
    assert names
    rel_tol, cos_tol, _ = STEP_TOL[n_steps]
    reach = 2.1 * sum(run["lr"][:n_steps])
    for n in names:
        assert not torch.equal(after[n], before[n]), n
        assert (after[n] - want[n]).abs().max() <= reach, n
        if ZERO_GRAD.fullmatch(n):
            continue
        assert _rel_l2(after[n].numpy(), want[n].numpy()) <= rel_tol, n
        dt, dj = ((x[n] - before[n]).flatten().double() for x in (after, want))
        assert dt @ dj >= cos_tol * dt.norm() * dj.norm(), n


@pytest.mark.parametrize("n_steps", sorted(STEP_TOL))
@pytest.mark.parametrize("scope", SCOPES)
def test_bn_statistics_after_steps_match_jax(run, scope, n_steps):
    after, before, want = run["tafter"][n_steps], run["before"], run["jafter"][n_steps]
    names = [n for n, _ in run["model"].named_buffers()
             if n.split(".", 1)[0] == scope and "running_" in n]
    assert names
    tol = STEP_TOL[n_steps][2]
    for n in names:
        np.testing.assert_allclose(after[n].numpy(), want[n].numpy(), rtol=0, atol=tol, err_msg=n)
        assert not torch.equal(after[n], before[n]), n


def test_frozen_leaves_are_bit_equal_after_steps(run):
    after, before, want = run["model"].state_dict(), run["before"], run["jafter"][STEPS]
    frozen = [n for n in after if n.split(".", 1)[0] in FROZEN or n.endswith("down_bias")]
    assert len(frozen) > 200
    for n in frozen:
        assert torch.equal(after[n], before[n]), n
        if n in want:  # the JAX package leaves them alone as well
            np.testing.assert_array_equal(want[n].numpy(), before[n].numpy(), err_msg=n)
    assert run["model"].training and not run["model"].backbone_3d.training
    assert run["model"].radar_cma.training and run["model"].radar_neck.training


def test_eval_forward_after_training_decodes(run, inputs):
    """Back in eval mode the trained model runs the whole forward again."""
    model = run["model"]
    out = model.eval()(inputs[4])
    model.train()
    assert "final_box_dicts" in out and "lidar_preds" in out and "target_dicts" not in out
    assert all(torch.isfinite(v).all() for v in out["radar_preds"].values())


def test_cma_and_neck_train_even_when_their_scope_is_frozen(inputs):
    """The reference asks for the scope ``radar_backbone_2d``, which
    FREEZE_PIPELINE never yields: under ``Radar_Distill`` the CMA and the neck
    stay out of the optimizer but keep BN train mode."""
    full, _, info, _, _, _ = inputs
    cfg = copy.deepcopy(full.MODEL)
    cfg.FREEZE_PIPELINE = list(cfg.FREEZE_PIPELINE) + ["Radar_Distill", "Radar_CenterHead"]
    model = build_network(cfg, info, device="cpu").train()
    assert {"radar_cma", "radar_neck", "radar_dense_head"} <= model.frozen
    assert model.radar_cma.training and model.radar_neck.training
    assert not model.radar_dense_head.training and not model.vfe.training
    mask = freeze_mask(model.named_parameters(), model.frozen)
    assert not any(ok for n, ok in mask.items() if n.startswith(("radar_cma", "radar_neck")))
    assert any(ok for n, ok in mask.items() if n.startswith("radar_backbone_3d"))


def test_unported_train_legs_raise_by_name(inputs):
    full, _, info, _, _, _ = inputs
    with pytest.raises(NotImplementedError, match="remat"):
        build_network(full.MODEL, info, device="cpu", remat=True)
    with pytest.raises(NotImplementedError, match="anchor"):
        compute_training_loss({"NAME": "PointPillar"}, {}, (), (), ())
    model = build_network(full.MODEL, info, device="cpu")
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 10, model.frozen)
    with pytest.raises(NotImplementedError, match="shard_map"):
        make_train_step(model, opt, full.MODEL, (), (), (), mesh=object(), sync_bn=False)
    cfg = copy.deepcopy(full.MODEL)
    cfg.FREEZE_PIPELINE = [n for n in cfg.FREEZE_PIPELINE if n != "PillarRes18BackBone8x"]
    with pytest.raises(NotImplementedError, match="S2D teacher"):
        build_network(cfg, info, device="cpu").train()
