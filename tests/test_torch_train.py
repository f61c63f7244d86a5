"""The port's distillation train step against the JAX package, float32, CPU,
with the teacher's ``INT8: false`` (``tests/torch_train_case.py`` states the
case and its tolerances; ``tests/test_torch_train_static.py`` runs it with
``INT8: static``). Also here: the tests that need no train step, and the
reference initializer (``build_network(..., generator=g)``) held against the
laws of the JAX package's ``model.init``.
"""

import copy

import pytest
import torch

from radardistill_tpu_torch.convert import state_dict_from_jax
from radardistill_tpu_torch.models import build_network, compute_training_loss
from radardistill_tpu_torch.parallel.mesh import make_mesh
from radardistill_tpu_torch.train.optim import build_optimizer, freeze_mask
from radardistill_tpu_torch.train.train_step import make_train_step
from tests.torch_train_case import (  # noqa: F401  the tests of the case, collected here
    test_loss_and_terms_at_init_match_jax,
    test_gradients_at_init_match_jax,
    test_gradient_global_norm_and_frozen_leaves_match_jax,
    test_loss_of_each_step_matches_jax,
    test_parameters_after_steps_match_jax,
    test_bn_statistics_after_steps_match_jax,
    test_frozen_leaves_are_bit_equal_after_steps,
    test_eval_forward_after_training_decodes,
    make_inputs, make_run)

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module", params=[False], ids=["int8-false"])
def run(request, inputs):
    return make_run(inputs, request.param)


# leaves at least this large are held to their law's moments; smaller random
# leaves to their mean and spread only
LARGE = 4096


def _moments(a):
    a = a.double().flatten()
    c = a - a.mean()
    return a.mean().item(), a.std().item(), ((c ** 4).mean() / (c ** 2).mean() ** 2).item()


def test_reference_initializer_draws_the_laws_of_jax_init(inputs):
    """``build_network(..., generator=g)`` against the variables of one JAX
    ``model.init`` of the train yaml (grid 128), leaf by leaf, in the port's
    layout. A leaf that JAX fills with one value (zero biases, the hm prior
    -2.19, BN scale 1, shift 0, mean 0, variance 1, GRN and the DCN's bias 0)
    is that value exactly. A random leaf has mean 0 within 5 std / sqrt(n)
    and its std within max(5%, 5 / sqrt(2n)) of JAX's; a large one (n >=
    4096) also the kurtosis of its law within 0.3 (uniform 1.8, truncated
    normal 2.6, normal 3: tells them apart) and, where the law is bounded
    (kurtosis below 2.7), the same largest magnitude within 3%."""
    full, info, raw = inputs[0], inputs[2], inputs[6]
    model = build_network(full.MODEL, info, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    got = model.state_dict()
    want = state_dict_from_jax(model, raw)
    assert set(want) == set(got)
    kinds = {"constant": 0, "uniform": 0, "normal": 0, "truncated": 0}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        flat = w.flatten()
        if bool((flat == flat[0]).all()):
            assert bool((g == flat[0]).all()), (name, float(flat[0]))
            kinds["constant"] += 1
            continue
        n = w.numel()
        (gm, gs, gk), (wm, ws, wk) = _moments(g), _moments(w)
        assert abs(gm) <= 5 * ws / n ** 0.5 and abs(wm) <= 5 * ws / n ** 0.5, (name, gm, wm)
        assert abs(gs / ws - 1) <= max(0.05, 5 / (2 * n) ** 0.5), (name, gs, ws)
        if n < LARGE:
            continue
        assert abs(gk - wk) <= 0.3, (name, gk, wk)
        if wk < 2.7:
            gmax, wmax = g.abs().max().item(), w.abs().max().item()
            assert abs(gmax / wmax - 1) <= 0.03, (name, gmax, wmax)
        kinds["uniform" if wk < 2.2 else "truncated" if wk < 2.7 else "normal"] += 1
    assert all(kinds.values()), kinds  # every law of the reference is met here


def test_cma_and_neck_train_even_when_their_scope_is_frozen(inputs):
    """The reference asks for the scope ``radar_backbone_2d``, which
    FREEZE_PIPELINE never yields: under ``Radar_Distill`` the CMA and the neck
    stay out of the optimizer but keep BN train mode."""
    full, info = inputs[0], inputs[2]
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
    """The legs that once raised by name now run: ``remat`` builds the model
    with its backbones and CMA checkpointed (``tests/test_torch_misc_modules.py``
    holds its step), the anchor family's loss is routed to
    ``anchor_training_loss``, the shard_map leg and the S2D teacher outside
    ``FREEZE_PIPELINE`` train."""
    from tests.test_torch_anchor import INFO, _model_cfg

    full, info = inputs[0], inputs[2]
    assert build_network(full.MODEL, info, device="cpu", remat=True).remat
    cfg = _model_cfg("PointPillar", "DynamicPillarVFESimple2D")[1]
    a = 16 * 16 * 4
    g = torch.Generator().manual_seed(0)
    labels = torch.randint(-1, 3, (2, a), generator=g, dtype=torch.int32)
    out = {"anchor_preds": {"cls_preds": torch.randn(2, a, 2, generator=g),
                            "box_preds": torch.randn(2, a, 7, generator=g),
                            "dir_cls_preds": torch.randn(2, a, 2, generator=g)},
           "target_dicts": {"box_cls_labels": labels,
                            "box_reg_targets": torch.randn(2, a, 7, generator=g)}}
    loss, tb = compute_training_loss(cfg, out, INFO["class_names"], INFO["voxel_size"],
                                     INFO["point_cloud_range"])
    assert sorted(tb) == ["rpn_loss", "rpn_loss_cls", "rpn_loss_dir", "rpn_loss_loc"]
    assert torch.isfinite(loss) and loss == tb["rpn_loss"] and loss > 0
    model = build_network(full.MODEL, info, device="cpu")
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 10, model.frozen)
    # the shard_map leg no longer raises: one process is a mesh of one, no DDP
    step = make_train_step(model, opt, full.MODEL, (), (), (), mesh=make_mesh("cpu"),
                           sync_bn=False)
    assert step.ddp is None and step.state.model is model
    # the S2D teacher outside FREEZE_PIPELINE no longer raises: it trains
    cfg = copy.deepcopy(full.MODEL)
    cfg.FREEZE_PIPELINE = [n for n in cfg.FREEZE_PIPELINE if n != "PillarRes18BackBone8x"]
    model = build_network(cfg, info, device="cpu").train()
    assert model.backbone_3d.training and not model.vfe.training
    mask = freeze_mask(model.named_parameters(), model.frozen)
    assert all(ok for n, ok in mask.items() if n.startswith("backbone_3d."))
