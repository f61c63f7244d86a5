"""The rest of the port's last modules against the JAX package, float32, CPU:

- ``CenterHead`` alone on one fixed input and cotangent: its gradient against
  JAX's (the dense teacher's head, merged form), and the unmerged head of
  ``NUM_HM_CONV`` 1 and 3 (``tests/test_merged_head.py``'s sizes) in eval
  and train mode;
- ``OPTIMIZER: adam`` and ``sgd`` across a checkpoint: a resumed run equals
  one that did not stop, bit for bit (the per-update match with optax is
  ``tests/test_torch_losses.py::test_other_optimizers_raise_by_name``);
- ``MODEL.REMAT``: a train step of the radar-only PillarNet (grid 64) and of
  the anchor detector with remat against one without, from the same weights;
- ``utils/similarity.py`` against the JAX module (``tests/test_similarity.py``'s
  cases), ``utils/profiler.py``, and ``tools/torch_calc_caps.py`` against
  ``tools/calc_caps.py``.

The head cases run in JAX under one ``jit``.

Tolerances: the head's gradient, per parameter and for its input, is held
to the port's own float64 gradient on the same weights, input and
cotangent: rel-L2 <= 1e-5 (measured 1.2e-7 to 2.2e-6). JAX's gradient,
jitted in float32, is itself 1e-3 to 2.6e-3 from that float64 gradient in
the ``hm`` subhead's conv_0 and bn_0, the shared conv and BN and the input
(below 1e-5 elsewhere), so it is held to 5e-3. The conv biases that feed a
train-mode BatchNorm have a true gradient of zero and are held to 1e-5 of
the global norm. Head outputs rel-L2 <= 1e-5, running statistics atol
1e-5. Remat: the loss and every running statistic
bit-equal, gradients within 1e-6 relative (the recompute reruns the same
kernels on the CPU: measured equal), and the synchronized BatchNorms' sums
reduced once per forward, as without remat. Similarity: 1e-9 (both float64
numpy).
"""

import copy
import os
import sys

import jax
import numpy as np
import pytest
import torch

from radardistill_tpu.models.center_head import CenterHead as JHead
from radardistill_tpu.models.center_head import HeadSpec as JSpec
from radardistill_tpu.utils import similarity as jsim
from radardistill_tpu.utils.testing import CLASS_NAMES, HEADS_GROUPS, make_model_cfg
from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.data import collate, synthetic
from radardistill_tpu_torch.models import build_network, compute_training_loss
from radardistill_tpu_torch.models import center_head as tch
from radardistill_tpu_torch.models import layers
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.parallel import mesh
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import TrainState
from radardistill_tpu_torch.utils import profiler
from radardistill_tpu_torch.utils import similarity as tsim
from tests.test_torch_anchor import _numpy_variables
from tests.test_torch_slice import _rel_l2

torch.set_num_threads(1)

T = torch.from_numpy


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------- the head

HEAD_CASES = {"merged": (2, 64, 256), "hm1": (1, 32, 128), "hm3": (3, 32, 128)}


@pytest.fixture(scope="module")
def head_runs():
    """Per case: (variables, input, cotangent, eval output, train output and
    statistics, and for the merged head the gradient of sum(preds ·
    cotangent) over the parameters and the input)."""
    spec = JSpec(HEADS_GROUPS, CLASS_NAMES)
    cases, args = {}, {}
    for name, (hm, shared, cin) in HEAD_CASES.items():
        rng = np.random.RandomState(len(name))
        x = rng.randn(2, 16, 16, cin).astype(np.float32)
        jm = JHead(spec=spec, shared_channels=shared, num_hm_conv=hm)
        v = _numpy_variables(jax.eval_shape(lambda jm=jm, x=x: jm.init(jax.random.PRNGKey(0), x,
                                                                        False)), seed=3)
        out = jax.eval_shape(lambda jm=jm, x=x, v=v: jm.apply(v, x, False))
        cot = {k: rng.randn(*o.shape).astype(np.float32) for k, o in out.items()}
        cases[name] = jm
        args[name] = (v, x, cot)

    def run(args):
        res = {}
        for name, jm in cases.items():
            v, x, cot = args[name]

            def f(p, x, jm=jm, v=v, cot=cot):
                out, upd = jm.apply({**v, "params": p}, x, True, mutable=["batch_stats"])
                return sum((out[k] * cot[k]).sum() for k in out), (out, upd)

            (_, train), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
                v["params"], x)
            res[name] = (jm.apply(v, x, False), train, grads)
        return res

    return args, _np(jax.jit(run)(args))


def _port_head(name, variables):
    hm, shared, cin = HEAD_CASES[name]
    spec = tch.HeadSpec(HEADS_GROUPS, CLASS_NAMES)
    return load_jax_variables(tch.CenterHead(spec, cin, shared, hm, True), variables)


@pytest.mark.parametrize("name", ["hm1", "hm3"])
def test_unmerged_head_matches_jax(head_runs, name):
    """``NUM_HM_CONV`` 1 (``hm``'s conv_out a dense conv on the shared
    features) and 3 (a grouped hidden conv): eval and train outputs and the
    running statistics; the other subheads keep their two convs. The
    reference's laws: the ``hm`` output bias -2.19."""
    args, runs = head_runs
    variables, x, _ = args[name]
    jeval, (jtrain, upd), _ = runs[name]
    head = _port_head(name, variables)
    assert not head.merged and head.hm.num_conv == HEAD_CASES[name][0]
    for train, want in ((False, jeval), (True, jtrain)):
        got = head.train(train)(T(x))
        assert sorted(got) == sorted(want)
        for k in want:
            assert _rel_l2(got[k].detach().numpy(), want[k]) <= 1e-5, (train, k)
    for k, v in state_dict_from_jax(head, dict(upd)).items():
        np.testing.assert_allclose(head.state_dict()[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    layers.init_reference_(head, torch.Generator().manual_seed(0))
    assert torch.all(head.hm.conv_out.bias == -2.19)


def test_center_head_gradient_matches_jax(head_runs):
    """The dense teacher's head (merged, 64 shared channels, 256 in) in train
    mode: the gradient of sum(preds · cotangent) over every parameter and
    over the input, on JAX's input and cotangent, against the port's own
    float64 gradient and against JAX's."""
    args, runs = head_runs
    variables, x, cot = args["merged"]
    _, _, (jgp, jgx) = runs["merged"]
    grads = {}
    for dt in (torch.float64, torch.float32):
        head = _port_head("merged", variables).train().to(dt)
        xt = T(x).to(dt).requires_grad_()
        out = head(xt)
        sum((out[k] * T(cot[k]).to(dt)).sum() for k in out).backward()
        grads[dt] = {"input": xt.grad.double().numpy(),
                     **{k: p.grad.double().numpy() for k, p in head.named_parameters()}}
    want = {"input": jgx, **{k: v.numpy() for k, v in state_dict_from_jax(
        head, {"params": jgp}).items()}}
    norm = np.sqrt(sum((v ** 2).sum() for v in grads[torch.float64].values()))
    for k, g64 in grads[torch.float64].items():
        g32 = grads[torch.float32][k]
        if k.endswith("conv.bias") and ("shared_conv" in k or "conv_0" in k):
            for g in (g32, want[k]):  # a true gradient of 0: noise
                assert np.abs(g - g64).max() <= 1e-5 * norm, k
            continue
        assert _rel_l2(g32, g64) <= 1e-5, k
        assert _rel_l2(want[k], g64) <= 5e-3, k


# ------------------------------------------------------------ optimizers


class _Small(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = torch.nn.Linear(5, 4)
        self.frozen = torch.nn.Linear(2, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))

    def forward(self, x):
        return (self.a(x) ** 2).sum() + self.frozen(x[:, :2]).sum()


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_adam_and_sgd_resume_bit_equal(tmp_path, name):
    """Three updates in a row equal one, a checkpoint, a restore into a
    fresh model and optimizer, and two more, bit for bit (parameters, the
    rule's state, the update count); the frozen scope never moves."""
    cfg = ConfigDict(OPTIMIZER=name, LR=3e-2, WEIGHT_DECAY=0.01, MOMENTUM=0.9,
                     GRAD_NORM_CLIP=5)
    xs = [torch.randn(8, 5, generator=torch.Generator().manual_seed(i)) for i in range(3)]

    def steps(state, xs):
        for x in xs:
            state.optimizer.zero_grad()
            state.model(x).backward()
            state.optimizer.step()
        return state

    def fresh():
        model = _Small()
        return TrainState(model, build_optimizer(cfg, model, 10, ("frozen",))[0])

    straight = steps(fresh(), xs)
    mgr = CheckpointManager(tmp_path)
    mgr.save(steps(fresh(), xs[:1]), epoch=1, it=1)
    resumed = steps(mgr.restore(fresh())[0], xs[1:])
    assert resumed.optimizer.count == straight.optimizer.count == 3
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert torch.equal(straight.model.frozen.weight, _Small().frozen.weight)
    sa, sb = resumed.optimizer.state_dict(), straight.optimizer.state_dict()
    assert list(sb) == ["count", {"adam": "adamw", "sgd": "sgd"}[name]]
    for i, st in sb[list(sb)[1]]["state"].items():
        for k, v in st.items():
            assert torch.equal(sa[list(sa)[1]]["state"][i][k], v), (i, k)


# ------------------------------------------------------------------ remat


def _radar_setup():
    cfg, info = make_model_cfg(grid=64, teacher=False, radar=True, distill=False,
                               num_max_objs=16, k_per_head=32, nms_post=8)
    scenes = [synthetic.make_scene(s, num_lidar=100, num_radar=150, num_boxes=5,
                                   pc_range=info["point_cloud_range"]) for s in (0, 1)]
    batch = collate.collate_batch(scenes, {"MAX_LIDAR_POINTS": 128, "MAX_RADAR_POINTS": 256,
                                           "NUM_MAX_OBJS": 16})
    batch.pop("_host", None)
    return ConfigDict(copy.deepcopy(cfg)), info, batch_to_torch(batch, "cpu")


def _anchor_setup():
    from tests.test_torch_anchor import INFO, _batch, _model_cfg

    return _model_cfg("PointPillar", "DynamicPillarVFESimple2D")[1], INFO, {
        k: T(v) for k, v in _batch("DynamicPillarVFESimple2D").items()}


@pytest.mark.parametrize("kind", ["radar", "anchor"])
def test_remat_matches_no_remat(kind, monkeypatch):
    """One train forward and backward with ``remat`` (the 3D backbone and the
    CMA, or the anchor family's BEV backbone, under
    ``torch.utils.checkpoint``) against one without, from the same weights,
    inside a synchronized-BN scope whose reductions are counted (identity
    sums: one process): the loss and every running statistic bit-equal
    (the recompute moves no statistic), the gradients equal, and as many
    forward reductions and backward all-reduces as without remat."""
    cfg, info, batch = _radar_setup() if kind == "radar" else _anchor_setup()
    calls = {"sum": 0, "all_reduce": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mesh._AllReduceSum, "apply", count("sum", lambda x, group: x * 1.0))
    monkeypatch.setattr(layers.dist, "all_reduce", count("all_reduce", lambda *a, **k: None))
    runs = []
    for remat in (False, True):
        calls.update(sum=0, all_reduce=0)
        model = build_network(cfg, info, device="cpu", remat=remat,
                              generator=torch.Generator().manual_seed(5)).train()
        with mesh.sync_batch(object()):
            out = model(batch)
            loss, _ = compute_training_loss(cfg, out, info["class_names"], info["voxel_size"],
                                            info["point_cloud_range"])
            n_forward = calls["sum"]
            loss.backward()
        runs.append((model, loss.detach(), dict(calls), n_forward))
    (m0, l0, c0, f0), (m1, l1, c1, f1) = runs
    assert m1.remat and torch.equal(l0, l1)
    assert c0 == c1 and f0 == f1 > 0 and c0["all_reduce"] > 0
    buffers = dict(m1.named_buffers())
    for k, v in m0.named_buffers():
        assert torch.equal(buffers[k], v), k
    params = dict(m1.named_parameters())
    for k, p in m0.named_parameters():
        if p.grad is not None:
            assert _rel_l2(params[k].grad.numpy(), p.grad.numpy()) <= 1e-6, k


# --------------------------------------------------- similarity, tools


def test_similarity_matches_jax(tmp_path):
    """The footprints, the pooled features, cosine and both CKAs, and the
    engine's class x class sums and CSVs, against the JAX package's module;
    the port's engine also reads tensors."""
    pcr = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    rng = np.random.RandomState(1)
    boxes = np.array([[0, 0, 0, 4, 2, 1, 0.0], [0, 0, 0, 4, 2, 1, np.pi / 2],
                      [0.5, 0.5, 0, 2, 2, 1, 0.3]], np.float32)
    for name in ("world_to_bev_rc",):
        np.testing.assert_array_equal(getattr(tsim, name)(-8.0, 8.0, pcr, 16, 16),
                                      getattr(jsim, name)(-8.0, 8.0, pcr, 16, 16))
    np.testing.assert_array_equal(tsim.box_pixel_masks(boxes, pcr, 16, 16),
                                  jsim.box_pixel_masks(boxes, pcr, 16, 16))
    bev = rng.randn(16, 16, 3).astype(np.float32)
    for pooling in ("center", "avg", "max"):
        np.testing.assert_array_equal(tsim.extract_box_features(bev, boxes, pcr, pooling),
                                      jsim.extract_box_features(bev, boxes, pcr, pooling))
    f, x, y = rng.randn(4, 16), rng.randn(6, 8), rng.randn(6, 8)
    np.testing.assert_allclose(tsim.cosine_matrix(f), jsim.cosine_matrix(f), atol=1e-12)
    for deb in (False, True):
        assert abs(tsim.cka_linear(x, y, deb) - jsim.cka_linear(x, y, deb)) <= 1e-9
        assert abs(tsim.cka_rbf(x, y, deb) - jsim.cka_rbf(x, y, deb)) <= 1e-9
    feats = rng.randn(2, 16, 16, 8).astype(np.float32)
    gt = np.zeros((2, 4, 8), np.float32)
    gt[0, :3] = [[0, 0, 0, 2, 2, 1, 0, 1], [3, 3, 0, 2, 2, 1, 0, 2], [-3, -3, 0, 2, 2, 1, 0, 1]]
    gt[1, 0] = [1, 1, 0, 2, 2, 1, 0, 2]  # one instance: skipped
    engines = []
    for mod, out, batch in ((jsim, {"sp": feats}, {"gt_boxes": gt}),
                            (tsim, {"sp": T(feats)}, {"gt_boxes": T(gt)})):
        eng = mod.BEVSimilarityEngine("sp", "sp", ["car", "ped"], pcr, pooling="avg")
        eng.process_batch(out, batch)
        engines.append(eng)
    for k, v in engines[0].summary().items():
        np.testing.assert_allclose(engines[1].summary()[k], v, atol=1e-9, err_msg=k)
    assert engines[1].summary()["counts"].sum() == 6
    dirs = [eng.save(tmp_path / name) for eng, name in zip(engines, ("jax", "port"))]
    for k in ("cosine", "cka_linear", "cka_rbf", "counts"):
        assert open(os.path.join(dirs[1], f"{k}.csv")).read() == open(
            os.path.join(dirs[0], f"{k}.csv")).read()


def test_profiler_trace_and_step_timer(tmp_path):
    with profiler.trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name.startswith("trace_") and trace.stat().st_size > 0


def test_calc_caps_matches_the_jax_tool(monkeypatch, capsys):
    """Both tools on the same synthetic scenes (grid 128): the same
    recommended capacities."""
    from tools import calc_caps, torch_calc_caps

    args = ["--n_samples", "2", "--grid", "128", "--margin", "0.25"]
    got = torch_calc_caps.main(args + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["calc_caps.py"] + args)
    calc_caps.main()
    out = capsys.readouterr().out
    assert f"recommended RADAR_BACKBONE_3D.MAX_ACTIVE: {got}" in out
    assert len(got) == 4 and all(c % 512 == 0 and c > 0 for c in got)
