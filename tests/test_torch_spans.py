"""The port's profiler spans (``utils/profiler.py``) on the CPU, grid 128.

A distillation train step of ``radar_distill_train.yaml`` (tables built on the
device: no host precompute) under ``torch.profiler`` emits every span the
benchmark's per-layer metrics read, each child ``<parent>.<step>`` inside its
parent, and one ``<stage>.backward`` span a trained stage, which tile the
backward on one thread in the order the gradient reaches the stages. With no
profiler running, a span is a shared null context and the forward hooks
nothing; with one, the hooks leave the autograd graph as it is. The eval
forward's ``decode_and_nms.round`` spans count the NMS fixed point's rounds,
each one ``torch.equal`` (a host synchronization), counted here by wrapping
``torch.equal``. Under
``MODEL.REMAT`` the recomputed forward hooks nothing and the spans stay
nested; a trained teacher's stages (``FREEZE_PIPELINE: []``) get their
backward spans after the student's.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radardistill_tpu_torch.data.synthetic import make_batch
from radardistill_tpu_torch.models import build_network, compute_training_loss
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import make_eval_step, make_train_step
from radardistill_tpu_torch.utils import profiler
from radardistill_tpu_torch.utils.production import TRAIN_YAML, VAL_YAML, production_cfg

torch.set_num_threads(1)

GRID = 128
# the order in which the gradient reaches the student's stages
BACKWARD = ("losses.backward", "radar_dense_head.backward", "radar_neck.backward",
            "radar_cma.backward", "radar_backbone_3d.backward", "radar_vfe.backward")
FORWARD = ("h2d", "vfe", "vfe.tables", "backbone_3d", "backbone_3d.tables", "backbone_2d",
           "radar_vfe", "radar_vfe.tables", "radar_backbone_3d", "radar_backbone_3d.tables",
           "radar_backbone_3d.sparse", "radar_backbone_3d.dense", "radar_cma", "radar_neck",
           "radar_dense_head", "assign_targets", "losses", "losses.head", "losses.distill",
           "backward", "optimizer")
DECODE = ("decode_and_nms.topk", "decode_and_nms.boxes", "decode_and_nms.iou",
          "decode_and_nms.suppress", "decode_and_nms.round")


def _spans(prof):
    """[(name, start, end, thread)] of the trace's user annotations, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                   for e in prof.events() if getattr(e, "is_user_annotation", False)),
                  key=lambda s: s[1])


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _train_setup(remat=False, frozen=True):
    cfg, info, batch = make_batch(TRAIN_YAML, grid=GRID, host_precompute=False,
                                  num_lidar=2000, num_radar=200, num_boxes=5)
    if not frozen:
        cfg.FREEZE_PIPELINE = []
    full, _ = production_cfg(TRAIN_YAML, grid=GRID)
    model = build_network(cfg, info, device="cpu", remat=remat,
                          generator=torch.Generator().manual_seed(0))
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 100, model.frozen)
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])
    return cfg, geo, model, make_train_step(model, opt, cfg, *geo), batch


def _traced_step(remat=False, frozen=True):
    _, _, _, step, batch = _train_setup(remat, frozen)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch_to_torch(batch, "cpu"))
    assert not profiler._open_backward  # the pass's end closed its last span
    return _spans(prof)


@pytest.fixture(scope="module")
def train_spans():
    return _traced_step()


def test_train_step_emits_every_span_inside_its_parent(train_spans):
    by_name = {}
    for s in train_spans:
        by_name.setdefault(s[0], []).append(s)
    for name in FORWARD + BACKWARD:
        assert len(by_name.get(name, ())) == 1, name
    for name, spans in by_name.items():
        parent = name.rsplit(".", 1)[0]
        if name.endswith(".backward"):
            parent = "backward"  # the stage's forward span has closed long before
        elif parent == name or parent.startswith("Optimizer"):
            continue
        (p,) = by_name[parent]
        assert all(_inside(s, p) for s in spans), name


def test_backward_spans_tile_the_backward_on_one_thread(train_spans):
    bwd = [s for s in train_spans if s[0].endswith(".backward")]
    assert [s[0] for s in bwd] == list(BACKWARD)
    assert len({s[3] for s in bwd}) == 1
    for a, b in zip(bwd, bwd[1:]):
        assert a[2] <= b[1]  # no overlap
    (whole,) = [s for s in train_spans if s[0] == "backward"]
    assert whole[1] <= bwd[0][1] and bwd[-1][2] <= whole[2]


def _graph_nodes(loss):
    """The autograd graph's nodes that ``loss`` reaches, by type name."""
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [f for f, _ in fn.next_functions]
    return sorted(type(fn).__name__ for fn in seen)


def test_without_a_profiler_no_mark_and_a_shared_null_span(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiler.span("vfe"), profiler.span("radar_cma.backward")
    assert first is second
    with first as entered:
        assert entered is None
    hooks = []
    register = profiler.register_multi_grad_hook

    def counted(tensors, fn, **kwargs):
        hooks.append(len(tensors))
        return register(tensors, fn, **kwargs)

    monkeypatch.setattr(profiler, "register_multi_grad_hook", counted)
    cfg, geo, model, _, batch = _train_setup()
    model.train()
    b = batch_to_torch(batch, "cpu")
    loss, _ = compute_training_loss(cfg, model(b), *geo)
    assert not hooks
    untraced = _graph_nodes(loss)
    with profile(activities=[ProfilerActivity.CPU]):
        loss, _ = compute_training_loss(cfg, model(b), *geo)
        # the control: a traced forward hooks each trained stage and the
        # loss, and leaves the graph as it is
        assert len(hooks) == len(BACKWARD)
        assert _graph_nodes(loss) == untraced
        loss.backward()


def test_nms_rounds_count_the_fixed_point_iterations(monkeypatch):
    cfg, info, batch = make_batch(VAL_YAML, grid=GRID, num_radar=300, num_boxes=8,
                                  batch_size=2)
    cfg.RADAR_DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE = 50
    model = build_network(cfg, info, device="cpu", generator=torch.Generator().manual_seed(0))
    eval_step = make_eval_step(model)
    b = batch_to_torch(batch, "cpu")
    eval_step(b)
    equal, calls = torch.equal, []

    def counted(a, c):
        calls.append(1)
        return equal(a, c)

    monkeypatch.setattr(torch, "equal", counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eval_step(b)
    spans = _spans(prof)
    rounds = [s for s in spans if s[0] == "decode_and_nms.round"]
    heads = len(cfg.RADAR_DENSE_HEAD.CLASS_NAMES_EACH_HEAD)
    assert len(rounds) == len(calls) >= heads * 2  # one round at least a head and sample
    (parent,) = [s for s in spans if s[0] == "decode_and_nms"]
    for name in DECODE:
        assert any(s[0] == name for s in spans), name
        assert all(_inside(s, parent) for s in spans if s[0] == name), name
    suppress = [s for s in spans if s[0] == "decode_and_nms.suppress"]
    assert len(suppress) == heads * 2
    assert all(any(_inside(r, s) for s in suppress) for r in rounds)


def test_spans_stay_nested_under_remat_with_a_trained_teacher():
    spans = _traced_step(remat=True, frozen=False)
    bwd = [s for s in spans if s[0].endswith(".backward")]
    # the recompute hooks nothing; the teacher's stages, created first, come last
    teacher = ("backbone_2d.backward", "backbone_3d.backward", "vfe.backward")
    assert [s[0] for s in bwd] == list(BACKWARD + teacher)
    assert len({s[3] for s in bwd}) == 1
    # every two spans of a thread are disjoint or nested
    for i, a in enumerate(spans):
        for b in spans[i + 1:]:
            if a[3] == b[3] and b[1] < a[2]:
                assert b[2] <= a[2], (a, b)
    # the recomputed backbone's child spans lie inside its backward
    (bb,) = [s for s in bwd if s[0] == "radar_backbone_3d.backward"]
    again = [s for s in spans if s[0].startswith("radar_backbone_3d.") and _inside(s, bb)
             and s[0] != bb[0]]
    assert {s[0] for s in again} >= {"radar_backbone_3d.sparse", "radar_backbone_3d.dense"}
