"""The port's NMS dispatcher (``radardistill_tpu_torch/ops/nms.py``) and the
batched decode around it, on the CPU, against the JAX package.

``class_agnostic_nms_batched`` takes P problems at once; on the CPU each goes
through ``nms_plain`` (the dense IoU and the suppression's fixed point), and
each must equal the JAX ``class_agnostic_nms`` of that problem index for
index: 1 to 12 problems, random validity, scores with ties, a score
threshold, ``post_max`` below and above the number kept. ``decode_and_nms``
makes one such call for every (sample, head); its dict must equal the JAX
decode's at batch 3 with a head that pads its classes. The kernels' own
tests are in ``tests/test_torch_nms_card.py`` (on a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.models import center_head as jch
from radardistill_tpu.ops import nms as jnms
from radardistill_tpu_torch.models import center_head as tch
from radardistill_tpu_torch.ops import geometry, nms
from radardistill_tpu_torch.utils.profiler import cost_analysis
from tests.test_geometry import random_boxes

torch.set_num_threads(1)

CASES = {  # problems, candidates, pre_max, post_max, score_thresh, spread, score levels
    "one": (1, 60, 60, 30, None, 6.0, 0),
    "two_ties": (2, 50, 50, 50, 0.3, 4.0, 8),
    "five_pre_cut": (5, 70, 40, 83, None, 5.0, 16),
    "twelve_thresh": (12, 40, 40, 10, 0.2, 3.0, 0),
    "twelve_ties_sparse": (12, 45, 45, 45, None, 20.0, 4),
}


def _problems(p, n, spread, levels, seed):
    rng = np.random.RandomState(seed)
    boxes = np.stack([random_boxes(n, seed=seed * 100 + q, spread=spread) for q in range(p)])
    scores = rng.uniform(0, 1, (p, n)).astype(np.float32)
    if levels:
        scores = np.round(scores * levels) / levels  # ties
    valid = rng.uniform(size=(p, n)) < 0.85
    return boxes, scores, valid


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_plain_route_equals_each_problem_and_jax(case):
    p, n, pre_max, post_max, score_thresh, spread, levels = CASES[case]
    boxes, scores, valid = _problems(p, n, spread, levels, seed=len(case))
    sel, sel_valid = nms.class_agnostic_nms_batched(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.2,
        pre_max, post_max, score_thresh)
    m = min(post_max, pre_max, n)
    assert sel.shape == sel_valid.shape == (p, m) and sel.dtype == torch.int64
    kept = []
    for q in range(p):
        one = nms.nms_plain(torch.from_numpy(boxes[q]), torch.from_numpy(scores[q]),
                            torch.from_numpy(valid[q]), 0.2, pre_max, post_max, score_thresh)
        assert torch.equal(sel[q], one[0]) and torch.equal(sel_valid[q], one[1])
        j_sel, j_valid = jnms.class_agnostic_nms(
            jnp.asarray(boxes[q]), jnp.asarray(scores[q]), jnp.asarray(valid[q]), 0.2, pre_max,
            post_max, score_thresh)
        np.testing.assert_array_equal(sel_valid[q].numpy(), np.asarray(j_valid))
        np.testing.assert_array_equal(sel[q].numpy(), np.asarray(j_sel))
        kept.append(int(sel_valid[q].sum()))
    assert max(kept) > 0
    if post_max >= pre_max:  # room for every survivor: suppression leaves slots empty
        assert min(kept) < m


def test_one_problem_call_is_the_batched_call_of_one():
    """A problem called alone selects what it selects among others (the
    anchor detector's samples share one call)."""
    boxes, scores, valid = [torch.from_numpy(a) for a in _problems(3, 60, 5.0, 8, seed=3)]
    args = (0.2, 60, 40, 0.1)
    batched = nms.class_agnostic_nms_batched(boxes, scores, valid, *args)
    for q in range(3):
        one = nms.class_agnostic_nms_batched(boxes[q:q + 1], scores[q:q + 1], valid[q:q + 1],
                                             *args)
        assert torch.equal(one[0][0], batched[0][q]) and torch.equal(one[1][0], batched[1][q])


def test_dispatcher_refuses_a_device_it_has_no_route_for():
    boxes = torch.zeros((2, 8, 7), device="meta")
    with pytest.raises(ValueError):
        nms.class_agnostic_nms_batched(boxes, torch.zeros((2, 8), device="meta"),
                                       torch.ones((2, 8), dtype=torch.bool, device="meta"),
                                       0.2, 8, 8)


def test_count_reports_the_kernels_work_on_either_route():
    """Inside a count the dispatcher adds ``nms_bev_work`` (the kernels'
    upper-triangle pairs and bytes) once a call, whatever the problems."""
    boxes, scores, valid = _problems(4, 50, 5.0, 0, seed=4)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid), 0.2,
            40, 20)
    ca = cost_analysis(nms.class_agnostic_nms_batched, *args)
    flops, nbytes = nms.nms_bev_work(*args)
    assert ca["kernels"] == {"nms_bev": 1}
    assert (ca["flops"], ca["bytes_accessed"]) == (flops, nbytes)
    assert flops == 4 * (40 * 39 // 2) * nms.PAIR_FLOPS


def test_corners_without_a_host_template_equal_the_template_products():
    """``boxes_to_corners_bev`` builds its (±0.5, ±0.5) template from the
    sizes where the boxes are; halving and negating are exact, so every
    corner equals the template tensor's product bit for bit."""
    boxes = torch.from_numpy(random_boxes(300, seed=8, spread=50.0))
    boxes[::7, 3] = 0.0
    boxes[::5, 4] = 1e-30
    tmpl = torch.tensor([[0.5, -0.5], [0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5]])
    lx, ly = tmpl[:, 0] * boxes[:, 3, None], tmpl[:, 1] * boxes[:, 4, None]
    cos_a, sin_a = torch.cos(boxes[:, 6, None]), torch.sin(boxes[:, 6, None])
    want = torch.stack([lx * cos_a - ly * sin_a + boxes[:, 0, None],
                        lx * sin_a + ly * cos_a + boxes[:, 1, None]], dim=-1)
    assert torch.equal(geometry.boxes_to_corners_bev(boxes), want)


CLASS_NAMES = ["car", "truck", "bus", "barrier"]
HEADS = [["car"], ["truck", "bus"], ["barrier"]]


def test_batched_decode_equals_jax_at_batch_3():
    rng = np.random.RandomState(11)
    b, hw, n_heads = 3, (24, 24), len(HEADS)
    chans = {"hm": 2, "center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2, "iou": 1}
    preds = {k: rng.randn(b, *hw, n_heads, c).astype(np.float32) for k, c in chans.items()}
    preds["dim"] = preds["dim"] * 0.3 + 1.0  # about 2.7 m: neighbours overlap
    preds["center"] = rng.rand(b, *hw, n_heads, 2).astype(np.float32)
    kw = dict(feature_map_stride=4, voxel_size=(0.4, 0.4, 8.0),
              point_cloud_range=(-19.2, -19.2, -5.0, 19.2, 19.2, 3.0),
              post_center_limit_range=[-15.0, -61.2, -10.0, 61.2, 15.0, 10.0],
              k_per_head=80, score_thresh=0.2, rectifier=0.5, nms_thresh=0.2, nms_pre=60,
              nms_post=60)
    got = tch.decode_and_nms({k: torch.from_numpy(v) for k, v in preds.items()},
                             tch.HeadSpec(HEADS, CLASS_NAMES), hw, **kw)
    want = jch.decode_and_nms({k: jnp.asarray(v) for k, v in preds.items()},
                              jch.HeadSpec(HEADS, CLASS_NAMES), hw, **kw)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "boxes": (b, 3 * 60, 9), "scores": (b, 180), "labels": (b, 180), "valid": (b, 180)}
    assert (got["labels"].dtype, got["valid"].dtype) == (torch.int32, torch.bool)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    v = got["valid"].numpy()
    assert 0 < v.sum() < v.size
    np.testing.assert_array_equal(got["labels"].numpy()[v], np.asarray(want["labels"])[v])
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy()[v], np.asarray(want["scores"])[v],
                               rtol=1e-5, atol=1e-6)
