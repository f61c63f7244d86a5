"""The decode's NMS kernels (``csrc/nms_bev.cu``) on the card against the plain
route run on the card (marked ``gpu``; they skip without one).

- The mask kernel's bits equal ``(boxes_iou_bev(c, c) > thresh) & valid_i &
  valid_j`` of every pair, read where the suppression reads it (row i ranks
  above column j, the IoU of j's ring clipped by i), bit for bit: random sets,
  identical boxes, boxes that share edges, turns by 45°, zero-size boxes,
  all-invalid problems, and K from 1 to 4096.
- The dispatcher's ``(sel, sel_valid)`` equal ``nms_plain``'s on the card
  problem by problem, index for index; the dispatcher's counter and each
  kernel's advance by one a call whatever the number of problems.
- A traced decode shows one ``.iou`` and one ``.suppress`` span and no
  ``.round``; a refused launch raises.

The file imports neither JAX nor flax: ``python -m pytest
tests/test_torch_nms_card.py -q -m gpu``.
"""

import numpy as np
import pytest
import torch

from radardistill_tpu_torch.ops import geometry, nms

THRESH = 0.2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    return torch.device("cuda")


def random_boxes(rng, p, k, spread=10.0):
    """(p, k, 7) float32 boxes, as ``tests/test_geometry.py::random_boxes``."""
    boxes = np.zeros((p, k, 7), np.float32)
    boxes[..., 0:2] = rng.uniform(-spread, spread, (p, k, 2))
    boxes[..., 2] = rng.uniform(-2, 2, (p, k))
    boxes[..., 3:6] = rng.uniform(0.5, 5.0, (p, k, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (p, k))
    return boxes


def degenerate(kind, rng, k):
    """(1, k, 7) boxes of one degenerate kind."""
    boxes = random_boxes(rng, 1, k, spread=3.0)
    if kind == "identical":
        boxes[:] = boxes[:, :1]
    elif kind == "shared_edges":  # unit squares on a grid, turned by 0 or 90 degrees
        i = np.arange(k)
        boxes[0, :, 0], boxes[0, :, 1] = i % 8 - 4.0, i // 8 - 4.0
        boxes[0, :, 3:5] = 1.0
        boxes[0, :, 6] = rng.choice([0.0, np.pi / 2, -np.pi / 2, np.pi], k)
    elif kind == "turned_45":  # few centres, each box turned by a multiple of 45 degrees
        boxes[0, :, 0:2] = rng.randint(-2, 3, (k, 2)).astype(np.float32)
        boxes[0, :, 6] = rng.randint(-4, 5, k) * (np.pi / 4)
    elif kind == "zero_size":
        boxes[0, ::3, 3] = 0.0
        boxes[0, 1::3, 4] = 0.0
        boxes[0, 2::5, 3:5] = 0.0
    return boxes


def plain_overlap(boxes, valid):
    """(K, K) bool of the plain route's suppression entries, in the mask's
    orientation: [i, j] for j ranked below i."""
    k = boxes.shape[0]
    iou = torch.cat([geometry.boxes_iou_bev(boxes[r:r + 256], boxes) for r in range(0, k, 256)])
    rank = torch.arange(k, device=boxes.device)
    over = (iou.T > THRESH) & valid[:, None] & valid[None, :]
    return over & (rank[None, :] > rank[:, None])


def mask_bits(mask, k):
    bits = (mask[..., None] >> torch.arange(64, device=mask.device)) & 1
    return bits.reshape(*mask.shape[:-1], -1)[..., :k].bool()


def _check_mask(boxes_np, valid_np, dev):
    boxes = torch.from_numpy(boxes_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    corners = geometry.boxes_to_corners_bev(boxes).contiguous()
    mask = nms.nms_bev_mask(corners, (boxes[..., 3] * boxes[..., 4]).contiguous(), valid, THRESH)
    got = mask_bits(mask, boxes.shape[1])
    for p in range(boxes.shape[0]):
        want = plain_overlap(boxes[p], valid[p])
        if not torch.equal(got[p], want):
            i, j = torch.nonzero(got[p] != want)[0].tolist()
            iou = geometry.boxes_iou_bev(boxes[p, j:j + 1], boxes[p, i:i + 1]).item()
            raise AssertionError(f"problem {p}: {int((got[p] != want).sum())} bits differ, the "
                                 f"first at ({i}, {j}): kernel {bool(got[p, i, j])}, plain IoU "
                                 f"{iou!r}")
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 63, 64, 65, 500, 4096])
def test_mask_bits_equal_plain_iou_on_random_sets(cuda, k):
    rng = np.random.RandomState(k)
    p = 3 if k < 4096 else 1
    spread = 10.0 * max(1.0, (k / 500) ** 0.5)  # about the decode's density at every K
    valid = rng.uniform(size=(p, k)) < 0.9
    got = _check_mask(random_boxes(rng, p, k, spread), valid, cuda)
    if k >= 64:
        assert got.any()  # the sets do overlap


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["identical", "shared_edges", "turned_45", "zero_size"])
def test_mask_bits_equal_plain_iou_on_degenerate_sets(cuda, kind):
    rng = np.random.RandomState(5)
    boxes = degenerate(kind, rng, 65)
    got = _check_mask(boxes, np.ones((1, 65), bool), cuda)
    if kind == "identical":  # every pair overlaps
        assert int(got[0].sum()) == 65 * 64 // 2


@pytest.mark.gpu
def test_mask_of_an_all_invalid_problem_is_empty(cuda):
    rng = np.random.RandomState(6)
    valid = np.ones((3, 130), bool)
    valid[1] = False
    got = _check_mask(random_boxes(rng, 3, 130, spread=4.0), valid, cuda)
    assert not bool(got[1].any()) and bool(got[0].any())


CASES = {  # (problems, candidates, pre_max, post_max, score_thresh, spread)
    "decode_bs1": (6, 500, 1000, 83, None, 12.0),
    "decode_bs4_dense": (24, 500, 1000, 83, None, 5.0),
    "pre_cut_thresh": (5, 700, 500, 83, 0.3, 8.0),
    "post_above_kept": (4, 90, 90, 90, 0.2, 6.0),
    "one_problem": (1, 1024, 1024, 100, 0.1, 15.0),
}



def _launches():
    """(dispatcher calls on the card, mask launches, scan launches)."""
    return (nms.class_agnostic_nms_batched.launches, nms.nms_bev_mask.launches,
            nms.nms_bev_scan.launches)

@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_route_selects_what_the_plain_route_selects(cuda, case):
    p, n, pre_max, post_max, score_thresh, spread = CASES[case]
    rng = np.random.RandomState(len(case))
    boxes = torch.from_numpy(random_boxes(rng, p, n, spread)).to(cuda)
    scores = torch.from_numpy(np.round(rng.uniform(size=(p, n)) * 64) / 64).float().to(cuda)
    valid = torch.from_numpy(rng.uniform(size=(p, n)) < 0.95).to(cuda)
    before = _launches()
    sel, sel_valid = nms.class_agnostic_nms_batched(boxes, scores, valid, THRESH, pre_max,
                                                    post_max, score_thresh)
    torch.cuda.synchronize()
    assert _launches() == tuple(n + 1 for n in before)
    assert sel.shape == sel_valid.shape == (p, min(post_max, pre_max, n))
    for q in range(p):
        want, want_valid = nms.nms_plain(boxes[q], scores[q], valid[q], THRESH, pre_max,
                                         post_max, score_thresh)
        assert torch.equal(sel_valid[q], want_valid), (case, q)
        assert torch.equal(sel[q], want), (case, q)
    assert bool(sel_valid.any())
    if case in ("decode_bs4_dense", "post_above_kept"):  # slots left empty
        assert not bool(sel_valid.all())


@pytest.mark.gpu
def test_traced_decode_runs_one_mask_and_one_scan(cuda):
    from torch.profiler import ProfilerActivity, profile

    from radardistill_tpu_torch.models.center_head import HeadSpec, decode_and_nms

    spec = HeadSpec([["car"], ["truck", "bus"]], ["car", "truck", "bus"])
    rng = np.random.RandomState(9)
    b, hw = 2, (40, 40)
    chans = {"hm": 2, "center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2, "iou": 1}
    preds = {key: torch.from_numpy(rng.randn(b, *hw, 2, c).astype(np.float32)).to(cuda)
             for key, c in chans.items()}
    preds["dim"] *= 0.3

    def decode():
        return decode_and_nms(preds, spec, hw, 8, (0.2, 0.2, 8.0), (-32.0, -32.0, -5.0, 32, 32, 3),
                              [-61.2, -61.2, -10.0, 61.2, 61.2, 10.0], k_per_head=200)

    decode()
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = decode()
    torch.cuda.synchronize()
    names = [e.name for e in prof.events() if getattr(e, "is_user_annotation", False)]
    assert names.count("decode_and_nms.iou") == names.count("decode_and_nms.suppress") == 1
    assert "decode_and_nms.round" not in names
    assert _launches() == tuple(n + 1 for n in before)
    assert out["boxes"].shape == (b, 2 * 83, 9) and bool(out["valid"].any())


@pytest.mark.gpu
def test_refused_launch_and_wrong_inputs_raise(cuda):
    corners = torch.zeros((70000, 1, 4, 2), device=cuda)
    areas, valid = torch.zeros((70000, 1), device=cuda), torch.ones((70000, 1), dtype=torch.bool,
                                                                      device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):  # more problems than a grid's z
        nms.nms_bev_mask(corners, areas, valid, THRESH)
    with pytest.raises(TypeError):
        nms.nms_bev_mask(corners[:4].double(), areas[:4], valid[:4], THRESH)
    with pytest.raises(ValueError):
        nms.nms_bev_mask(corners[:4, :, :3], areas[:4], valid[:4], THRESH)
    with pytest.raises(TypeError):
        nms.class_agnostic_nms_batched(torch.zeros((1, 4, 7), dtype=torch.float64, device=cuda),
                                       areas[:1, :1].expand(1, 4), valid[:1, :1].expand(1, 4),
                                       THRESH, 4, 4)
