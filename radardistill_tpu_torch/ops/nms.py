"""Fixed-capacity rotated NMS.

Counterpart of ``radardistill_tpu/ops/nms.py::class_agnostic_nms``: top
``pre_max`` candidates by score, greedy suppression at BEV IoU above the
threshold, the first ``post_max`` survivors in score order as a fixed-size
index buffer plus a validity mask. Sorting is stable, as ``jax.lax.top_k``
and ``jnp.argsort`` are, so ties resolve to the lower index on both sides.

``class_agnostic_nms_batched`` takes P independent problems at once (the
decode's samples times heads). A CPU tensor takes the plain route, one
problem at a time (``nms_plain``: the dense IoU of ``ops/geometry.py`` and
the fixed point of the suppression, one host synchronization a round). A
CUDA tensor takes the kernels of ``csrc/nms_bev.cu`` (``nms_bev_mask``, the
overlap bitmask of every problem, then ``nms_bev_scan``, the greedy scan of
each): the same keep set, with no host round trip, or the call raises.

The steps run in child spans of the ``decode_and_nms`` stage
(``utils.profiler.span``): ``.topk`` (the candidates by score), ``.iou`` (their
BEV IoU: the polygon clipping, or the mask kernel with its corners) and
``.suppress`` (the fixed point, in which each round, one host
synchronization, is a span ``.round``; or the scan kernel).
"""

from __future__ import annotations

import torch

from ..utils import profiler
from ..utils.profiler import span
from . import cuda_lib, geometry

TILE = 64  # ranks a mask word (csrc/nms_bev.cu)
# float32 operations of one pair in the mask kernel in the worst case: rings
# that grow by a vertex a clip (4, 5, 6, 7: 13 a vertex and 2 an edge), the
# area of 8 vertices (33) and the ratio (5). A pair whose ring clips to
# nothing stops after the first clip that empties it, at some 25 operations,
# and most of the decode's pairs lie far apart, so this is an upper bound on
# the work, not the work
PAIR_FLOPS = 13 * (4 + 5 + 6 + 7) + 4 * 2 + 33 + 5


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ranked(boxes, scores, valid, k, score_thresh):
    """(order (..., k), cand_valid (..., k), cand_boxes (..., k, 7)): the top k
    candidates by score, those masked out last and invalid."""
    s = scores.masked_fill(~valid, float("-inf"))
    if score_thresh is not None:
        s = s.masked_fill(~(scores > score_thresh), float("-inf"))
    top_scores, order = top_k_stable(s, k)
    cand = torch.gather(boxes[..., :7], -2, order[..., None].expand(*order.shape, 7))
    return order, top_scores > float("-inf"), cand


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              nms_thresh: float, pre_max: int, post_max: int,
              score_thresh: float | None = None):
    """One problem on any device: boxes (N, 7+), scores (N,), valid (N,) bool
    -> (sel_idx (M,), sel_valid (M,)), M = min(post_max, pre_max, N)."""
    k = min(pre_max, boxes.shape[0])
    with span("decode_and_nms.topk"):
        order, cand_valid, cand_boxes = _ranked(boxes, scores, valid, k, score_thresh)

    with span("decode_and_nms.iou"):
        iou = geometry.boxes_iou_bev(cand_boxes, cand_boxes)
        overlaps = (iou > nms_thresh) & cand_valid[None, :] & cand_valid[:, None]
        rank = torch.arange(k, device=boxes.device)
        sup = (overlaps & (rank[:, None] > rank[None, :])).to(torch.float32)

    with span("decode_and_nms.suppress"):
        # greedy keep-set as the fixed point of
        #   alive[i] <- valid[i] & no alive higher-ranked box overlaps i
        alive = cand_valid
        while True:
            with span("decode_and_nms.round"):
                new_alive = cand_valid & ~((sup @ alive.to(torch.float32)) > 0)
                if torch.equal(new_alive, alive):
                    break
                alive = new_alive
        ranked = torch.where(alive, rank, k)
        perm = torch.argsort(ranked, stable=True)[:post_max]
        return order[perm], alive[perm]


def nms_bev_work(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                 nms_thresh: float, pre_max: int, post_max: int,
                 score_thresh: float | None = None):
    """(flops, bytes) of one card call: ``PAIR_FLOPS`` for each pair above the
    diagonal of each problem (the worst case: an upper bound on the work); the corners, areas and validity read, the mask
    written and read back, the sort's indices read and the selection
    written (PERF.md's bound of the two kernels)."""
    p, n = scores.shape
    k = min(pre_max, n)
    m, w = min(post_max, k), -(-k // TILE)
    pairs = p * k * (k - 1) // 2
    return pairs * PAIR_FLOPS, p * k * (8 * 4 + 4 + 1 + 8) + 2 * p * k * w * 8 + p * m * (8 + 1)


def _check(name, *args):
    """Raise unless each (tensor, dtype, shape) is contiguous on the card of
    the first, with that dtype and shape."""
    dev = args[0][0].device
    for t, dtype, shape in args:
        if t.device != dev or dev.type != "cuda" or t.dtype != dtype:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected {dtype} on a card")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}, contiguous")


def nms_bev_mask(corners: torch.Tensor, areas: torch.Tensor, cand_valid: torch.Tensor,
                 nms_thresh: float) -> torch.Tensor:
    """The mask kernel alone: corners (P, K, 4, 2) float32, areas (P, K)
    float32, cand_valid (P, K) bool, all contiguous on one card -> mask
    (P, K, ceil(K / 64)) int64, bit b of word w of row i set when rank
    64 w + b > i overlaps rank i (both valid, IoU above ``nms_thresh``)."""
    p, k = areas.shape
    _check("nms_bev_mask", (areas, torch.float32, (p, k)),
           (corners, torch.float32, (p, k, 4, 2)), (cand_valid, torch.bool, (p, k)))
    mask = torch.empty((p, k, -(-k // TILE)), dtype=torch.int64, device=areas.device)
    rc = cuda_lib.lib().rdt_nms_bev_mask(
        corners.data_ptr(), areas.data_ptr(), cand_valid.data_ptr(), p, k, nms_thresh,
        mask.data_ptr(), areas.device.index, cuda_lib.stream_of(areas))
    cuda_lib.check(rc, "nms_bev_mask")
    nms_bev_mask.launches += 1
    return mask


nms_bev_mask.launches = 0


def nms_bev_scan(mask: torch.Tensor, cand_valid: torch.Tensor, order: torch.Tensor,
                 post_max: int):
    """The scan kernel alone: ``nms_bev_mask``'s mask, cand_valid (P, K)
    bool, order (P, K) int64 -> (order[kept ranks, then the others][:M],
    kept) of shape (P, M), M = min(post_max, K)."""
    p, k = cand_valid.shape
    _check("nms_bev_scan", (cand_valid, torch.bool, (p, k)), (order, torch.int64, (p, k)),
           (mask, torch.int64, (p, k, -(-k // TILE))))
    m = min(post_max, k)
    sel = torch.empty((p, m), dtype=torch.int64, device=order.device)
    sel_valid = torch.empty((p, m), dtype=torch.bool, device=order.device)
    rc = cuda_lib.lib().rdt_nms_bev_scan(
        mask.data_ptr(), cand_valid.data_ptr(), order.data_ptr(), p, k, m, sel.data_ptr(),
        sel_valid.data_ptr(), order.device.index, cuda_lib.stream_of(order))
    cuda_lib.check(rc, "nms_bev_scan")
    nms_bev_scan.launches += 1
    return sel, sel_valid


nms_bev_scan.launches = 0


@profiler.counted("nms_bev", nms_bev_work)
def class_agnostic_nms_batched(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                               nms_thresh: float, pre_max: int, post_max: int,
                               score_thresh: float | None = None):
    """boxes (P, N, 7+), scores (P, N), valid (P, N) bool -> (sel_idx (P, M)
    int64, sel_valid (P, M) bool), M = min(post_max, pre_max, N): each
    problem as ``nms_plain`` gives it."""
    if boxes.device.type == "cpu":
        sels = [nms_plain(b, s, v, nms_thresh, pre_max, post_max, score_thresh)
                for b, s, v in zip(boxes, scores, valid)]
        return torch.stack([i for i, _ in sels]), torch.stack([v for _, v in sels])
    if boxes.device.type != "cuda" or {scores.device, valid.device} != {boxes.device}:
        raise ValueError(f"class_agnostic_nms_batched: boxes on {boxes.device}, scores on "
                         f"{scores.device}, valid on {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"class_agnostic_nms_batched: boxes {boxes.dtype}, valid {valid.dtype}")
    k = min(pre_max, boxes.shape[1])
    with span("decode_and_nms.topk"):
        order, cand_valid, cand = _ranked(boxes, scores, valid, k, score_thresh)
        order = order.contiguous()
    with span("decode_and_nms.iou"):
        corners = geometry.boxes_to_corners_bev(cand).contiguous()
        mask = nms_bev_mask(corners, (cand[..., 3] * cand[..., 4]).contiguous(), cand_valid,
                            nms_thresh)
    with span("decode_and_nms.suppress"):
        out = nms_bev_scan(mask, cand_valid, order, post_max)
    class_agnostic_nms_batched.launches += 1
    return out


class_agnostic_nms_batched.launches = 0  # calls on the card: one launch of each kernel

