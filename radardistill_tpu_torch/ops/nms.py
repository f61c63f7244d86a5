"""Fixed-capacity rotated NMS.

Counterpart of ``radardistill_tpu/ops/nms.py::class_agnostic_nms``: top
``pre_max`` candidates by score, greedy suppression at BEV IoU above the
threshold, the first ``post_max`` survivors in score order as a fixed-size
index buffer plus a validity mask. Sorting is stable, as ``jax.lax.top_k``
and ``jnp.argsort`` are, so ties resolve to the lower index on both sides.

Its steps run in child spans of the ``decode_and_nms`` stage
(``utils.profiler.span``): ``.topk`` (the candidates by score), ``.iou`` (their
BEV IoU, the polygon clipping of ``ops/geometry.py``) and ``.suppress`` (the
fixed point), in which each round, one host synchronization, is a span
``.round``.
"""

from __future__ import annotations

import torch

from ..utils.profiler import span
from . import geometry


def top_k_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def class_agnostic_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                       nms_thresh: float, pre_max: int, post_max: int,
                       score_thresh: float | None = None):
    """boxes (N, 7+), scores (N,), valid (N,) bool -> (sel_idx (post_max,),
    sel_valid (post_max,))."""
    n = boxes.shape[0]
    k = min(pre_max, n)
    with span("decode_and_nms.topk"):
        neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
        s = torch.where(valid, scores, neg_inf)
        if score_thresh is not None:
            s = torch.where(scores > score_thresh, s, neg_inf)
        top_scores, order = top_k_stable(s, k)
        cand_valid = top_scores > neg_inf
        cand_boxes = boxes[order]

    with span("decode_and_nms.iou"):
        iou = geometry.boxes_iou_bev(cand_boxes[:, :7], cand_boxes[:, :7])
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
