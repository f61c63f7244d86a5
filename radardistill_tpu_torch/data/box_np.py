"""Host-side (numpy) box/point geometry for the data pipeline.

Counterpart of pcdet/utils/box_utils.py (:117 remove_points_in_boxes3d,
:187 enlarge_box3d, corner helpers) and the CPU paths of
pcdet/ops/roiaware_pool3d (points-in-box membership). Pure numpy — this runs
in dataloader workers, not on the card.

The port's copy of ``radardistill_tpu/data/box_np.py``, line for line;
its BEV IoU goes through the port's own ``host_ops``.
"""

from __future__ import annotations

import numpy as np


def rotate_points_along_z(points: np.ndarray, angle: float) -> np.ndarray:
    """(N, 3+) points rotated by angle around +z (xy columns only)."""
    c, s = np.cos(angle), np.sin(angle)
    out = points.copy()
    out[:, 0] = points[:, 0] * c - points[:, 1] * s
    out[:, 1] = points[:, 0] * s + points[:, 1] * c
    return out


def boxes_to_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4, 2) BEV corners."""
    tmpl = np.array([[0.5, -0.5], [0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5]])
    lx = tmpl[None, :, 0] * boxes[:, None, 3]
    ly = tmpl[None, :, 1] * boxes[:, None, 4]
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    cx = lx * c - ly * s + boxes[:, None, 0]
    cy = lx * s + ly * c + boxes[:, None, 1]
    return np.stack([cx, cy], -1)


def points_in_boxes(points_xyz: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3) x (M, 7) -> (N, M) bool."""
    if len(boxes) == 0 or len(points_xyz) == 0:
        return np.zeros((len(points_xyz), len(boxes)), bool)
    shift = points_xyz[:, None, :3] - boxes[None, :, :3]
    c = np.cos(-boxes[:, 6])
    s = np.sin(-boxes[:, 6])
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    return (
        (np.abs(lx) < boxes[None, :, 3] / 2)
        & (np.abs(ly) < boxes[None, :, 4] / 2)
        & (np.abs(shift[..., 2]) < boxes[None, :, 5] / 2)
    )


def enlarge_box3d(boxes: np.ndarray, extra_width=(0, 0, 0)) -> np.ndarray:
    out = boxes.copy()
    out[:, 3:6] += 2 * np.asarray(extra_width)
    return out


def remove_points_in_boxes3d(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return points
    inside = points_in_boxes(points[:, :3], boxes[:, :7]).any(axis=1)
    return points[~inside]


def mask_boxes_outside_range(boxes: np.ndarray, limit_range, min_num_corners=1) -> np.ndarray:
    """Keep boxes with >= min_num_corners BEV corners inside range
    (box_utils.mask_boxes_outside_range_numpy semantics)."""
    if len(boxes) == 0:
        return np.zeros(0, bool)
    corners = boxes_to_corners_bev(boxes[:, :7])  # (N, 4, 2)
    inside = (
        (corners[..., 0] >= limit_range[0]) & (corners[..., 0] <= limit_range[3])
        & (corners[..., 1] >= limit_range[1]) & (corners[..., 1] <= limit_range[4])
    )
    return inside.sum(axis=1) >= min_num_corners


def boxes_iou_bev_cpu(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Rotated BEV IoU matrix on host — replaces iou3d_nms_cuda.boxes_iou_bev_cpu
    for the GT-sampler collision test (database_sampler_distill.py:246-250).
    Uses the C++ host op (csrc/host_ops.cpp)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    from . import host_ops

    return host_ops.boxes_iou_bev(boxes_a, boxes_b)
