"""Box geometry: rotated BEV overlap and IoU (decode), 3D IoU (the matrix
and the aligned one), corners and point membership, the axis-aligned DIoU
and GIoU and the gaussian radius (losses and targets).

Counterpart of ``radardistill_tpu/ops/geometry.py``, every public function
of it. Boxes are ``[x, y, z, dx, dy, dz, heading, ...]``. The
intersection clips one box by the other's four half-planes on a fixed
8-vertex ring (Sutherland-Hodgman), branch-free over any batch shape.
"""

from __future__ import annotations

import torch

_MAX_VERTS = 8  # a 4-gon clipped by 4 half-planes has at most 8 vertices


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 4, 2) BEV corners, counter-clockwise."""
    x, y = boxes[..., 0], boxes[..., 1]
    cos_a, sin_a = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    # the template (±0.5, ±0.5) times the sizes, built where the boxes are (a
    # template tensor from the host would be a synchronizing copy); halving
    # and negating are exact, so the values are the template products'
    hx, hy = 0.5 * boxes[..., 3], 0.5 * boxes[..., 4]
    lx = torch.stack([hx, hx, -hx, -hx], dim=-1)
    ly = torch.stack([-hy, hy, hy, -hy], dim=-1)
    cx = lx * cos_a[..., None] - ly * sin_a[..., None] + x[..., None]
    cy = lx * sin_a[..., None] + ly * cos_a[..., None] + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def boxes_to_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) boxes -> (..., 8, 3) 3D corners, the bottom four then the top
    four, each in the BEV corners' order."""
    bev = boxes_to_corners_bev(boxes)
    z, dz = boxes[..., 2], boxes[..., 5]
    shape = bev[..., :1].shape
    bot = torch.cat([bev, (z - dz / 2)[..., None, None].expand(shape)], dim=-1)
    top = torch.cat([bev, (z + dz / 2)[..., None, None].expand(shape)], dim=-1)
    return torch.cat([bot, top], dim=-2)


def points_in_boxes(points_xyz: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(N, 3) points x (M, 7) boxes -> (N, M) bool: each point turned into
    each box's frame and tested against its half sizes, strictly inside (the
    reference's ``points_in_boxes_gpu``; ``data/box_np.py`` keeps the host
    form)."""
    shift = points_xyz[:, None, :] - boxes[None, :, :3]
    cos_a, sin_a = torch.cos(-boxes[:, 6]), torch.sin(-boxes[:, 6])
    local_x = shift[..., 0] * cos_a - shift[..., 1] * sin_a
    local_y = shift[..., 0] * sin_a + shift[..., 1] * cos_a
    in_x = torch.abs(local_x) < boxes[None, :, 3] / 2
    in_y = torch.abs(local_y) < boxes[None, :, 4] / 2
    in_z = torch.abs(shift[..., 2]) < boxes[None, :, 5] / 2
    return in_x & in_y & in_z


def _polygon_area(verts: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first ``n_valid`` vertices of an 8-slot ring."""
    idx = torch.arange(_MAX_VERTS, device=verts.device)
    nxt = (idx + 1) % _MAX_VERTS
    valid = idx < n_valid[..., None]
    is_last = idx == (n_valid[..., None] - 1)
    x, y = verts[..., 0], verts[..., 1]
    x_n = torch.where(is_last, x[..., 0:1], x[..., nxt])
    y_n = torch.where(is_last, y[..., 0:1], y[..., nxt])
    cross = x * y_n - x_n * y
    return 0.5 * torch.abs(torch.sum(torch.where(valid, cross, 0.0), dim=-1))


def _clip_halfplane_batched(verts, n_valid, p0, p1):
    """One Sutherland-Hodgman step: keep the part of each ring left of the
    directed edge p0 -> p1. verts (..., 8, 2); n_valid (...,); p0/p1 (..., 2)."""
    ex = (p1 - p0)[..., None, :]
    d = ex[..., 0] * (verts[..., 1] - p0[..., None, 1]) - ex[..., 1] * (
        verts[..., 0] - p0[..., None, 0])
    idx = torch.arange(_MAX_VERTS, device=verts.device)
    is_last = idx == (n_valid[..., None] - 1)
    nxt_d = torch.where(is_last, d[..., 0:1], torch.roll(d, -1, dims=-1))
    nxt_v = torch.where(is_last[..., None], verts[..., 0:1, :], torch.roll(verts, -1, dims=-2))
    valid = idx < n_valid[..., None]

    inside = d >= 0
    nxt_inside = nxt_d >= 0
    denom = d - nxt_d
    t = d / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    inter = verts + t[..., None] * (nxt_v - verts)

    emit_v = inside & valid
    emit_i = (inside != nxt_inside) & valid
    lead = verts.shape[:-2]
    out_pts = torch.stack([verts, inter], dim=-2).reshape(*lead, 16, 2)
    out_keep = torch.stack([emit_v, emit_i], dim=-1).reshape(*lead, 16)
    # stable compaction: kept candidate j lands in slot (kept before j); the
    # rest go to a dump slot that is cut off
    pos = torch.cumsum(out_keep.to(torch.int32), dim=-1) - 1
    dst = torch.where(out_keep & (pos < _MAX_VERTS), pos, _MAX_VERTS).long()
    out = verts.new_zeros((*lead, _MAX_VERTS + 1, 2))
    out.scatter_(-2, dst[..., None].expand(*lead, 16, 2), out_pts)
    n_out = torch.clamp(out_keep.sum(dim=-1), max=_MAX_VERTS).to(torch.int32)
    return out[..., :_MAX_VERTS, :], n_out


def _intersection_area_batched(corners_a, corners_b):
    """(..., 4, 2) x (..., 4, 2) CCW quads -> (...,) intersection areas."""
    batch = corners_a.shape[:-2]
    verts = torch.cat([corners_a, corners_a.new_zeros((*batch, 4, 2))], dim=-2)
    n = torch.full(batch, 4, dtype=torch.int32, device=corners_a.device)
    for e in range(4):
        verts, n = _clip_halfplane_batched(
            verts, n, corners_b[..., e, :], corners_b[..., (e + 1) % 4, :])
    return torch.where(n >= 3, _polygon_area(verts, n), 0.0)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV intersection areas."""
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    n, m = ca.shape[0], cb.shape[0]
    return _intersection_area_batched(ca[:, None].expand(n, m, 4, 2),
                                      cb[None, :].expand(n, m, 4, 2))


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU matrix (N, M)."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def _height_overlap(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) overlap of the boxes' z extents, at least 0."""
    a_max = (boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None]
    a_min = (boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None]
    b_max = (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :]
    b_min = (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :]
    return torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU matrix (N, M): the BEV overlap times the height overlap
    over the union of the volumes."""
    overlaps_3d = boxes_overlap_bev(boxes_a, boxes_b) * _height_overlap(boxes_a, boxes_b)
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return overlaps_3d / torch.clamp(vol_a + vol_b - overlaps_3d, min=1e-6)


def boxes_overlap_bev_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (N, 7) -> (N,) pairwise rotated BEV intersection areas."""
    return _intersection_area_batched(boxes_to_corners_bev(boxes_a), boxes_to_corners_bev(boxes_b))


def boxes_aligned_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (N, 7) -> (N,) elementwise 3D IoU."""
    inter_bev = boxes_overlap_bev_aligned(boxes_a, boxes_b)
    a_max = boxes_a[:, 2] + boxes_a[:, 5] / 2
    a_min = boxes_a[:, 2] - boxes_a[:, 5] / 2
    b_max = boxes_b[:, 2] + boxes_b[:, 5] / 2
    b_min = boxes_b[:, 2] - boxes_b[:, 5] / 2
    hov = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0)
    overlaps_3d = inter_bev * hov
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    return overlaps_3d / torch.clamp(vol_a + vol_b - overlaps_3d, min=1e-6)


def center_to_corner2d(center: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """(N, 2) centres and sizes -> (N, 4, 2) axis-aligned corners."""
    corners_norm = torch.tensor([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]],
                                dtype=dim.dtype, device=dim.device)
    return dim[:, None, :] * corners_norm[None] + center[:, None, :]


def bbox3d_overlaps_diou(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned-in-BEV DIoU, (N, 7) x (N, 7) -> (N,); differentiable."""
    qc = center_to_corner2d(pred_boxes[:, :2], pred_boxes[:, 3:5])
    gc = center_to_corner2d(gt_boxes[:, :2], gt_boxes[:, 3:5])
    inter_max = torch.minimum(qc[:, 2], gc[:, 2])
    inter_min = torch.maximum(qc[:, 0], gc[:, 0])
    out_max = torch.maximum(qc[:, 2], gc[:, 2])
    out_min = torch.minimum(qc[:, 0], gc[:, 0])

    p_lo, p_hi = pred_boxes[:, 2] - 0.5 * pred_boxes[:, 5], pred_boxes[:, 2] + 0.5 * pred_boxes[:, 5]
    g_lo, g_hi = gt_boxes[:, 2] - 0.5 * gt_boxes[:, 5], gt_boxes[:, 2] + 0.5 * gt_boxes[:, 5]
    vol_p = pred_boxes[:, 3] * pred_boxes[:, 4] * pred_boxes[:, 5]
    vol_g = gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5]
    inter_h = torch.clamp(torch.minimum(p_hi, g_hi) - torch.maximum(p_lo, g_lo), min=0)
    inter = torch.clamp(inter_max - inter_min, min=0)
    vol_inter = inter[:, 0] * inter[:, 1] * inter_h
    vol_union = vol_g + vol_p - vol_inter

    inter_diag = torch.sum((gt_boxes[:, 0:3] - pred_boxes[:, 0:3]) ** 2, dim=-1)
    outer_h = torch.clamp(torch.maximum(g_hi, p_hi) - torch.minimum(g_lo, p_lo), min=0)
    outer = torch.clamp(out_max - out_min, min=0)
    outer_diag = outer[:, 0] ** 2 + outer[:, 1] ** 2 + outer_h ** 2
    dious = (vol_inter / torch.clamp(vol_union, min=1e-6)
             - inter_diag / torch.clamp(outer_diag, min=1e-6))
    return torch.clamp(dious, -1.0, 1.0)


def bbox3d_overlaps_giou(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Axis-aligned-in-BEV GIoU, (N, 7) x (N, 7) -> (N,); differentiable."""
    qc = center_to_corner2d(pred_boxes[:, :2], pred_boxes[:, 3:5])
    gc = center_to_corner2d(gt_boxes[:, :2], gt_boxes[:, 3:5])
    inter_max = torch.minimum(qc[:, 2], gc[:, 2])
    inter_min = torch.maximum(qc[:, 0], gc[:, 0])
    out_max = torch.maximum(qc[:, 2], gc[:, 2])
    out_min = torch.minimum(qc[:, 0], gc[:, 0])

    p_lo, p_hi = pred_boxes[:, 2] - 0.5 * pred_boxes[:, 5], pred_boxes[:, 2] + 0.5 * pred_boxes[:, 5]
    g_lo, g_hi = gt_boxes[:, 2] - 0.5 * gt_boxes[:, 5], gt_boxes[:, 2] + 0.5 * gt_boxes[:, 5]
    vol_p = pred_boxes[:, 3] * pred_boxes[:, 4] * pred_boxes[:, 5]
    vol_g = gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5]
    inter_h = torch.clamp(torch.minimum(g_hi, p_hi) - torch.maximum(g_lo, p_lo), min=0)
    inter = torch.clamp(inter_max - inter_min, min=0)
    vol_inter = inter[:, 0] * inter[:, 1] * inter_h
    vol_union = vol_g + vol_p - vol_inter
    outer_h = torch.clamp(torch.maximum(g_hi, p_hi) - torch.minimum(g_lo, p_lo), min=0)
    outer = torch.clamp(out_max - out_min, min=0)
    closure = outer[:, 0] * outer[:, 1] * outer_h
    gious = (vol_inter / torch.clamp(vol_union, min=1e-6)
             - (closure - vol_union) / torch.clamp(closure, min=1e-6))
    return torch.clamp(gious, -1.0, 1.0)


def gaussian_radius(height: torch.Tensor, width: torch.Tensor, min_overlap: float = 0.5):
    """CenterNet gaussian radius, elementwise."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0))) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)
