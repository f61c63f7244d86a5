"""The anchor head family (SECOND / PointPillars): the box coder, the anchors,
axis-aligned target assignment, the losses, the decode and the 1x1-conv head.

Counterpart of ``radardistill_tpu/models/anchor_head.py``: ``ResidualCoder``,
``generate_anchors``, ``nearest_bev_iou``, ``assign_targets_single`` /
``assign_anchor_targets``, ``sigmoid_focal_loss``, ``smooth_l1_loss``,
``add_sin_difference``, ``get_direction_target``, ``anchor_head_loss``,
``limit_period``, ``decode_anchor_predictions`` and ``AnchorHeadSingle``.
Anchors are a static per-class stack; assignment runs over (anchors x padded
GT) with the padded rows masked out, one sample and one class at a time, so
the (A, M) IoU matrix never exists over the batch. The IoU is computed in
the JAX package's order of operations, and assignment compares it exactly
(the forced match ``iou == best of its GT``, the first ``argmax`` over GTs),
as the reference does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvParams

FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)  # the cls conv's bias_focal


class ResidualCoder:
    """Anchor-relative residual encoding (box_coder_utils.ResidualCoder)."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """(..., 7+C) x (..., 7+C) -> (..., code_size)."""
        anchors = torch.cat([anchors[..., :3], anchors[..., 3:6].clamp(min=1e-5),
                             anchors[..., 6:]], dim=-1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp(min=1e-5), boxes[..., 6:]],
                          dim=-1)
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        xg, yg, zg, dxg, dyg, dzg, rg = boxes[..., :7].unbind(-1)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        parts = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                 torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        if self.encode_angle_by_sincos:
            parts += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            parts += [rg - ra]
        for c in range(boxes.shape[-1] - 7):
            parts.append(boxes[..., 7 + c] - anchors[..., 7 + c])
        return torch.stack(parts, dim=-1)

    def decode(self, encodings, anchors):
        xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        xt, yt, zt, dxt, dyt, dzt = encodings[..., :6].unbind(-1)
        if self.encode_angle_by_sincos:
            rg = torch.atan2(encodings[..., 7] + torch.sin(ra), encodings[..., 6] + torch.cos(ra))
            base = 8
        else:
            rg = encodings[..., 6] + ra
            base = 7
        parts = [xt * diag + xa, yt * diag + ya, zt * dza + za, torch.exp(dxt) * dxa,
                 torch.exp(dyt) * dya, torch.exp(dzt) * dza, rg]
        for c in range(encodings.shape[-1] - base):
            parts.append(encodings[..., base + c] + anchors[..., 7 + c])
        return torch.stack(parts, dim=-1)


def generate_anchors(anchor_generator_cfgs, grid_size, point_cloud_range,
                     feature_map_stride) -> List[np.ndarray]:
    """Per class config {anchor_sizes, anchor_rotations, anchor_bottom_heights,
    align_center?} -> list of (H, W, n_size * n_rot, 7) float32 arrays (numpy;
    the caller moves them to its device)."""
    nx, ny = grid_size[0] // feature_map_stride, grid_size[1] // feature_map_stride
    x0, y0 = point_cloud_range[0], point_cloud_range[1]
    vx = (point_cloud_range[3] - point_cloud_range[0]) / nx
    vy = (point_cloud_range[4] - point_cloud_range[1]) / ny
    out = []
    for cfg in anchor_generator_cfgs:
        sizes = np.asarray(cfg["anchor_sizes"], np.float32)
        rots = np.asarray(cfg["anchor_rotations"], np.float32)
        heights = np.asarray(cfg["anchor_bottom_heights"], np.float32)
        if cfg.get("align_center", False):
            xs = x0 + (np.arange(nx) + 0.5) * vx
            ys = y0 + (np.arange(ny) + 0.5) * vy
        else:
            xs = np.linspace(x0, point_cloud_range[3], nx, dtype=np.float32)
            ys = np.linspace(y0, point_cloud_range[4], ny, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        anchors = np.zeros((ny, nx, len(sizes) * len(rots), 7), np.float32)
        k = 0
        for si, size in enumerate(sizes):
            z_center = heights[min(si, len(heights) - 1)] + size[2] / 2
            for rot in rots:
                anchors[:, :, k, 0] = gx
                anchors[:, :, k, 1] = gy
                anchors[:, :, k, 2] = z_center
                anchors[:, :, k, 3:6] = size
                anchors[:, :, k, 6] = rot
                k += 1
        out.append(anchors)
    return out


def _aligned(boxes):
    """Snap the heading to the nearest axis (swap dx and dy closer to ±π/2)
    and return the axis-aligned BEV corners (x0, y0, x1, y1)."""
    rot = boxes[..., 6] - torch.floor(boxes[..., 6] / math.pi + 0.5) * math.pi
    swap = torch.abs(rot) > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    return torch.stack([boxes[..., 0] - dx / 2, boxes[..., 1] - dy / 2,
                        boxes[..., 0] + dx / 2, boxes[..., 1] + dy / 2], dim=-1)


def nearest_bev_iou(boxes_a, boxes_b):
    """box_utils.boxes3d_nearest_bev_iou: (N, 7+) x (M, 7+) -> (N, M)."""
    a = _aligned(boxes_a)[:, None]
    b = _aligned(boxes_b)[None, :]
    ix = torch.clamp(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                     min=0)
    iy = torch.clamp(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                     min=0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def assign_targets_single(anchors, gt_boxes, gt_classes, gt_valid, coder: ResidualCoder,
                          matched_threshold, unmatched_threshold):
    """anchors (A, 7); gt_boxes (M, 7+) padded; gt_classes (M,) 1-based;
    gt_valid (M,) bool -> (labels (A,) int32: -1 ignore, 0 background, else
    the class; reg_targets (A, code_size), zero off the foreground)."""
    iou = nearest_bev_iou(anchors[:, :7], gt_boxes[:, :7])
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    any_gt = gt_valid.any()
    a2g_max, a2g_idx = iou.max(dim=1)  # ties: the first GT, as jnp.argmax
    g2a_max = iou.max(dim=0).values
    g2a_max = torch.where(g2a_max == 0, -1.0, g2a_max)
    # the anchors that achieve a GT's best overlap (forced match)
    force = ((iou == g2a_max[None, :]) & gt_valid[None, :] & (g2a_max[None, :] > 0)).any(dim=1)
    pos = a2g_max >= matched_threshold
    bg = a2g_max < unmatched_threshold
    labels = torch.full((anchors.shape[0],), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(bg, 0, labels)
    labels = torch.where(force | pos, gt_classes[a2g_idx].to(torch.int32), labels)
    labels = torch.where(any_gt, labels, 0)
    fg = labels > 0
    ncols = min(gt_boxes.shape[1], anchors.shape[1])
    reg = coder.encode(gt_boxes[a2g_idx][:, :ncols], anchors[:, :ncols])
    return labels, torch.where(fg[:, None], reg, 0.0)


@torch.no_grad()
def assign_anchor_targets(anchors_per_class: Sequence[torch.Tensor], gt_boxes, class_ids,
                          coder: ResidualCoder, matched_thr: Sequence[float],
                          unmatched_thr: Sequence[float]) -> Dict[str, torch.Tensor]:
    """gt_boxes (B, M, D) with the 1-based class in the last column (0 =
    padding) -> {'box_cls_labels' (B, A_total), 'box_reg_targets' (B,
    A_total, code)}: per location the classes' anchors concatenated, then
    flattened, as the reference orders them."""
    labels_b, regs_b = [], []
    for boxes in gt_boxes:
        cls = boxes[:, -1].to(torch.int32)
        valid = cls > 0
        labels_all, regs_all = [], []
        for ci, anchors in enumerate(anchors_per_class):
            labels, reg = assign_targets_single(
                anchors.reshape(-1, 7), boxes[:, :-1], cls, valid & (cls == class_ids[ci]),
                coder, matched_thr[ci], unmatched_thr[ci])
            labels_all.append(labels.reshape(anchors.shape[:3]))
            regs_all.append(reg.reshape(*anchors.shape[:3], coder.code_size))
        labels_b.append(torch.cat(labels_all, dim=-1).reshape(-1))
        regs_b.append(torch.cat(regs_all, dim=-2).reshape(-1, coder.code_size))
    return {"box_cls_labels": torch.stack(labels_b), "box_reg_targets": torch.stack(regs_b)}


def sigmoid_focal_loss(logits, one_hot_targets, weights, alpha=0.25, gamma=2.0):
    """loss_utils.SigmoidFocalClassificationLoss, elementwise, weighted."""
    p = torch.sigmoid(logits)
    alpha_w = one_hot_targets * alpha + (1 - one_hot_targets) * (1 - alpha)
    pt = one_hot_targets * (1 - p) + (1 - one_hot_targets) * p
    focal = alpha_w * torch.pow(pt, gamma)
    bce = (torch.clamp(logits, min=0) - logits * one_hot_targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return focal * bce * weights[..., None]


def smooth_l1_loss(pred, target, weights, beta=1 / 9.0, code_weights=None):
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.tensor(code_weights, dtype=diff.dtype, device=diff.device)
    n = torch.abs(diff)
    loss = torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)
    return loss * weights[..., None]


def add_sin_difference(b1, b2, dim=6):
    s = torch.sin(b1[..., dim]) * torch.cos(b2[..., dim])
    c = torch.cos(b1[..., dim]) * torch.sin(b2[..., dim])
    b1 = torch.cat([b1[..., :dim], s[..., None], b1[..., dim + 1:]], dim=-1)
    b2 = torch.cat([b2[..., :dim], c[..., None], b2[..., dim + 1:]], dim=-1)
    return b1, b2


def get_direction_target(anchors_flat, reg_targets, dir_offset=0.78539, num_bins=2):
    rot_gt = reg_targets[..., 6] + anchors_flat[..., 6]
    offset_rot = torch.remainder(rot_gt - dir_offset, 2 * math.pi)
    bins = torch.clamp(torch.floor(offset_rot / (2 * math.pi / num_bins)), 0, num_bins - 1)
    return bins.to(torch.int64)


def anchor_head_loss(preds, targets, anchors_flat, num_class, coder, cls_weight=1.0,
                     loc_weight=2.0, dir_weight=0.2, code_weights=None, dir_offset=0.78539,
                     num_dir_bins=2):
    """Focal classification + smooth-L1 (sin difference) + direction CE.
    Returns (total, tb)."""
    cls_preds = preds["cls_preds"].float()
    box_preds = preds["box_preds"].float()
    labels = targets["box_cls_labels"]
    reg_t = targets["box_reg_targets"]

    cared = labels >= 0
    positives = labels > 0
    cls_w = (positives | (labels == 0)).float()
    reg_w = positives.float()
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).float(), min=1.0)
    cls_w = cls_w / pos_norm
    reg_w = reg_w / pos_norm

    cls_targets = torch.where(cared, labels, 0).long()
    one_hot = F.one_hot(cls_targets, num_class + 1)[..., 1:].float()
    b = cls_preds.shape[0]
    cls_loss = sigmoid_focal_loss(cls_preds, one_hot, cls_w).sum() / b * cls_weight

    bp_sin, rt_sin = add_sin_difference(box_preds, reg_t)
    loc_loss = smooth_l1_loss(bp_sin, rt_sin, reg_w, code_weights=code_weights).sum() / b \
        * loc_weight
    total = cls_loss + loc_loss
    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    if "dir_cls_preds" in preds:
        dir_t = get_direction_target(anchors_flat[None], reg_t, dir_offset, num_dir_bins)
        dir_oh = F.one_hot(dir_t, num_dir_bins).float()
        logp = F.log_softmax(preds["dir_cls_preds"].float(), dim=-1)
        dir_loss = (-(dir_oh * logp).sum(dim=-1) * reg_w).sum() / b * dir_weight
        total = total + dir_loss
        tb["rpn_loss_dir"] = dir_loss
    tb["rpn_loss"] = total
    return total, tb


def limit_period(val, offset=0.5, period=math.pi):
    """common_utils.limit_period."""
    return val - torch.floor(val / period + offset) * period


def decode_anchor_predictions(preds, anchors_flat, coder: ResidualCoder, dir_offset=0.78539,
                              dir_limit_offset=0.0, num_dir_bins=2):
    """Box residuals decoded against the anchors, the heading snapped to the
    predicted direction bin. Returns (sigmoid scores (B, A, C), boxes (B, A,
    7+))."""
    cls_scores = torch.sigmoid(preds["cls_preds"])
    boxes = coder.decode(preds["box_preds"], anchors_flat[None])
    if "dir_cls_preds" in preds:
        dir_labels = torch.argmax(preds["dir_cls_preds"], dim=-1)
        period = 2 * math.pi / num_dir_bins
        dir_rot = limit_period(boxes[..., 6] - dir_offset, dir_limit_offset, period)
        rot = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
        boxes = torch.cat([boxes[..., :6], rot[..., None], boxes[..., 7:]], dim=-1)
    return cls_scores, boxes


class HeadConv(ConvParams):
    """flax ``nn.Conv`` with its parameters in its own scope: weight (O, I,
    k, k), bias (O,), stride 1, SAME padding. ``kernel_init`` and
    ``bias_init`` name the reference's laws (``layers.init_reference_``)."""

    def __init__(self, in_ch, out_ch, kernel_size=1, kernel_init="lecun", bias_init=0.0):
        super().__init__(in_ch, out_ch, kernel_size, use_bias=True)
        self.kernel_init, self.bias_init = kernel_init, bias_init

    def forward(self, x):
        if self.weight.shape[-1] == 1:
            return F.linear(x, self.weight[:, :, 0, 0].to(x.dtype), self.bias.to(x.dtype))
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype), 1,
                     self.weight.shape[-1] // 2)
        return y.permute(0, 2, 3, 1)


class AnchorHeadSingle(nn.Module):
    """1x1-conv anchor head (anchor_head_single.py): ``conv_cls`` (bias at
    the focal prior), ``conv_box`` (kernel normal with std 1e-3) and
    ``conv_dir_cls``. Returns {cls_preds (B, A, num_class), box_preds (B, A,
    code), dir_cls_preds (B, A, bins)}, A = H·W·anchors per location."""

    def __init__(self, in_channels: int, num_class: int, num_anchors_per_location: int,
                 code_size: int, num_dir_bins: int = 2, use_dir: bool = True):
        super().__init__()
        n = num_anchors_per_location
        self.num_class, self.code_size, self.num_dir_bins, self.n = (num_class, code_size,
                                                                     num_dir_bins, n)
        self.conv_cls = HeadConv(in_channels, n * num_class, bias_init=FOCAL_PRIOR_BIAS)
        self.conv_box = HeadConv(in_channels, n * code_size, kernel_init="normal_1e-3")
        self.conv_dir_cls = HeadConv(in_channels, n * num_dir_bins) if use_dir else None

    def forward(self, spatial_features_2d) -> Dict[str, torch.Tensor]:
        b, h, w, _ = spatial_features_2d.shape
        a = h * w * self.n
        out = {"cls_preds": self.conv_cls(spatial_features_2d).reshape(b, a, self.num_class),
               "box_preds": self.conv_box(spatial_features_2d).reshape(b, a, self.code_size)}
        if self.conv_dir_cls is not None:
            out["dir_cls_preds"] = self.conv_dir_cls(spatial_features_2d).reshape(
                b, a, self.num_dir_bins)
        return out
