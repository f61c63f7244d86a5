"""CenterPoint multi-task head (merged-hidden form), its targets and losses,
and its decode + NMS.

Counterpart of ``radardistill_tpu/models/center_head.py``: ``HeadSpec``,
``StackedSubHead`` (its ``conv_0`` a dense conv on the shared features, its
``conv_out`` a grouped conv over the task heads — the JAX package's
block-diagonal kernel is exactly that), ``CenterHead`` with the merged hidden
layer (all subheads' conv_0 + BN + ReLU as one conv; in train mode the merged
BN takes the batch's statistics and updates every subhead's running ones),
``assign_targets`` (gaussian heatmaps and regression targets), the losses
(``focal_loss_cornernet``, ``reg_l1_loss``, the IoU and DIoU terms,
``centerhead_loss``) and ``decode_and_nms``. Inputs NHWC; predictions
(B, H, W, n_heads, C) per subhead; the losses carry the head axis in front
where the JAX package maps over it.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import geometry, nms
from .layers import (BN_MOM_DEFAULT, BatchNormTorch, Conv2dTorch, batch_stats, clip_sigmoid,
                     update_running_)

# subhead output channels per task (HEAD_DICT of the shipped yamls)
REG_HEADS = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2), ("vel", 2), ("iou", 1))


class HeadSpec:
    """Static task-head layout derived from CLASS_NAMES_EACH_HEAD."""

    def __init__(self, class_names_each_head: Sequence[Sequence[str]], class_names: Sequence[str]):
        self.class_names = list(class_names)
        self.heads = [[c for c in group if c in class_names] for group in class_names_each_head]
        self.num_heads = len(self.heads)
        self.max_cls = max(len(h) for h in self.heads)
        ids = np.zeros((self.num_heads, self.max_cls), np.int32)
        valid = np.zeros((self.num_heads, self.max_cls), bool)
        for i, group in enumerate(self.heads):
            for j, name in enumerate(group):
                ids[i, j] = self.class_names.index(name) + 1
                valid[i, j] = True
        self.class_ids = ids          # (n_heads, max_cls) global 1-based
        self.class_valid = valid      # (n_heads, max_cls)
        self.total_classes = sum(len(h) for h in self.heads)


class _BlockDiagConv(nn.Module):
    """3x3 conv with ``num_heads`` groups: weight (n·co, cin/n, 3, 3), bias
    (n·co,). The JAX package runs it as a dense conv with a block-diagonal
    kernel; the numbers are the same."""

    def __init__(self, in_ch: int, num_heads: int, out_per_head: int):
        super().__init__()
        self.num_heads = num_heads
        self.weight = nn.Parameter(torch.empty(num_heads * out_per_head, in_ch // num_heads, 3, 3))
        self.bias = nn.Parameter(torch.empty(num_heads * out_per_head))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     1, 1, groups=self.num_heads)
        return y.permute(0, 2, 3, 1)


class StackedSubHead(nn.Module):
    """One subhead type across all task heads: conv_0 (shared -> n·shared) +
    bn_0, then conv_out (grouped). Run through ``CenterHead``'s merged form."""

    def __init__(self, shared_channels: int, num_heads: int, out_channels: int,
                 use_bias: bool = True):
        super().__init__()
        self.num_heads, self.out_channels = num_heads, out_channels
        self.conv_0 = Conv2dTorch(shared_channels, num_heads * shared_channels, 3, 1, 1,
                                  use_bias=use_bias)
        self.bn_0 = BatchNormTorch(num_heads * shared_channels)
        self.conv_out = _BlockDiagConv(num_heads * shared_channels, num_heads, out_channels)

    def tail(self, hidden):
        y = self.conv_out(hidden)
        b, h, w, _ = y.shape
        return y.reshape(b, h, w, self.num_heads, self.out_channels)


class CenterHead(nn.Module):
    """Shared conv + stacked subheads, merged hidden layer. Returns a dict of
    (B, H, W, n_heads, C) predictions."""

    def __init__(self, spec: HeadSpec, in_channels: int, shared_channels: int = 64,
                 num_hm_conv: int = 2, use_bias_before_norm: bool = True,
                 with_iou: bool = True):
        super().__init__()
        if num_hm_conv != 2:
            raise NotImplementedError("the merged head needs NUM_HM_CONV = 2 (shipped configs)")
        self.spec = spec
        n = spec.num_heads
        self.shared_conv = Conv2dTorch(in_channels, shared_channels, 3, 1, 1,
                                       use_bias=use_bias_before_norm)
        self.shared_bn = BatchNormTorch(shared_channels)
        self.sub_names = [name for name, _ in REG_HEADS if with_iou or name != "iou"] + ["hm"]
        out_ch = dict(REG_HEADS, hm=spec.max_cls)
        for name in self.sub_names:
            self.add_module(name, StackedSubHead(shared_channels, n, out_ch[name],
                                                 use_bias_before_norm))

    def forward(self, spatial_features_2d) -> Dict[str, torch.Tensor]:
        x = torch.relu(self.shared_bn(self.shared_conv(spatial_features_2d)))
        subs = [getattr(self, name) for name in self.sub_names]
        dt = x.dtype
        # the 7 per-subhead conv_0 + BN + ReLU stacks as ONE conv and one BN
        # (per-channel BN statistics equal the separate BNs)
        kcat = torch.cat([s.conv_0.conv.weight for s in subs], dim=0)
        bcat = torch.cat([s.conv_0.conv.bias for s in subs], dim=0)
        h = F.conv2d(x.permute(0, 3, 1, 2), kcat.to(dt), bcat.to(dt), 1, 1).permute(0, 2, 3, 1)
        bns = [s.bn_0.bn for s in subs]
        if self.training:
            # flax nn.BatchNorm semantics: float32 statistics, biased variance
            mean, var = batch_stats(h.float())
            off = 0
            for b in bns:
                c = b.weight.shape[0]
                update_running_(b.running_mean, mean[off:off + c], BN_MOM_DEFAULT)
                update_running_(b.running_var, var[off:off + c], BN_MOM_DEFAULT)
                off += c
            mean, var = mean.to(dt), var.to(dt)
        else:
            mean = torch.cat([b.running_mean for b in bns]).to(dt)
            var = torch.cat([b.running_var for b in bns]).to(dt)
        # the statistics go to the compute dtype before the rsqrt, as in flax
        scale = torch.cat([b.weight for b in bns]).to(dt)
        bias = torch.cat([b.bias for b in bns]).to(dt)
        mul = torch.rsqrt(var + subs[0].bn_0.eps) * scale
        y = torch.relu((h - mean) * mul + bias)
        preds, c = {}, subs[0].conv_0.conv.weight.shape[0]
        for i, (name, sub) in enumerate(zip(self.sub_names, subs)):
            preds[name] = sub.tail(y[..., i * c:(i + 1) * c])
        return preds


# ---------------------------------------------------------------- targets


def _stamp_heatmaps(cint_x, cint_y, radii, channel, hw, chunk=50):
    """Max-compose per-box gaussians into (B, n_channels, H, W).

    cint_x/cint_y/radii (B, M) int; channel (B, M, n_channels) bool says which
    heatmap channels a box stamps (none for a padded or foreign box). The gaussian sits at the
    integer centre: ``exp(-(dx² + dy²) / 2σ²)``, ``σ = (2r+1)/6``, on the
    Chebyshev support ``|Δ| <= r``. It is separable, so the exponentials are
    (B, chunk, H) and (B, chunk, W) vectors; boxes go through in chunks to
    bound the (B, chunk, n_channels, H, W) product."""
    H, W = hw
    B, M = radii.shape
    n_channels = channel.shape[-1]
    dev = radii.device
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    hm = torch.zeros((B, n_channels, H, W), dtype=torch.float32, device=dev)
    for lo in range(0, M, chunk):
        sl = slice(lo, lo + chunk)
        r = radii[:, sl]
        dx = xs - cint_x[:, sl, None]  # (B, chunk, W)
        dy = ys - cint_y[:, sl, None]  # (B, chunk, H)
        inv2s = 1.0 / (2 * torch.square((2 * r.float() + 1) / 6.0))
        gx = torch.exp(-(dx * dx) * inv2s[..., None])
        gy = torch.exp(-(dy * dy) * inv2s[..., None])
        gx = torch.where(dx.abs() <= r[..., None], gx, 0.0)
        gy = torch.where(dy.abs() <= r[..., None], gy, 0.0)
        gyc = gy[:, :, None, :] * channel[:, sl, :, None].to(gy.dtype)  # (B, chunk, C, H)
        contrib = (gyc[..., None] * gx[:, :, None, None, :]).amax(dim=1)
        hm = torch.maximum(hm, contrib)
    return hm


@torch.no_grad()
def assign_targets(gt_boxes: torch.Tensor, spec: HeadSpec, feature_map_hw: Tuple[int, int],
                   feature_map_stride: int, voxel_size, point_cloud_range,
                   num_max_objs: int = 500, gaussian_overlap: float = 0.1,
                   min_radius: int = 2) -> Dict[str, torch.Tensor]:
    """CenterHead target assignment. gt_boxes (B, M, D) pcdet layout
    [x, y, z, dx, dy, dz, heading, (vx, vy), cls], cls global and 1-based,
    zero rows are padding. Returns
      heatmaps (B, n_heads, H, W, max_cls), target_boxes (B, n_heads, M, D)
      [Δx, Δy, z, log dims, cos, sin, extras], inds and masks (B, n_heads, M),
      gt_box7 (B, n_heads, M, 7).
    Box slots keep their positions. ``num_max_objs`` is the reference's
    signature; the slot count is that of ``gt_boxes``."""
    del num_max_objs
    H, W = feature_map_hw
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    x0, y0 = float(point_cloud_range[0]), float(point_cloud_range[1])
    B, M, D = gt_boxes.shape
    dev = gt_boxes.device
    boxes = gt_boxes
    ids = torch.as_tensor(spec.class_ids, dtype=torch.int32, device=dev)      # (n, max_cls)
    vtab = torch.as_tensor(spec.class_valid, device=dev)                      # (n, max_cls)
    n, max_cls = ids.shape

    cls = boxes[..., -1].to(torch.int32)
    coord_x = torch.clamp((boxes[..., 0] - x0) / vx / feature_map_stride, 0, W - 0.5)
    coord_y = torch.clamp((boxes[..., 1] - y0) / vy / feature_map_stride, 0, H - 0.5)
    cint_x = coord_x.to(torch.int32)  # truncation
    cint_y = coord_y.to(torch.int32)
    dxf = boxes[..., 3] / vx / feature_map_stride
    dyf = boxes[..., 4] / vy / feature_map_stride
    radius = geometry.gaussian_radius(dxf, dyf, gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=min_radius)
    ok_size = (dxf > 0) & (dyf > 0) & (cls > 0)

    ret = torch.zeros((B, M, D), dtype=boxes.dtype, device=dev)
    ret[..., 0] = coord_x - cint_x
    ret[..., 1] = coord_y - cint_y
    ret[..., 2] = boxes[..., 2]
    ret[..., 3:6] = torch.log(torch.clamp(boxes[..., 3:6], min=1e-6))
    ret[..., 6] = torch.cos(boxes[..., 6])
    ret[..., 7] = torch.sin(boxes[..., 6])
    if D > 8:
        ret[..., 8:] = boxes[..., 7:-1]
    inds = cint_y * W + cint_x

    match = (cls[:, None, :, None] == ids[None, :, None, :]) & vtab[None, :, None, :]  # (B,n,M,C)
    sel = match.any(dim=-1) & ok_size[:, None, :]                                     # (B, n, M)
    # the class slot of a box within its head: the first match (argmax)
    first = match & (torch.cumsum(match.to(torch.int32), dim=-1) == 1) & sel[..., None]
    channel = first.permute(0, 2, 1, 3).reshape(B, M, n * max_cls)
    hm = _stamp_heatmaps(cint_x, cint_y, radius, channel, (H, W))
    m = sel.to(torch.int32)
    return {
        "heatmaps": hm.reshape(B, n, max_cls, H, W).permute(0, 1, 3, 4, 2).contiguous(),
        "target_boxes": ret[:, None] * m[..., None].to(ret.dtype),
        "inds": inds[:, None] * m,
        "masks": m,
        "gt_box7": boxes[:, None, :, :7] * m[..., None].to(boxes.dtype),
    }


def flatten_class_channels(spec: HeadSpec, stacked: torch.Tensor) -> torch.Tensor:
    """(B, H, W, n_heads, max_cls) -> (B, H, W, total_classes), dropping the
    padded class slots; channel order = global class order."""
    return torch.stack([stacked[..., h, j] for h in range(spec.num_heads)
                        for j in range(len(spec.heads[h]))], dim=-1)


def flatten_target_heatmaps(spec: HeadSpec, heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, n_heads, H, W, max_cls) -> (B, H, W, total_classes)."""
    return torch.stack([heatmaps[:, h, :, :, j] for h in range(spec.num_heads)
                        for j in range(len(spec.heads[h]))], dim=-1)


# ----------------------------------------------------------------- losses


def focal_loss_cornernet(pred: torch.Tensor, gt: torch.Tensor, dims=None) -> torch.Tensor:
    """CornerNet focal loss; pred already clip-sigmoided. Reduced over ``dims``
    (all axes by default)."""
    dims = tuple(range(pred.dim())) if dims is None else dims
    pos = (gt == 1.0).float()
    neg = (gt < 1.0).float()
    neg_w = torch.pow(1 - gt, 4)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, 2) * pos
    neg_loss = torch.log(1 - pred) * torch.pow(pred, 2) * neg_w * neg
    num_pos = pos.sum(dim=dims)
    pos_l = pos_loss.sum(dim=dims)
    neg_l = neg_loss.sum(dim=dims)
    return torch.where(num_pos == 0, -neg_l, -(pos_l + neg_l) / torch.clamp(num_pos, min=1.0))


def gather_at_inds(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """(..., H*W, C) gathered at (..., M) flat spatial indices -> (..., M, C)."""
    idx = inds.long()[..., None].expand(*inds.shape, feat.shape[-1])
    return torch.gather(feat, -2, idx)


def reg_l1_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-code-dim L1 over masked object slots: pred/target (..., B, M, D),
    mask (..., B, M) -> (..., D), normalized by ``max(num_pos, 1)``."""
    m = mask.float()
    num = m.sum(dim=(-2, -1))
    diff = torch.abs(pred * m[..., None] - target * m[..., None])
    return diff.sum(dim=(-3, -2)) / torch.clamp(num, min=1.0)[..., None]


def decode_boxes_full_map(preds_h: Dict[str, torch.Tensor], hw, feature_map_stride,
                          voxel_size, point_cloud_range) -> torch.Tensor:
    """Dense box map of one head's (or, with a leading axis, every head's)
    predictions: dict of (..., H, W, C) -> (..., H*W, 7) [x, y, z, dx, dy, dz,
    rot]. The range's origin is cast to int, as in the reference."""
    H, W = hw
    dev = preds_h["dim"].device
    dim = torch.exp(torch.clamp(preds_h["dim"].float(), -5, 5))
    rot = torch.atan2(preds_h["rot"][..., 1:2].float(), preds_h["rot"][..., 0:1].float())
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    cx = xs + preds_h["center"][..., 0:1].float()
    cy = ys + preds_h["center"][..., 1:2].float()
    cx = cx * feature_map_stride * float(voxel_size[0]) + int(point_cloud_range[0])
    cy = cy * feature_map_stride * float(voxel_size[1]) + int(point_cloud_range[1])
    boxes = torch.cat([cx, cy, preds_h["center_z"].float(), dim, rot], dim=-1)
    return boxes.reshape(*boxes.shape[:-3], H * W, 7)


def centerhead_loss(preds: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                    spec: HeadSpec, code_weights: Sequence[float], cls_weight: float,
                    loc_weight: float, hw: Tuple[int, int], feature_map_stride: int,
                    voxel_size, point_cloud_range, with_iou: bool = True, iou_reg: bool = True):
    """The full CenterHead loss, summed over the task heads; ``tb`` holds the
    per-head terms. Every tensor carries the head axis in front."""
    H, W = hw
    dev = preds["hm"].device
    cw = torch.tensor(code_weights, dtype=torch.float32, device=dev)
    vmask = torch.as_tensor(spec.class_valid, device=dev)[:, None, None, None, :]

    def hfirst(key):  # (B, H, W, n, C) -> (n, B, H, W, C)
        return preds[key].float().movedim(3, 0)

    hm_p = hfirst("hm")
    reg_map = torch.cat([hfirst(k) for k in ("center", "center_z", "dim", "rot", "vel")], dim=-1)
    n, b = reg_map.shape[:2]
    t_hm = targets["heatmaps"].movedim(1, 0)
    t_boxes = targets["target_boxes"].movedim(1, 0)
    t_inds = targets["inds"].movedim(1, 0)
    t_masks = targets["masks"].movedim(1, 0)
    t_gt7 = targets["gt_box7"].movedim(1, 0)

    # padded class channels contribute ~0 (pred = eps, target = 0)
    hm_pred = torch.where(vmask, clip_sigmoid(hm_p), 1e-4)
    hm_tgt = torch.where(vmask, t_hm, 0.0)
    hm_l = focal_loss_cornernet(hm_pred, hm_tgt, dims=(1, 2, 3, 4)) * cls_weight

    pred_at = gather_at_inds(reg_map.reshape(n, b, H * W, -1), t_inds)  # (n, B, M, 10)
    reg_loss = reg_l1_loss(pred_at, t_boxes[..., : reg_map.shape[-1]], t_masks)
    loc_l = (reg_loss * cw).sum(dim=-1) * loc_weight

    iou_l = torch.zeros(n, dtype=torch.float32, device=dev)
    ioureg_l = torch.zeros(n, dtype=torch.float32, device=dev)
    if with_iou or iou_reg:
        box_map = decode_boxes_full_map(
            {k: hfirst(k) for k in ("center", "center_z", "dim", "rot")}, hw,
            feature_map_stride, voxel_size, point_cloud_range)  # (n, B, HW, 7)
        box_at = gather_at_inds(box_map, t_inds)  # (n, B, M, 7)
        mask = t_masks.float()
        nmask = mask.sum(dim=(1, 2))
        if with_iou:
            iou_pred_at = gather_at_inds(hfirst("iou").reshape(n, b, H * W, 1), t_inds)[..., 0]
            # target = 2 * IoU3D - 1 of the decoded boxes, no gradient through them
            iou_tgt = geometry.boxes_aligned_iou3d(
                box_at.detach().reshape(-1, 7), t_gt7.reshape(-1, 7)).reshape(n, b, -1)
            iou_tgt = 2.0 * iou_tgt - 1.0
            iou_l = (torch.abs(iou_pred_at - iou_tgt) * mask).sum(dim=(1, 2)) / (nmask + 1e-4)
            iou_l = torch.where(nmask == 0, 0.0, iou_l)
        if iou_reg:
            diou = geometry.bbox3d_overlaps_diou(
                box_at.reshape(-1, 7), t_gt7.reshape(-1, 7)).reshape(n, b, -1)
            ioureg_l = ((1.0 - diou) * mask).sum(dim=(1, 2)) / (nmask + 1e-4)
            ioureg_l = torch.where(nmask == 0, 0.0, ioureg_l)

    total = (hm_l + loc_l).sum() + iou_l.sum() + loc_weight * ioureg_l.sum()
    tb = {"rpn_loss": total}
    for h in range(spec.num_heads):
        tb[f"hm_loss_head_{h}"] = hm_l[h]
        tb[f"loc_loss_head_{h}"] = loc_l[h]
        if with_iou:
            tb[f"iou_loss_head_{h}"] = iou_l[h]
        if iou_reg:
            tb[f"iou_reg_loss_head_{h}"] = ioureg_l[h]
    return total, tb


# ---------------------------------------------------------- decode + NMS


def decode_and_nms(preds: Dict[str, torch.Tensor], spec: HeadSpec, hw: Tuple[int, int],
                   feature_map_stride: int, voxel_size, point_cloud_range,
                   post_center_limit_range, k_per_head: int = 500,
                   score_thresh: float = 0.1, rectifier: float = 0.5,
                   nms_thresh: float = 0.2, nms_pre: int = 1000, nms_post: int = 83,
                   with_iou: bool = True, with_vel: bool = True):
    """Batched decode + per-head class-agnostic NMS with fixed-shape outputs:
    'boxes' (B, n_heads·post, 9), 'scores', 'labels' (1-based global),
    'valid'. Box layout [x, y, z, dx, dy, dz, rot, vx, vy]."""
    H, W = hw
    dev = preds["hm"].device
    B = preds["hm"].shape[0]
    pclr = torch.tensor(post_center_limit_range, dtype=torch.float32, device=dev)
    class_valid = torch.as_tensor(spec.class_valid, device=dev)
    class_ids = torch.as_tensor(spec.class_ids, dtype=torch.int32, device=dev)

    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for h in range(spec.num_heads):
        hm = torch.sigmoid(preds["hm"][..., h, :].float())
        hm = torch.where(class_valid[h], hm, -1.0)
        hm_flat = hm.permute(0, 3, 1, 2).reshape(B, -1)
        scores, inds = nms.top_k_stable(hm_flat, k_per_head)
        cls_local = inds // (H * W)
        spatial = inds % (H * W)
        ys = (spatial // W).float()
        xs = (spatial % W).float()

        def g(key, ch):
            flat = preds[key][..., h, :].float().reshape(B, H * W, ch)
            return torch.gather(flat, 1, spatial[..., None].expand(B, spatial.shape[1], ch))

        center = g("center", 2)
        rot = g("rot", 2)
        x_w = ((xs[..., None] + center[..., 0:1]) * feature_map_stride
               * float(voxel_size[0]) + float(point_cloud_range[0]))
        y_w = ((ys[..., None] + center[..., 1:2]) * feature_map_stride
               * float(voxel_size[1]) + float(point_cloud_range[1]))
        parts = [x_w, y_w, g("center_z", 1), torch.exp(g("dim", 3)),
                 torch.atan2(rot[..., 1:2], rot[..., 0:1])]
        if with_vel:
            parts.append(g("vel", 2))
        boxes = torch.cat(parts, dim=-1)

        valid = (torch.all(boxes[..., :3] >= pclr[:3], -1)
                 & torch.all(boxes[..., :3] <= pclr[3:], -1))
        if score_thresh is not None:
            valid = valid & (scores > score_thresh)
        if with_iou:
            iou_p = torch.clamp(g("iou", 1)[..., 0], 0.0, 1.0)
            scores = torch.pow(scores, 1 - rectifier) * torch.pow(iou_p, rectifier)

        labels = class_ids[h][cls_local]
        sels = [nms.class_agnostic_nms(boxes[b], scores[b], valid[b], nms_thresh,
                                       pre_max=min(nms_pre, k_per_head), post_max=nms_post)
                for b in range(B)]
        all_boxes.append(torch.stack([boxes[b, i] for b, (i, _) in enumerate(sels)]))
        all_scores.append(torch.stack([scores[b, i] for b, (i, _) in enumerate(sels)]))
        all_labels.append(torch.stack([labels[b, i] for b, (i, _) in enumerate(sels)]))
        all_valid.append(torch.stack([v for _, v in sels]))

    return {"boxes": torch.cat(all_boxes, dim=1), "scores": torch.cat(all_scores, dim=1),
            "labels": torch.cat(all_labels, dim=1), "valid": torch.cat(all_valid, dim=1)}
