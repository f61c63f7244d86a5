"""CenterPoint multi-task head (merged-hidden form) and its decode + NMS.

Counterpart of ``radardistill_tpu/models/center_head.py``: ``HeadSpec``,
``StackedSubHead`` (its ``conv_0`` a dense conv on the shared features, its
``conv_out`` a grouped conv over the task heads — the JAX package's
block-diagonal kernel is exactly that), ``CenterHead`` with the merged hidden
layer (all subheads' conv_0 + BN + ReLU as one conv), and ``decode_and_nms``.
Inputs NHWC; predictions (B, H, W, n_heads, C) per subhead.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import nms
from .layers import BatchNormTorch, Conv2dTorch

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
        mean = torch.cat([b.running_mean for b in bns]).to(dt)
        var = torch.cat([b.running_var for b in bns]).to(dt)
        scale = torch.cat([b.weight for b in bns]).to(dt)
        bias = torch.cat([b.bias for b in bns]).to(dt)
        mul = torch.rsqrt(var + subs[0].bn_0.eps) * scale
        y = torch.relu((h - mean) * mul + bias)
        preds, c = {}, subs[0].conv_0.conv.weight.shape[0]
        for i, (name, sub) in enumerate(zip(self.sub_names, subs)):
            preds[name] = sub.tail(y[..., i * c:(i + 1) * c])
        return preds


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
