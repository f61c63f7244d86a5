"""PillarRes18 backbone, active-site formulation, host rulebooks.

Counterpart of ``radardistill_tpu/models/backbone_as.py::PillarRes18BackBone8xAS``
with ``DENSE_FROM = 5``: stages 1-4 run on fixed-capacity site tables
(B, cap, C) through the host-built tap tables, conv4's table is densified
(K5) into the (B, H/8, W/8, 256) map, and conv5 runs dense. Submodule names
mirror the flax scopes (``conv1_0/conv1/conv``, ``conv2_down/bn``, ...).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..caps import DEFAULT_CAPS, stage_caps
from ..ops import active_site as asx
from .backbone_sparse2d import DenseBasicBlock
from .layers import BN_EPS_BACKBONE, BatchNormTorch, Conv2dTorch, ConvParams, MaskedBatchNorm


class ASConv(nn.Module):
    """3x3 active-site conv; weight (O, I, 3, 3) under ``conv``."""

    def __init__(self, in_ch, features, use_bias=False):
        super().__init__()
        self.conv = ConvParams(in_ch, features, 3, 1, use_bias)

    def forward(self, feats, tap):
        kernel = self.conv.weight.permute(2, 3, 1, 0)  # HWIO
        return asx.conv3x3_as_b(feats, tap, kernel, self.conv.bias)


class SparseBasicBlockAS(nn.Module):
    """Residual submanifold block on site tables."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = ASConv(features, features, True)
        self.bn1 = MaskedBatchNorm(features, BN_EPS_BACKBONE)
        self.conv2 = ASConv(features, features, True)
        self.bn2 = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, tap, valid):
        m = valid[..., None].to(x.dtype)
        y = torch.relu(self.bn1(self.conv1(x, tap))) * m
        y = self.bn2(self.conv2(y, tap))
        return torch.relu(y + x) * m


class SparseDownBlockAS(nn.Module):
    """Strided 3x3 sparse conv + BN + ReLU on site tables."""

    def __init__(self, in_ch, features):
        super().__init__()
        self.conv = ASConv(in_ch, features, False)
        self.bn = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, tap, new_valid):
        y = torch.relu(self.bn(self.conv(x, tap)))
        return y * new_valid[..., None].to(y.dtype)


class PillarRes18BackBone8xAS(nn.Module):
    """Input: pillar table feats (B, cap1, 32) + sorted site ids uids (B, cap1)
    (sentinel H*W) and the host tables of ``data/host_precompute.as_tables``.
    ``hw`` is the stride-1 (H, W); caps are clipped to each stage's area."""

    def __init__(self, hw: Tuple[int, int], caps=DEFAULT_CAPS, dense_from: int = 5):
        super().__init__()
        if dense_from != 5:
            raise NotImplementedError("the port runs DENSE_FROM=5 (the shipped configs)")
        self.hw = tuple(hw)
        self.caps = stage_caps(caps, self.hw)
        self.conv1_0 = SparseBasicBlockAS(32)
        self.conv1_1 = SparseBasicBlockAS(32)
        for stage, (cin, cout) in ((2, (32, 64)), (3, (64, 128)), (4, (128, 256))):
            self.add_module(f"conv{stage}_down", SparseDownBlockAS(cin, cout))
            self.add_module(f"conv{stage}_0", SparseBasicBlockAS(cout))
            self.add_module(f"conv{stage}_1", SparseBasicBlockAS(cout))
        self.conv5_down_conv = Conv2dTorch(256, 256, 3, 2, 1, use_bias=False)
        self.conv5_down_bn = BatchNormTorch(256, BN_EPS_BACKBONE)
        self.conv5_0 = DenseBasicBlock(256)
        self.conv5_1 = DenseBasicBlock(256)

    def forward(self, feats, uids, tables) -> Dict[str, torch.Tensor]:
        if tables is None:
            raise NotImplementedError("the port takes host-built tables (HostPrecompute)")
        h, w = self.hw
        if feats.shape[1] != self.caps[0]:
            raise ValueError(f"VFE table capacity {feats.shape[1]} != caps[0] {self.caps[0]}")
        valid = uids < h * w
        x = feats * valid[..., None].to(feats.dtype)
        tap = tables["tap1"]
        x = self.conv1_0(x, tap, valid)
        x = self.conv1_1(x, tap, valid)

        sh, sw = h, w
        overflow = torch.zeros((), dtype=torch.int32, device=feats.device)
        for stage in (2, 3, 4):
            cap_out = self.caps[stage - 1]
            cnt = tables["counts"][:, stage - 2]
            overflow = overflow + torch.clamp(cnt - cap_out, min=0).sum().to(torch.int32)
            sh, sw, uids = sh // 2, sw // 2, tables[f"uids{stage}"]
            valid = uids < sh * sw
            x = getattr(self, f"conv{stage}_down")(x, tables[f"dtap{stage}"], valid)
            tap = tables[f"tap{stage}"]
            x = getattr(self, f"conv{stage}_0")(x, tap, valid)
            x = getattr(self, f"conv{stage}_1")(x, tap, valid)

        out: Dict[str, torch.Tensor] = {}
        dense_x, dense_mask = asx.densify_batch(x, uids, (sh, sw))
        out["x_conv4"], out["mask4"] = dense_x, dense_mask
        y = torch.relu(self.conv5_down_bn(self.conv5_down_conv(dense_x)))
        y = self.conv5_0(y)
        out["x_conv5"] = self.conv5_1(y)
        out["as_overflow"] = overflow
        return out
