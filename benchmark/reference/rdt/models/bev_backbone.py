"""Dense BEV necks, NHWC: ``ConvStack``, ``BaseBEVBackboneV2`` and
``BaseBEVBackboneV1``.

Counterpart of ``radardistill_tpu/models/bev_backbone.py``: the two-level
necks over x_conv4 @8x and x_conv5 @16x. V2 runs x_conv5 up to 8x and
concatenates it to x_conv4 before its level-0 stack (the level-0 deblock the
reference builds and discards is never built); V1 runs a stack on each level,
deconvolves both to 8x and concatenates them. Their BNs (eps 1e-3, momentum
0.01) follow ``nn.Module.training``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import (BN_EPS_BACKBONE, BN_MOM_BACKBONE, BatchNormTorch, Conv2dTorch,
                     ConvTranspose2dTorch)


class ConvStack(nn.Module):
    """[conv3(stride) + BN + ReLU] + layer_num x [conv3 p1 + BN + ReLU]."""

    def __init__(self, in_ch: int, features: int, layer_num: int, stride: int = 1):
        super().__init__()
        self.layer_num = layer_num
        self.conv_in = Conv2dTorch(in_ch, features, 3, stride, 1)
        self.bn_in = BatchNormTorch(features, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        for k in range(layer_num):
            self.add_module(f"conv_{k}", Conv2dTorch(features, features, 3, 1, 1))
            self.add_module(f"bn_{k}", BatchNormTorch(features, BN_EPS_BACKBONE, BN_MOM_BACKBONE))

    def forward(self, x):
        x = torch.relu(self.bn_in(self.conv_in(x)))
        for k in range(self.layer_num):
            x = torch.relu(getattr(self, f"bn_{k}")(getattr(self, f"conv_{k}")(x)))
        return x


class BaseBEVBackboneV2(nn.Module):
    """Returns (spatial_features_2d, spatial_features_2d_8x)."""

    def __init__(self, in_channels: Sequence[int] = (256, 256),
                 layer_nums: Sequence[int] = (5, 5),
                 num_filters: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2),
                 num_upsample_filters: Sequence[int] = (128, 128)):
        super().__init__()
        up_ch = num_upsample_filters[1] * 2
        s = upsample_strides[1]
        self.block1 = ConvStack(in_channels[1], num_filters[1], layer_nums[1])
        self.deblock1_deconv = ConvTranspose2dTorch(num_filters[1], up_ch, s, s, 0)
        self.deblock1_bn = BatchNormTorch(up_ch, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.block0 = ConvStack(in_channels[0] + up_ch, num_filters[0], layer_nums[0])

    def forward(self, x_conv4, x_conv5):
        x = self.block1(x_conv5)
        x8 = torch.relu(self.deblock1_bn(self.deblock1_deconv(x)))
        out = self.block0(torch.cat([x_conv4, x8], dim=-1))
        return out, x8


class BaseBEVBackboneV1(nn.Module):
    """Returns (concatenated deblocks, the x_conv5 level's deblock); the
    output has ``sum(num_upsample_filters)`` channels."""

    def __init__(self, in_channels: Sequence[int] = (256, 256),
                 layer_nums: Sequence[int] = (5, 5),
                 num_filters: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2),
                 num_upsample_filters: Sequence[int] = (128, 128)):
        super().__init__()
        for i in range(2):
            s = max(upsample_strides[i], 1)
            self.add_module(f"block{i}", ConvStack(in_channels[i], num_filters[i], layer_nums[i]))
            self.add_module(f"deblock{i}_deconv", ConvTranspose2dTorch(
                num_filters[i], num_upsample_filters[i], s, s, 0))
            self.add_module(f"deblock{i}_bn", BatchNormTorch(
                num_upsample_filters[i], BN_EPS_BACKBONE, BN_MOM_BACKBONE))

    def forward(self, x_conv4, x_conv5):
        ups = []
        for i, x in enumerate((x_conv4, x_conv5)):
            x = getattr(self, f"block{i}")(x)
            x = getattr(self, f"deblock{i}_deconv")(x)
            ups.append(torch.relu(getattr(self, f"deblock{i}_bn")(x)))
        return torch.cat(ups, dim=-1), ups[1]
