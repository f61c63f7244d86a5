"""CMA densification hourglass (forward), NHWC.

Counterpart of ``radardistill_tpu/models/distill.py``: ``ConvNeXtBlock`` (with
the stride-2 DCNv2 downsample and its frozen ``down_bias``), ``DecoderBlock``,
``AggBlock`` and ``CMAHourglass``. The three downsamples are the slice's
three K2 sites (180²->90², 90²->45², 180²->90² at the 1440² grid). The
distillation losses are not ported yet. GELU is the exact erf form
(``F.gelu``'s default), as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import modulated_deform_conv
from .layers import GRN, BatchNormTorch, Conv2dTorch, ConvTranspose2dTorch, Dense, LayerNormTorch


class ConvNeXtBlock(nn.Module):
    """ConvNeXt-v2 block, optionally prefixed by the stride-2 DCNv2 downsample."""

    def __init__(self, dim: int, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        if downsample:
            # offset/mask head: conv3 s2 p1 -> 27 ch = 9 * (2 + 1)
            self.conv_offset_mask1 = Conv2dTorch(dim, 27, 3, 2, 1, use_bias=True)
            self.down_weight = nn.Parameter(torch.empty(3, 3, dim, dim))  # HWIO
            # the reference's ModulatedDeformConv(bias=False) still carries a
            # fixed (never trained) bias in its checkpoints
            self.down_bias = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.dwconv = Conv2dTorch(dim, dim, 7, 1, 3, use_bias=True, groups=dim)
        self.norm = LayerNormTorch(dim)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)

    def forward(self, x):
        if self.downsample:
            om = self.conv_offset_mask1(x)
            o1, o2, m = torch.split(om, 9, dim=-1)
            offset = torch.cat([o1, o2], dim=-1)  # read as [dy_k, dx_k] pairs
            x = modulated_deform_conv(x, offset, torch.sigmoid(m), self.down_weight,
                                      stride=2, padding=1)
            x = x + self.down_bias.to(x.dtype)
        identity = x
        x = self.norm(self.dwconv(x))
        x = self.grn(F.gelu(self.pwconv1(x)))
        return self.pwconv2(x) + identity


class DecoderBlock(nn.Module):
    """ConvTranspose2d(4, 2, 1) + BN + GELU."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.deconv = ConvTranspose2dTorch(dim, dim, 4, 2, 1, use_bias=True)
        self.bn = BatchNormTorch(dim)

    def forward(self, x):
        return F.gelu(self.bn(self.deconv(x)))


class AggBlock(nn.Module):
    """1x1 conv (2·dim -> dim) + BN + GELU."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.conv = Conv2dTorch(2 * dim, dim, 1, 1, 0, use_bias=True)
        self.bn = BatchNormTorch(dim)

    def forward(self, x):
        return F.gelu(self.bn(self.conv(x)))


class CMAHourglass(nn.Module):
    """The 3-stage densification hourglass. Returns
    (radar_spatial_features_8x_2, radar_spatial_features_8x_1)."""

    def __init__(self, dim: int = 256):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"encoder_{i}_0", ConvNeXtBlock(dim, downsample=True))
            self.add_module(f"encoder_{i}_1", ConvNeXtBlock(dim))
            self.add_module(f"decoder_{i}", DecoderBlock(dim))
            self.add_module(f"agg_{i}", AggBlock(dim))

    def forward(self, spatial_features):
        en_16x = self.encoder_1_1(self.encoder_1_0(spatial_features))
        de_8x = self.agg_1(torch.cat([self.decoder_1(en_16x), spatial_features], dim=-1))
        en_32x = self.encoder_2_1(self.encoder_2_0(en_16x))
        de_16x = self.agg_2(torch.cat(
            [self.decoder_2(en_32x), self.encoder_3_1(self.encoder_3_0(de_8x))], dim=-1))
        x = self.agg_3(torch.cat([self.decoder_3(de_16x), de_8x], dim=-1))
        return x, de_8x
