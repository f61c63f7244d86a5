"""Masked-dense blocks of the PillarRes18 backbone (NHWC, float).

Counterpart of ``radardistill_tpu/models/backbone_sparse2d.py``:
``SparseDownBlock`` and ``SparseBasicBlock`` (exact sparse semantics on dense
tensors: a submanifold conv is a dense conv times the occupancy mask, a
strided sparse conv grows the active set to the dilated mask, which the
caller passes in) and ``DenseBasicBlock`` (conv5). The float branches only:
the int8 and fused-bf16 variants of stages 2-5 are not ported. The masked
blocks pass their mask to the BN, which reads it in train mode; the dense
block's BNs follow ``nn.Module.training`` on their own.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import (BN_EPS_BACKBONE, BN_MOM_BACKBONE, BatchNormTorch, Conv2dTorch,
                     MaskedBatchNorm)


class SparseDownBlock(nn.Module):
    """Strided SparseConv2d + BN1d + ReLU; ``new_mask`` (B, H/2, W/2) bool is
    the dilated occupancy of the output grid."""

    def __init__(self, in_ch, features):
        super().__init__()
        self.conv = Conv2dTorch(in_ch, features, 3, 2, 1, use_bias=False)
        self.bn = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, new_mask):
        y = torch.relu(self.bn(self.conv(x), new_mask))
        return y * new_mask[..., None].to(y.dtype)


class SparseBasicBlock(nn.Module):
    """Residual submanifold block: conv/bn/relu -> conv/bn -> +identity ->
    relu, all on the active set ``mask`` (B, H, W) bool. The convs carry a
    bias, as in the reference."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True)
        self.bn1 = MaskedBatchNorm(features, BN_EPS_BACKBONE)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True)
        self.bn2 = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, mask):
        m = mask[..., None].to(x.dtype)
        y = torch.relu(self.bn1(self.conv1(x), mask)) * m
        y = self.bn2(self.conv2(y), mask)
        return torch.relu(y + x) * m


class DenseBasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + identity -> ReLU (conv5 stage)."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True)
        self.bn1 = BatchNormTorch(features, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True)
        self.bn2 = BatchNormTorch(features, BN_EPS_BACKBONE, BN_MOM_BACKBONE)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)
