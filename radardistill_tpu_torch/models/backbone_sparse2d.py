"""Dense residual block of the PillarRes18 backbone (NHWC, eval).

Counterpart of ``radardistill_tpu/models/backbone_sparse2d.py::DenseBasicBlock``
(float path; the int8 and fused-block variants serve the LiDAR teacher and
are not in this slice).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BN_EPS_BACKBONE, BatchNormTorch, Conv2dTorch


class DenseBasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + identity -> ReLU (conv5 stage)."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True)
        self.bn1 = BatchNormTorch(features, BN_EPS_BACKBONE)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True)
        self.bn2 = BatchNormTorch(features, BN_EPS_BACKBONE)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)
