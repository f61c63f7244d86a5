"""The OpenPCDet map-to-BEV layers of the anchor family, NHWC.

Counterpart of ``radardistill_tpu/models/map_to_bev.py``: in the dense
formulation they are reshapes. ``HeightCompression`` folds a dense (B, H, W,
D, C) voxel tensor's depth into the channels; ``PointPillarScatter`` masks
the grid a VFE already scattered (the VFE emits the (B, H, W, C) grid and its
occupancy, which is what this stage produced in the reference).
"""

from __future__ import annotations

from torch import nn


class HeightCompression(nn.Module):
    """(B, H, W, D, C) dense voxel features -> (B, H, W, D*C) BEV."""

    def __init__(self, num_bev_features: int | None = None):
        super().__init__()
        self.num_bev_features = num_bev_features

    def forward(self, voxel_features_dense):
        b, h, w, d, c = voxel_features_dense.shape
        return voxel_features_dense.reshape(b, h, w, d * c)


class PointPillarScatter(nn.Module):
    """bev (B, H, W, C) times its pillar mask (B, H, W)."""

    def forward(self, bev, pillar_mask):
        return bev * pillar_mask[..., None].to(bev.dtype)
