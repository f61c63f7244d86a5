"""Dynamic pillar VFE, host-precomputed table path.

Counterpart of ``radardistill_tpu/models/vfe.py``: ``DynamicPillarVFESparse``
(``encode_table`` with host-sorted points, slots, unique pillar ids and the
host cluster mean) and ``PFNLayerV2Sparse``. It serves the radar student (6
point features) and the LiDAR teacher (5 features, capacity 163840): the row
order of the table is the host's, linear for the student and space-to-depth
packed for the teacher (``packed_order`` of the JAX module), while the id
values stay linear, so nothing here depends on it. Point features are float32
(coordinate precision); the pillar table leaves in the compute dtype.
Layouts: points (B, N, F), table (B, capacity, C).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import Dense, MaskedBatchNorm


class PFNLayerV2Sparse(nn.Module):
    """Linear -> BN1d (over the valid points in train mode) -> ReLU ->
    per-pillar max into a (B, capacity, C) table (segment max through a junk
    row ``capacity`` that absorbs invalid and overflowed points). The gradient
    of the max is shared evenly among tied points (``scatter_reduce`` with
    ``amax``), as the reference's ``scatter_max`` shares it."""

    def __init__(self, in_channels, out_channels, capacity, use_norm=True,
                 last_layer=False, dtype=None):
        super().__init__()
        self.capacity, self.last_layer, self.dtype = capacity, last_layer, dtype
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = Dense(in_channels, out_ch, use_bias=not use_norm)
        self.norm = MaskedBatchNorm(out_ch) if use_norm else None

    def forward(self, feats, slot, point_mask):
        x = self.linear(feats)
        if self.norm is not None:
            x = self.norm(x, point_mask)
        x = torch.relu(x)
        x = torch.where(point_mask[..., None], x, 0.0)
        if self.dtype is not None:
            x = x.to(self.dtype)
        b, n_pts, ch = x.shape
        cap1 = self.capacity + 1
        flat = (slot.long() + (torch.arange(b, device=slot.device) * cap1)[:, None]).reshape(-1)
        t = torch.full((b * cap1, ch), float("-inf"), dtype=x.dtype, device=x.device)
        t = t.scatter_reduce(0, flat[:, None].expand(-1, ch), x.reshape(-1, ch),
                             reduce="amax", include_self=True)
        t = torch.where(torch.isneginf(t), 0.0, t)
        table = t.reshape(b, cap1, ch)[:, : self.capacity]
        if self.last_layer:
            return x, table
        back = t[flat].reshape(b, n_pts, ch)
        back = torch.where((slot < self.capacity)[..., None], back, 0.0)
        return torch.cat([x, back], dim=-1), None


class DynamicPillarVFESparse(nn.Module):
    """Pillar encoder emitting a sorted pillar table (feats (B, cap, C), uids
    (B, cap), count (B,)) from host-precomputed inputs (``pre``)."""

    def __init__(self, num_filters: Sequence[int], voxel_size, point_cloud_range,
                 grid_size: Tuple[int, int], num_point_features: int, capacity: int,
                 use_norm=True, with_distance=False, use_absolute_xyz=True,
                 use_cluster_xyz=True, dtype=None):
        super().__init__()
        if with_distance:
            raise NotImplementedError("WITH_DISTANCE is not in the ported configs")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_size = tuple(grid_size)
        self.capacity = capacity
        self.use_absolute_xyz = use_absolute_xyz
        self.use_cluster_xyz = use_cluster_xyz
        in_ch = 3 + (num_point_features if use_absolute_xyz else num_point_features - 3)
        in_ch += 3 * int(use_cluster_xyz) + 3  # + f_cluster, f_relative
        self.n_layers = len(num_filters)
        for i, out_ch in enumerate(num_filters):
            last = i >= self.n_layers - 1
            self.add_module(f"pfn_{i}", PFNLayerV2Sparse(
                in_ch, out_ch, capacity, use_norm, last, dtype))
            in_ch = out_ch  # a non-last layer emits [x, max_back]: out_ch wide

    def _f_center(self, points, ids):
        vx, vy, vz = self.voxel_size[:3]
        x_off = vx / 2 + self.point_cloud_range[0]
        y_off = vy / 2 + self.point_cloud_range[1]
        z_off = vz / 2 + self.point_cloud_range[2]
        nx = self.grid_size[0]
        cx = (ids % nx).to(points.dtype)
        cy = (ids // nx).to(points.dtype)
        return torch.stack([
            points[..., 0] - (cx * vx + x_off),
            points[..., 1] - (cy * vy + y_off),
            points[..., 2] - z_off,
        ], dim=-1)

    def _assemble_features(self, points, valid, ids, mean):
        """[f_center, abs xyz + extras | extras, f_cluster, f_relative]."""
        xyz = points[..., 0:3]
        feats = [self._f_center(points, ids),
                 points if self.use_absolute_xyz else points[..., 3:]]
        if self.use_cluster_xyz:
            feats.append(xyz - mean)
        pc0 = torch.tensor(self.point_cloud_range[:3], dtype=xyz.dtype, device=xyz.device)
        feats.append(xyz - pc0)
        out = torch.cat(feats, dim=-1)
        return torch.where(valid[..., None], out, 0.0)

    def forward(self, points, point_mask, pre):
        """points (B, N, F) sorted by pillar id on the host; ``pre`` =
        dict(slot, uids, count, mean[, ids]). ``point_mask`` is implied by the
        sentinel ids and kept for the reference's signature."""
        del point_mask
        nx, ny = self.grid_size
        sent = nx * ny
        slot, uids, count = pre["slot"], pre["uids"], pre["count"]
        if "ids" in pre:
            ids = pre["ids"]
        else:
            # the host dropped per-point ids (capacity >= points, so no
            # overflow): every slot addresses its own pillar row, the junk
            # row holds the sentinel
            b, cap = uids.shape
            uids_z = torch.cat([uids, uids.new_full((b, 1), sent)], dim=1)
            flat = slot.long() + (torch.arange(b, device=slot.device) * (cap + 1))[:, None]
            ids = uids_z.reshape(-1)[flat]
        valid = ids < sent
        mean = pre["mean"].to(points.dtype) if self.use_cluster_xyz else None
        feats = self._assemble_features(points, valid, ids, mean)
        table = None
        for i in range(self.n_layers):
            feats, table = getattr(self, f"pfn_{i}")(feats, slot, valid)
        return table, uids, count
