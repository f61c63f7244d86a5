"""Dynamic pillar VFEs: the point features reduced into a sorted pillar
table, and from it the dense BEV grid; and the mean VFE.

Counterpart of ``radardistill_tpu/models/vfe.py``:

- ``DynamicPillarVFESimple2D`` (the dense VFE of ``pillarnet.yaml`` and
  ``pillarnet_radar.yaml``, and its ``Radar_`` twins): ``encode_table`` at a
  capacity of one row per point (no pillar can overflow), then
  ``ops.active_site.densify_batch`` to the (B, H, W, C) grid and its
  (B, H, W) occupancy. On the card that densify is kernel K5, with its
  gather-formulated backward.
- ``DynamicPillarVFESparse``: the same encoder at a fixed capacity, emitting
  the table itself (``table`` (B, cap, C), ``uids`` (B, cap), ``count``
  (B,)): the front end of the active-site backbone (6 radar features, or an
  ``_AS`` LiDAR teacher) and of the space-to-depth teacher (5 features,
  capacity 163840, rows in space-to-depth packed order, ``packed_order``;
  the id values stay linear).
- ``DynamicPillarVFE``: the dense VFE with the original feature order
  ``[raw, f_cluster, f_center]`` (no ``f_relative``).
- ``MeanVFE``: the per-pillar mean of the raw point features, no parameters.
- ``PFNLayerV2`` and ``DynamicPillarVFESimple2D.build_point_features``: the
  JAX package's dense-grid formulation of the PFN layer (a per-pillar max
  over the whole (B, H, W, C) grid) and of the point features (the cluster
  means through the grid), which no model path calls; kept, as there, to
  hold the table formulation against.

The points arrive either sorted by the host with their slots, unique pillar
ids and cluster means (``pre``, the table VFEs only), or raw: then the device
computes the pillar ids, sorts the points (stable), compacts the unique ids
and takes the cluster means itself. ``PFNLayerV2Sparse`` reduces through a
segment max. Parameters are ``pfn_{i}`` with ``linear`` and ``norm`` in every
variant, as in the JAX tree. Point features are float32 (coordinate
precision); the pillar table leaves in the compute dtype. Layouts: points
(B, N, F), table (B, capacity, C). ``vfe_input_dim`` is the first linear's
input width.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import active_site as asx
from ..ops import voxelize
from ..utils.profiler import span
from .layers import Dense, MaskedBatchNorm


def vfe_input_dim(num_raw_features: int, cfg) -> int:
    """Width of the first PFN linear's input for a VFE config
    (dynamic_pillar_vfe.py:150-163): f_center, the raw features (without xyz
    unless ``USE_ABSLOTE_XYZ``), f_cluster, the distance, f_relative."""
    n = 3
    n += num_raw_features if cfg.get("USE_ABSLOTE_XYZ", True) else num_raw_features - 3
    if cfg.get("USE_CLUSTER_XYZ", True):
        n += 3
    if cfg.get("WITH_DISTANCE", False):
        n += 1
    if cfg.get("USE_RELATIVE_XYZ", True):
        n += 3
    return n


class PFNLayerV2Sparse(nn.Module):
    """Linear -> BN1d (over the valid points in train mode) -> ReLU ->
    per-pillar max into a (B, capacity, C) table (segment max through a junk
    row ``capacity`` that absorbs invalid and overflowed points). The gradient
    of the max is shared evenly among tied points (``scatter_reduce`` with
    ``amax``), as the reference's ``scatter_max`` shares it."""

    def __init__(self, in_channels, out_channels, use_norm=True, last_layer=False, dtype=None):
        super().__init__()
        self.last_layer, self.dtype = last_layer, dtype
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = Dense(in_channels, out_ch, use_bias=not use_norm)
        self.norm = MaskedBatchNorm(out_ch) if use_norm else None

    def forward(self, feats, slot, point_mask, capacity: int):
        x = self.linear(feats)
        if self.norm is not None:
            x = self.norm(x, point_mask)
        x = torch.relu(x)
        x = torch.where(point_mask[..., None], x, 0.0)
        if self.dtype is not None:
            x = x.to(self.dtype)
        b, n_pts, ch = x.shape
        cap1 = capacity + 1
        flat = (slot.long() + (torch.arange(b, device=slot.device) * cap1)[:, None]).reshape(-1)
        t = torch.full((b * cap1, ch), float("-inf"), dtype=x.dtype, device=x.device)
        t = t.scatter_reduce(0, flat[:, None].expand(-1, ch), x.reshape(-1, ch),
                             reduce="amax", include_self=True)
        t = torch.where(torch.isneginf(t), 0.0, t)
        table = t.reshape(b, cap1, ch)[:, :capacity]
        if self.last_layer:
            return x, table
        back = t[flat].reshape(b, n_pts, ch)
        back = torch.where((slot < capacity)[..., None], back, 0.0)
        return torch.cat([x, back], dim=-1), None


class PFNLayerV2(nn.Module):
    """Linear -> BN1d (over the valid points in train mode) -> ReLU ->
    per-pillar max on the dense grid: ``forward(feats (B, N, Ci), ids (B, N),
    point_mask (B, N), grid_size)`` -> ([x, the max gathered back] (B, N, C),
    None), or for the last layer (x, bev (B, H, W, C)); empty pillars are 0,
    the sentinel id H * W drops a point. Non-last layers halve
    ``out_channels``; parameters ``linear`` and ``norm`` as in
    ``PFNLayerV2Sparse``."""

    def __init__(self, in_channels, out_channels, use_norm=True, last_layer=False, dtype=None):
        super().__init__()
        self.last_layer, self.dtype = last_layer, dtype
        out_ch = out_channels if last_layer else out_channels // 2
        self.linear = Dense(in_channels, out_ch, use_bias=not use_norm)
        self.norm = MaskedBatchNorm(out_ch) if use_norm else None

    def forward(self, feats, ids, point_mask, grid_size):
        x = self.linear(feats)
        if self.norm is not None:
            x = self.norm(x, point_mask)
        x = torch.where(point_mask[..., None], torch.relu(x), 0.0)
        if self.dtype is not None:
            x = x.to(self.dtype)
        bev = voxelize.scatter_max_bev(x, ids, grid_size)
        if self.last_layer:
            return x, bev
        return torch.cat([x, voxelize.gather_from_bev(bev, ids)], dim=-1), None


class DynamicPillarVFESimple2D(nn.Module):
    """The dense VFE: ``forward(points, point_mask)`` -> (bev (B, H, W, C),
    pillar_mask (B, H, W) bool), through a pillar table of one row per point
    (:meth:`encode_table`) and one densify (K5 on the card)."""

    use_relative_xyz = True
    capacity = None  # the table's: one row per point, set per call
    stage = "vfe"  # the detector's stage, which names the child span of the table build

    def __init__(self, num_filters: Sequence[int], voxel_size, point_cloud_range,
                 grid_size: Tuple[int, int], num_point_features: int, use_norm=True,
                 with_distance=False, use_absolute_xyz=True, use_cluster_xyz=True, dtype=None,
                 packed_order=False):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_size = tuple(grid_size)
        self.with_distance = with_distance
        self.use_absolute_xyz = use_absolute_xyz
        self.use_cluster_xyz = use_cluster_xyz
        self.packed_order = packed_order
        in_ch = vfe_input_dim(num_point_features, {
            "USE_ABSLOTE_XYZ": use_absolute_xyz, "USE_CLUSTER_XYZ": use_cluster_xyz,
            "WITH_DISTANCE": with_distance, "USE_RELATIVE_XYZ": self.use_relative_xyz})
        self.n_layers = len(num_filters)
        self.output_dim = num_filters[-1]
        for i, out_ch in enumerate(num_filters):
            last = i >= self.n_layers - 1
            self.add_module(f"pfn_{i}", PFNLayerV2Sparse(in_ch, out_ch, use_norm, last, dtype))
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
        """[f_center, abs xyz + extras | extras, f_cluster, distance,
        f_relative], zero for invalid points."""
        xyz = points[..., 0:3]
        feats = [self._f_center(points, ids),
                 points if self.use_absolute_xyz else points[..., 3:]]
        if self.use_cluster_xyz:
            feats.append(xyz - mean)
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        pc0 = torch.tensor(self.point_cloud_range[:3], dtype=xyz.dtype, device=xyz.device)
        feats.append(xyz - pc0)
        out = torch.cat(feats, dim=-1)
        return torch.where(valid[..., None], out, 0.0)

    def build_point_features(self, points, valid, ids):
        """The point features of :meth:`_assemble_features` with each
        cluster mean taken through the dense grid (a scatter-sum, a count and
        a gather back, ``voxelize.pillar_mean_per_point``): the JAX package's
        dense-grid formulation, which no model path calls. points (B, N, F),
        valid (B, N), ids (B, N) -> (B, N, Ci)."""
        mean = (voxelize.pillar_mean_per_point(points[..., 0:3], ids, self.grid_size)
                if self.use_cluster_xyz else None)
        return self._assemble_features(points, valid, ids, mean)

    def _slot_mean(self, xyz, valid, slot, capacity):
        """Cluster mean of each point's pillar: a float32 ``index_add_`` of
        [xyz, 1] into a (B * (cap + 1), 4) table and a gather back. The
        reference takes the same sums with two segmented scans, so the means
        agree to summation order (about 1e-6 m). Points with slot ==
        capacity (invalid, or in a pillar beyond the capacity) share one junk
        row, as they share one trailing segment there."""
        b, n, _ = xyz.shape
        cap1 = capacity + 1
        xyz1 = torch.cat([torch.where(valid[..., None], xyz, 0.0),
                          valid[..., None].to(xyz.dtype)], dim=-1).reshape(b * n, 4)
        flat = (slot.long() + (torch.arange(b, device=slot.device) * cap1)[:, None]).reshape(-1)
        sums = torch.zeros((b * cap1, 4), dtype=xyz.dtype, device=xyz.device)
        total = sums.index_add_(0, flat, xyz1)[flat].reshape(b, n, 4)
        return total[..., :3] / total[..., 3:].clamp(min=1.0)

    def sort_and_compact(self, points, point_mask, capacity=None):
        """The device twin of ``data/host_precompute.pillar_encode``: points
        (B, N, F) in any order -> (points sorted by pillar id, or by the
        packed key under ``packed_order``; ``pre`` = dict(ids, slot, uids,
        count) with the host's values), at ``capacity`` rows (default: the
        module's). The sort is stable: the max's tie rule and the mean's
        summation order follow the point order."""
        capacity = self.capacity if capacity is None else capacity
        with span(f"{self.stage}.tables"):
            coords, in_range = voxelize.compute_pillar_coords(
                points[..., :2], self.point_cloud_range, self.voxel_size, self.grid_size)
            ids = voxelize.pillar_ids(coords, point_mask & in_range, self.grid_size)
            key = voxelize.packed_key(ids, self.grid_size) if self.packed_order else ids
            order = torch.sort(key, dim=-1, stable=True).indices
            ids = torch.gather(ids, 1, order)
            points = torch.gather(points, 1, order[..., None].expand(-1, -1, points.shape[-1]))
            nx, ny = self.grid_size
            uids, slot, count = asx.compact_unique_sorted(ids, capacity, nx * ny)
        return points, {"ids": ids, "slot": slot, "uids": uids, "count": count}

    def encode_table(self, points, point_mask, capacity: int, pre=None):
        """points (B, N, F) -> (table (B, capacity, C), uids, count). With
        ``pre`` = dict(slot, uids, count[, ids, mean]) they are already sorted
        by pillar id on the host and ``point_mask`` is implied by the sentinel
        ids. Without it the device builds the same table
        (:meth:`sort_and_compact`) and takes the cluster means itself.

        The host's mean and the device's agree only for points of pillars
        within the capacity: a point of an overflowed pillar gets its true
        pillar mean from the host but the merged junk-row mean here, and such
        points feed the BatchNorm statistics before the junk row is dropped.
        So train and eval must both use host tables or neither, unless
        ``as_overflow`` is 0 for the capacities in use."""
        nx, ny = self.grid_size
        sent = nx * ny
        if pre is None:
            points, pre = self.sort_and_compact(points, point_mask, capacity)
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
        mean = None
        if self.use_cluster_xyz:
            mean = (pre["mean"].to(points.dtype) if "mean" in pre
                    else self._slot_mean(points[..., 0:3], valid, slot, capacity))
        feats = self._assemble_features(points, valid, ids, mean)
        table = None
        for i in range(self.n_layers):
            feats, table = getattr(self, f"pfn_{i}")(feats, slot, valid, capacity)
        return table, uids, count

    def forward(self, points, point_mask):
        table, uids, _ = self.encode_table(points, point_mask, points.shape[1])
        nx, ny = self.grid_size
        return asx.densify_batch(table, uids, (ny, nx))


class DynamicPillarVFESparse(DynamicPillarVFESimple2D):
    """The encoder at a fixed ``capacity``, emitting the sorted pillar table
    (feats (B, cap, C), uids (B, cap), count (B,)) from host-precomputed
    inputs (``pre``) or from the raw points."""

    def __init__(self, *args, capacity: int, **kwargs):
        super().__init__(*args, **kwargs)
        self.capacity = capacity

    def forward(self, points, point_mask, pre=None):
        return self.encode_table(points, point_mask, self.capacity, pre)


class DynamicPillarVFE(DynamicPillarVFESimple2D):
    """The dense VFE with the original feature order ``[raw (abs xyz +
    extras | extras), f_cluster, f_center, distance]`` and no
    ``f_relative``."""

    use_relative_xyz = False

    def _assemble_features(self, points, valid, ids, mean):
        xyz = points[..., 0:3]
        feats = [points if self.use_absolute_xyz else points[..., 3:], xyz - mean,
                 self._f_center(points, ids)]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        return torch.where(valid[..., None], torch.cat(feats, dim=-1), 0.0)


class MeanVFE(nn.Module):
    """The per-pillar mean of the raw point features into the dense grid
    (``scatter_sum_bev / pillar_count``), no parameters: ``forward(points,
    point_mask)`` -> (bev (B, H, W, F), pillar_mask (B, H, W) bool)."""

    def __init__(self, voxel_size, point_cloud_range, grid_size, num_point_features: int):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_size = tuple(grid_size)
        self.output_dim = num_point_features

    def forward(self, points, point_mask):
        coords, in_range = voxelize.compute_pillar_coords(
            points[..., :2], self.point_cloud_range, self.voxel_size, self.grid_size)
        valid = point_mask & in_range
        ids = voxelize.pillar_ids(coords, valid, self.grid_size)
        feats = torch.where(valid[..., None], points, 0.0)
        sums = voxelize.scatter_sum_bev(feats, ids, self.grid_size)
        cnt = voxelize.pillar_count(ids, self.grid_size)
        return sums / cnt.clamp(min=1.0)[..., None], cnt > 0


class PillarVFE(nn.Module):
    """The fixed-size pillar VFE of the anchor family (vfe/pillar_vfe.py):
    ``forward(voxels (B, V, P, F), voxel_num_points (B, V), voxel_coords (B,
    V, 3) int (z, y, x), -1 rows padding)`` -> (bev (B, H, W, C),
    pillar_mask (B, H, W) bool). Each point gets its pillar's cluster-mean
    and centre offsets, PFN layers (``pfn_{i}_linear``, ``pfn_{i}_norm``: a
    ``MaskedBatchNorm`` over the valid points) reduce with a max over the P
    points, and the pillars scatter into the grid with a max
    (``voxelize.scatter_max_bev``). Both maxima share their gradient evenly
    among tied values (``amax`` and ``scatter_reduce``), as the reference's
    do. The inputs are the data processor's ``transform_points_to_voxels``
    output, padded per sample."""

    def __init__(self, num_filters: Sequence[int], voxel_size, point_cloud_range,
                 grid_size: Tuple[int, int], num_point_features: int, use_norm=True,
                 with_distance=False, use_absolute_xyz=True):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_size = tuple(grid_size)
        self.with_distance, self.use_absolute_xyz = with_distance, use_absolute_xyz
        self.use_norm = use_norm
        in_ch = (num_point_features if use_absolute_xyz else num_point_features - 3) + 6
        in_ch += int(with_distance)
        self.n_layers = len(num_filters)
        self.output_dim = num_filters[-1]
        for i, out_ch in enumerate(num_filters):
            ch = out_ch if i == self.n_layers - 1 else out_ch // 2
            self.add_module(f"pfn_{i}_linear", Dense(in_ch, ch, use_bias=not use_norm))
            if use_norm:
                self.add_module(f"pfn_{i}_norm", MaskedBatchNorm(ch))
            in_ch = 2 * ch

    def forward(self, voxels, voxel_num_points, voxel_coords):
        b, v, p, f = voxels.shape
        vx, vy, vz = self.voxel_size[:3]
        x0, y0, z0 = self.point_cloud_range[:3]
        voxels = voxels.float()
        vmask = voxel_coords[..., 0] >= 0
        pmask = (torch.arange(p, device=voxels.device)[None, None, :]
                 < voxel_num_points[..., None]) & vmask[..., None]
        xyz = voxels[..., :3]
        n = torch.clamp(voxel_num_points[..., None, None].float(), min=1.0)
        mean = torch.sum(xyz * pmask[..., None], dim=2, keepdim=True) / n
        coords = voxel_coords.float()
        center = torch.stack([coords[..., 2] * vx + vx / 2 + x0, coords[..., 1] * vy + vy / 2 + y0,
                              coords[..., 0] * vz + vz / 2 + z0], dim=-1)[..., None, :]
        feats = [voxels if self.use_absolute_xyz else voxels[..., 3:], xyz - mean, xyz - center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        x = torch.where(pmask[..., None], torch.cat(feats, dim=-1), 0.0)
        for i in range(self.n_layers):
            y = getattr(self, f"pfn_{i}_linear")(x)
            if self.use_norm:
                y = getattr(self, f"pfn_{i}_norm")(y, pmask)
            y = torch.relu(y)
            y_max = torch.where(pmask[..., None], y, float("-inf")).amax(dim=2, keepdim=True)
            y_max = torch.where(torch.isneginf(y_max), 0.0, y_max)
            if i == self.n_layers - 1:
                pillar_feats = y_max[:, :, 0]
            else:
                x = torch.cat([torch.where(pmask[..., None], y, 0.0), y_max.expand_as(y)], dim=-1)
        nx, ny = self.grid_size
        ids = voxel_coords[..., 1].long() * nx + voxel_coords[..., 2].long()
        ids = torch.where(vmask, ids, nx * ny)
        bev = voxelize.scatter_max_bev(
            torch.where(vmask[..., None], pillar_feats, float("-inf")), ids, self.grid_size)
        return bev, voxelize.pillar_count(ids, self.grid_size) > 0
