"""Host-side batch precompute (numpy + the C++ ``host_ops``, no JAX).

The port's copy of ``radardistill_tpu/data/host_precompute.py``:
``pillar_encode`` (the C++ pillar sort), ``as_tables`` (the C++ rulebook
build), ``mask_pyramid`` and the ``HostPrecompute`` batch transform, for the
sparse-table consumers: an active-site backbone (the radar student's, or an
``_AS`` LiDAR teacher's) and the table-input space-to-depth LiDAR teacher. A
branch with a dense VFE (``pillarnet.yaml``, ``pillarnet_radar.yaml``) gets
no tables: its VFE sorts the points on the device. It differs from the
original in one place: the uint16 rulebooks that ``as_tables`` ships are
widened to int32 in ``HostPrecompute``, because PyTorch indexes with
int32/int64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..caps import as_caps, is_as, is_table_s2d
from ..utils.bitpack import pack_bool_np
from . import host_ops


def pillar_encode(points: np.ndarray, mask: np.ndarray, pc_range, voxel_size,
                  grid_size: Tuple[int, int], capacity: int,
                  packed: bool = False):
    """Sort points by pillar id + compact-unique into a fixed-cap table.

    f32 floor((xy - range)/voxel), sentinel = nx*ny for invalid/out-of-range,
    stable sort, first-occurrence slots, overflow slots == capacity. The
    per-sample work runs in C++ (host_ops.pillar_sort_encode). ``packed``
    sorts by the space-to-depth packed key (id values stay linear); the key
    pairs rows and columns, so the grid must be even in both directions.

    Returns (points_sorted, mask_sorted, pre) where pre = dict(ids, slot,
    uids, count) ready to ship as batch inputs.
    """
    if packed and (int(grid_size[0]) % 2 or int(grid_size[1]) % 2):
        raise ValueError(f"packed pillar order needs an even grid, not {tuple(grid_size)}")
    b = points.shape[0]
    outs = [
        host_ops.pillar_sort_encode(points[i], mask[i], pc_range, voxel_size,
                                    grid_size, capacity, packed)
        for i in range(b)
    ]
    pts_s = np.stack([o[0] for o in outs])
    mask_s = np.stack([o[1] for o in outs])
    pre = {
        "ids": np.stack([o[2] for o in outs]),
        "slot": np.stack([o[3] for o in outs]),
        "uids": np.stack([o[4] for o in outs]),
        "count": np.asarray([o[5] for o in outs], np.int32),
        "mean": np.stack([o[6] for o in outs]),
    }
    return pts_s, mask_s, pre


def as_tables(uids1: np.ndarray, hw: Tuple[int, int], caps, dense_from: int):
    """Per-stage AS rulebooks for a batch of stage-1 active sets.

    Mirrors the JAX package's device build exactly: subm taps for
    stages 1..dense_from-1, down taps + new active sets entering stages
    2..dense_from-1, plus the true (pre-cap) down counts for the overflow
    counter. All arrays batched on axis 0.
    """
    b = uids1.shape[0]
    h, w = hw
    caps = [min(int(c), (h // s) * (w // s)) for c, s in zip(caps, (1, 2, 4, 8))]
    # index values are table slots bounded by the static caps (nb in
    # [0, cap_in] incl. the junk sentinel; inv clipped to [0, cap_out-1]):
    # uint16 when every cap fits, as the JAX package ships them
    narrow = max(caps) + 2 < (1 << 16)

    def tap_batch(out_uids, in_uids, h_in, w_in, out_w, stride):
        outs = [host_ops.as_build_tap(out_uids[i], in_uids[i], h_in, w_in,
                                      out_w, stride) for i in range(b)]
        stacked = [np.stack([o[j] for o in outs]) for j in range(4)]
        if narrow:
            stacked = [a.astype(np.uint16) if a.dtype == np.int32 else a
                       for a in stacked]
        return tuple(stacked)

    tables: Dict[str, object] = {}
    tables["tap1"] = tap_batch(uids1, uids1, h, w, w, 1)
    uids, sh, sw, cap_in = uids1, h, w, caps[0]
    counts = []
    for stage in (2, 3, 4):
        if stage >= dense_from:
            break
        cap_out = caps[stage - 1]
        new_list = [host_ops.as_downsample(uids[i], sh, sw, cap_out) for i in range(b)]
        new_uids = np.stack([u for u, _ in new_list])
        counts.append(np.asarray([c for _, c in new_list], np.int32))
        tables[f"dtap{stage}"] = tap_batch(new_uids, uids, sh, sw, sw // 2, 2)
        sh, sw, cap_in, uids = sh // 2, sw // 2, cap_out, new_uids
        tables[f"uids{stage}"] = new_uids
        tables[f"tap{stage}"] = tap_batch(uids, uids, sh, sw, sw, 1)
    tables["counts"] = (
        np.stack(counts, 1) if counts else np.zeros((b, 0), np.int32)
    )
    return tables


def mask_pyramid(uids: np.ndarray, hw: Tuple[int, int], n_levels: int = 3):
    """Dilated occupancy masks for the strided stages, from the stage-1
    active set: level k = max_pool_mask(level k-1, 3, 2, 1) — the strided
    SparseConv2d's active-set growth (models/layers.py::max_pool_mask), as 9
    numpy slice-ORs per level. Returns a tuple of (B, H/2^k, ceil(W/2^k/8))
    uint8 maps, k = 1..n_levels, bit-packed along W."""
    h, w = hw
    b = uids.shape[0]
    m = np.zeros((b, h * w + 1), bool)
    np.put_along_axis(m, np.minimum(uids, h * w), True, axis=1)
    m = m[:, :h * w].reshape(b, h, w)
    out = []
    for _ in range(n_levels):
        hh, ww = m.shape[1], m.shape[2]
        p = np.zeros((b, hh + 2, ww + 2), bool)
        p[:, 1:-1, 1:-1] = m
        nxt = np.zeros((b, hh // 2, ww // 2), bool)
        for dy in range(3):
            for dx in range(3):
                np.logical_or(
                    nxt, p[:, dy:dy + hh:2, dx:dx + ww:2], out=nxt)
        m = nxt
        out.append(m)
    # bit-pack along W (8x fewer bytes to the card); the backbone unpacks
    # with utils/bitpack.unpack_bool
    return tuple(pack_bool_np(m) for m in out)


def _widen(tables: dict) -> dict:
    """The uint16 rulebooks of ``as_tables`` as int32."""
    return {k: tuple(a.astype(np.int32) if a.dtype == np.uint16 else a for a in v)
            if isinstance(v, tuple) else v for k, v in tables.items()}


class HostPrecompute:
    """Batch transform adding the host-built inputs to a collated fixed-shape
    batch: ``hp_lidar`` for a table-input LiDAR teacher (sorted points, pillar
    table slots, unique pillar ids, counts, cluster means) with ``hp_masks``
    for the S2D teacher (the strided stages' occupancy masks, bit-packed) or
    ``hp_as_lidar`` for an ``_AS`` teacher (its per-stage active sets and tap
    tables), and ``hp_radar`` + ``hp_as`` for the radar active-site backbone
    (the same pillar tables and tap tables). A no-op for the branches with a
    dense VFE."""

    def __init__(self, model_cfg, grid_size, voxel_size, point_cloud_range):
        self.grid_size = (int(grid_size[0]), int(grid_size[1]))
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(point_cloud_range)

        self.lidar_cap: Optional[int] = None
        self.lidar_packed = False
        self.lidar_as: Optional[dict] = None
        bk = model_cfg.get("BACKBONE_3D", {}) if "VFE" in model_cfg else {}
        if is_as(bk):
            caps = as_caps(bk, self.grid_size)
            self.lidar_cap = caps[0]
            self.lidar_as = {"caps": caps, "dense_from": int(bk.get("DENSE_FROM", 3))}
        elif is_table_s2d(bk):
            self.lidar_cap = int(bk.get("TABLE_CAPACITY", 163840))
            # must match the model wiring (models/detector.py PACKED_TABLE default)
            self.lidar_packed = bool(bk.get("PACKED_TABLE", True))

        self.radar_cap: Optional[int] = None
        rbk = model_cfg.get("RADAR_BACKBONE_3D", {}) if "RADAR_VFE" in model_cfg else {}
        if is_as(rbk):
            self.caps = as_caps(rbk, self.grid_size)
            self.radar_cap = self.caps[0]
            self.dense_from = int(rbk.get("DENSE_FROM", 3))

    @staticmethod
    def _drop_ids(pre: dict, capacity: int, n_points: int) -> dict:
        """Per-point pillar ids are not shipped when overflow is impossible
        (capacity >= n_points): the VFE rebuilds them exactly from the slots."""
        if capacity >= n_points:
            pre = dict(pre)
            pre.pop("ids")
        return pre

    def __call__(self, batch: dict) -> dict:
        nx, ny = self.grid_size
        if self.lidar_cap is not None and "points" in batch:
            pts, msk, pre = pillar_encode(
                batch["points"], batch["points_mask"], self.pc_range, self.voxel_size,
                self.grid_size, self.lidar_cap, packed=self.lidar_packed)
            batch["points"], batch["points_mask"] = pts, msk
            batch["hp_lidar"] = self._drop_ids(pre, self.lidar_cap, pts.shape[1])
            if self.lidar_as is not None:
                batch["hp_as_lidar"] = _widen(as_tables(
                    pre["uids"], (ny, nx), self.lidar_as["caps"], self.lidar_as["dense_from"]))
            else:
                batch["hp_masks"] = mask_pyramid(pre["uids"], (ny, nx), 3)
        # radar-only eval datasets carry the radar returns in `points`
        rkey = "radar_points" if "radar_points" in batch else (
            "points" if self.lidar_cap is None else None)
        if self.radar_cap is not None and rkey is not None and rkey in batch:
            pts, msk, pre = pillar_encode(batch[rkey], batch[f"{rkey}_mask"], self.pc_range,
                                          self.voxel_size, self.grid_size, self.radar_cap)
            batch[rkey], batch[f"{rkey}_mask"] = pts, msk
            batch["hp_radar"] = self._drop_ids(pre, self.radar_cap, pts.shape[1])
            batch["hp_as"] = _widen(as_tables(pre["uids"], (ny, nx), self.caps,
                                              self.dense_from))
        return batch
