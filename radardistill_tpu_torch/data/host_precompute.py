"""Host-side batch precompute for the radar branch (numpy, no JAX).

Twin of ``radardistill_tpu.data.host_precompute.HostPrecompute`` for the
radar-only configuration. It reuses that module's jax-free functions
(``pillar_encode``, the C++ pillar sort; ``as_tables``, the C++ rulebook
build) and differs in one place: the uint16 rulebooks that ``as_tables``
ships for transfer bandwidth are widened to int32 here, because PyTorch
indexes with int32/int64.
"""

from __future__ import annotations

import numpy as np

from radardistill_tpu.data.host_precompute import as_tables, pillar_encode

from ..caps import as_caps


class HostPrecompute:
    """Batch transform adding ``hp_radar`` (sorted points, pillar table
    slots, unique pillar ids, counts, cluster means) and ``hp_as`` (per-stage
    active sets and tap tables) to a collated fixed-shape batch."""

    def __init__(self, model_cfg, grid_size, voxel_size, point_cloud_range):
        if "VFE" in model_cfg:
            raise NotImplementedError("the port precomputes the radar branch only")
        bk = model_cfg["RADAR_BACKBONE_3D"]
        self.grid_size = (int(grid_size[0]), int(grid_size[1]))
        self.voxel_size = tuple(voxel_size)
        self.pc_range = tuple(point_cloud_range)
        self.caps = as_caps(bk, self.grid_size)
        self.dense_from = int(bk.get("DENSE_FROM", 3))

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
        # radar-only eval datasets carry the radar returns in `points`
        key = "radar_points" if "radar_points" in batch else "points"
        pts, msk, pre = pillar_encode(batch[key], batch[f"{key}_mask"], self.pc_range,
                                      self.voxel_size, self.grid_size, self.caps[0])
        batch[key], batch[f"{key}_mask"] = pts, msk
        batch["hp_radar"] = self._drop_ids(pre, self.caps[0], pts.shape[1])
        tables = as_tables(pre["uids"], (ny, nx), self.caps, self.dense_from)
        batch["hp_as"] = {
            k: tuple(a.astype(np.int32) if a.dtype == np.uint16 else a for a in v)
            if isinstance(v, tuple) else v
            for k, v in tables.items()
        }
        return batch
