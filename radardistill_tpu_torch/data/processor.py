"""Data processor queue (host side).

Reference: pcdet/datasets/processor/data_processor.py:16-347 — a
name-dispatched list of processing steps from YAML. The RadarDistill path
uses mask_points_and_boxes_outside_range (:80-96, incl. radar twin handling),
shuffle_points (:99-114), and transform_points_to_voxels_placeholder
(:116-124, grid-size computation only — voxelization itself happens
on-device in the VFE). sample_points / double_flip belong to other models.

The port's copy of ``radardistill_tpu/data/processor.py``, line for line.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from . import box_np


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training, num_point_features=5):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.grid_size = None
        self.voxel_size = None
        self.data_processor_queue = []
        for cfg in processor_configs:
            if cfg["NAME"] in ("transform_points_to_voxels_placeholder",
                               "transform_points_to_voxels"):
                getattr(self, cfg["NAME"])(config=cfg)  # fixes grid/voxel size
            self.data_processor_queue.append(
                partial(getattr(self, cfg["NAME"]), config=cfg)
            )

    # --- steps -------------------------------------------------------------

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return
        pr = self.point_cloud_range
        for key in ("points", "radar_points"):
            if key in data_dict:
                p = data_dict[key]
                keep = (
                    (p[:, 0] >= pr[0]) & (p[:, 0] <= pr[3])
                    & (p[:, 1] >= pr[1]) & (p[:, 1] <= pr[4])
                )
                data_dict[key] = p[keep]
        if config.get("REMOVE_OUTSIDE_BOXES", True) and self.training and "gt_boxes" in data_dict:
            keep = box_np.mask_boxes_outside_range(
                data_dict["gt_boxes"], pr, min_num_corners=config.get("min_num_corners", 1)
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][keep]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][keep]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return
        mode = "train" if self.training else "test"
        if config["SHUFFLE_ENABLED"][mode]:
            rng = data_dict.get("_rng") or np.random
            for key in ("points", "radar_points"):
                if key in data_dict:
                    idx = rng.permutation(len(data_dict[key]))
                    data_dict[key] = data_dict[key][idx]
        return data_dict

    def transform_points_to_voxels_placeholder(self, data_dict=None, config=None):
        if data_dict is None and config is not None:
            # called at build time to fix grid_size (data_processor.py:116-124)
            self.voxel_size = np.asarray(config["VOXEL_SIZE"], np.float32)
            grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
            self.grid_size = np.round(grid).astype(np.int64)
            return
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        """Full fixed-size voxelization (data_processor.py:142-229) — numpy
        replacement of the spconv Point2VoxelCPU3d generator. The RadarDistill
        path never uses it (the VFE is dynamic); provided for the config
        surface of fixed-pillar models (PillarVFE)."""
        if data_dict is None and config is not None:
            self.voxel_size = np.asarray(config["VOXEL_SIZE"], np.float32)
            grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]) / self.voxel_size
            self.grid_size = np.round(grid).astype(np.int64)
            return
        max_pts = config["MAX_POINTS_PER_VOXEL"]
        max_vox = config["MAX_NUMBER_OF_VOXELS"]["train" if self.training else "test"]

        def voxelize(points):
            coords = np.floor(
                (points[:, :3] - self.point_cloud_range[:3]) / self.voxel_size
            ).astype(np.int32)
            ok = np.all((coords >= 0) & (coords < self.grid_size), axis=1)
            points, coords = points[ok], coords[ok]
            key = (coords[:, 2] * self.grid_size[1] + coords[:, 1]) * self.grid_size[0] + coords[:, 0]
            order = np.argsort(key, kind="stable")
            key, points, coords = key[order], points[order], coords[order]
            uniq, starts, counts = np.unique(key, return_index=True, return_counts=True)
            n_vox = min(len(uniq), max_vox)
            voxels = np.zeros((n_vox, max_pts, points.shape[1]), points.dtype)
            vox_num = np.zeros(n_vox, np.int32)
            vox_coords = np.zeros((n_vox, 3), np.int32)
            for i in range(n_vox):
                n = min(counts[i], max_pts)
                voxels[i, :n] = points[starts[i] : starts[i] + n]
                vox_num[i] = n
                c = coords[starts[i]]
                vox_coords[i] = (c[2], c[1], c[0])  # (z, y, x) pcdet order
            return voxels, vox_coords, vox_num

        if "points" in data_dict:
            v, c, n = voxelize(data_dict["points"])
            data_dict.update(voxels=v, voxel_coords=c, voxel_num_points=n)
        if "radar_points" in data_dict:
            v, c, n = voxelize(data_dict["radar_points"])
            data_dict.update(radar_voxels=v, radar_voxel_coords=c, radar_voxel_num_points=n)
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        if data_dict is None:
            return
        n = config["NUM_POINTS"]["train" if self.training else "test"]
        pts = data_dict["points"]
        if n < len(pts):
            rng = data_dict.get("_rng") or np.random
            data_dict["points"] = pts[rng.choice(len(pts), n, replace=False)]
        return data_dict

    # --- running the queue -------------------------------------------------

    def forward(self, data_dict):
        for step in self.data_processor_queue:
            out = step(data_dict=data_dict)
            if out is not None:
                data_dict = out
        return data_dict

    def __call__(self, data_dict):
        return self.forward(data_dict)
