"""Point feature encoding (host side).

Reference: pcdet/datasets/processor/point_feature_encoder.py:74-150
(PointFeatureEncoder_Distill): lidar keeps [x,y,z,intensity,timestamp]
(absolute_coordinates_encoding), radar keeps [x,y,z,rcs,vx_comp,vy_comp]
(radar_absolute_coordinates_encoding); exposes the feature dims that size
the VFE input layer.

The port's copy of ``radardistill_tpu/data/point_feature_encoder.py``,
line for line.
"""

from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config):
        self.config = config
        self.used_feature_list = list(config.get("used_feature_list", ["x", "y", "z", "intensity", "timestamp"]))
        self.src_feature_list = list(config.get("src_feature_list", self.used_feature_list))

    @property
    def num_point_features(self):
        return len(self.used_feature_list)

    def encode(self, points: np.ndarray) -> np.ndarray:
        """absolute_coordinates_encoding: select used columns (xyz always first)."""
        if self.used_feature_list == self.src_feature_list:
            return points
        idx = [self.src_feature_list.index(f) for f in self.used_feature_list]
        return points[:, idx]


class PointFeatureEncoderDistill:
    """Dual-stream encoder: lidar + radar feature selection."""

    def __init__(self, config):
        self.lidar = PointFeatureEncoder(config)
        # reference config keys: radar_used_feature_list / radar_src_feature_list
        # (nuscenes_dataset_distill.yaml POINT_FEATURE_ENCODING)
        radar_cfg = {
            "used_feature_list": list(
                config.get("radar_used_feature_list", ["x", "y", "z", "rcs", "vx", "vy"])
            ),
            "src_feature_list": list(
                config.get("radar_src_feature_list",
                           config.get("radar_used_feature_list", ["x", "y", "z", "rcs", "vx", "vy"]))
            ),
        }
        self.radar = PointFeatureEncoder(radar_cfg)

    @property
    def num_point_features(self):
        return self.lidar.num_point_features

    @property
    def radar_num_point_features(self):
        return self.radar.num_point_features

    def __call__(self, data_dict):
        if "points" in data_dict:
            data_dict["points"] = self.lidar.encode(data_dict["points"])
        if "radar_points" in data_dict:
            data_dict["radar_points"] = self.radar.encode(data_dict["radar_points"])
        return data_dict
