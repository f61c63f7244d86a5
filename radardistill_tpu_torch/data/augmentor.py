"""Data augmentor (host side) — distill-aware joint transforms.

Reference: pcdet/datasets/augmentor/data_augmentor.py (queue dispatch,
:27-37 disable_augmentation used by the late-epoch hook) and
augmentor_utils.py (geometry kernels: random_flip_distill_along_x :28,
global_rotation_distill :116, global_scaling_distill :161,
random_translation_distill).

The *_distill variants transform lidar points, radar points and gt boxes
with ONE shared random draw so both modalities stay registered.

The port's copy of ``radardistill_tpu/data/augmentor.py``, line for line.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from . import box_np


def _rot_boxes(boxes, angle):
    out = boxes.copy()
    out[:, :3] = box_np.rotate_points_along_z(out[:, :3], angle)
    out[:, 6] += angle
    if boxes.shape[1] > 7:  # velocities rotate too (augmentor_utils.py:116-158)
        c, s = np.cos(angle), np.sin(angle)
        vx, vy = out[:, 7].copy(), out[:, 8].copy()
        out[:, 7] = vx * c - vy * s
        out[:, 8] = vx * s + vy * c
    return out


class DataAugmentor:
    def __init__(self, augmentor_configs, class_names, training=True, db_sampler=None, logger=None):
        self.class_names = list(class_names)
        self.logger = logger
        self.db_sampler = db_sampler
        self.augmentor_configs = augmentor_configs
        aug_list = (
            augmentor_configs["AUG_CONFIG_LIST"]
            if isinstance(augmentor_configs, dict)
            else augmentor_configs
        )
        disable = (
            augmentor_configs.get("DISABLE_AUG_LIST", [])
            if isinstance(augmentor_configs, dict)
            else []
        )
        self.data_augmentor_queue = []
        for cfg in aug_list:
            if cfg["NAME"] in disable:
                continue
            self.data_augmentor_queue.append(partial(getattr(self, cfg["NAME"]), config=cfg))

    # --- gt sampling -------------------------------------------------------

    def gt_sampling_distill(self, data_dict=None, config=None):
        if data_dict is None or self.db_sampler is None:
            return data_dict
        return self.db_sampler(data_dict)

    gt_sampling = gt_sampling_distill  # single-modality path shares the impl

    # --- world transforms (joint lidar+radar+boxes) ------------------------

    def _rng(self, data_dict):
        return data_dict.get("_rng") or np.random

    def random_world_flip_distill(self, data_dict=None, config=None):
        if data_dict is None:
            return data_dict
        rng = self._rng(data_dict)
        for axis in config["ALONG_AXIS_LIST"]:
            skip = rng.choice([False, True])
            data_dict[f"flip_{'y' if axis == 'x' else 'x'}"] = not skip
            if skip:
                continue
            boxes = data_dict["gt_boxes"]
            if axis == "x":  # flip y (augmentor_utils.random_flip_along_x)
                boxes[:, 1] = -boxes[:, 1]
                boxes[:, 6] = -boxes[:, 6]
                if boxes.shape[1] > 7:
                    boxes[:, 8] = -boxes[:, 8]
                for key in ("points", "radar_points"):
                    if key in data_dict:
                        data_dict[key][:, 1] = -data_dict[key][:, 1]
            else:  # flip x
                boxes[:, 0] = -boxes[:, 0]
                boxes[:, 6] = -(boxes[:, 6] + np.pi)
                if boxes.shape[1] > 7:
                    boxes[:, 7] = -boxes[:, 7]
                for key in ("points", "radar_points"):
                    if key in data_dict:
                        data_dict[key][:, 0] = -data_dict[key][:, 0]
            data_dict["gt_boxes"] = boxes
        return data_dict

    random_world_flip = random_world_flip_distill

    def random_world_rotation_distill(self, data_dict=None, config=None):
        if data_dict is None:
            return data_dict
        rng = self._rng(data_dict)
        rot_range = config["WORLD_ROT_ANGLE"]
        angle = rng.uniform(rot_range[0], rot_range[1])
        for key in ("points", "radar_points"):
            if key in data_dict:
                data_dict[key][:, :3] = box_np.rotate_points_along_z(
                    data_dict[key][:, :3], angle
                )
        # radar velocity columns (vx_comp, vy_comp at 4:6) rotate with the world
        if "radar_points" in data_dict and data_dict["radar_points"].shape[1] >= 6:
            v = data_dict["radar_points"][:, 4:6]
            c, s = np.cos(angle), np.sin(angle)
            data_dict["radar_points"][:, 4] = v[:, 0] * c - v[:, 1] * s
            data_dict["radar_points"][:, 5] = v[:, 0] * s + v[:, 1] * c
        data_dict["gt_boxes"] = _rot_boxes(data_dict["gt_boxes"], angle)
        data_dict["noise_rot"] = angle
        return data_dict

    random_world_rotation = random_world_rotation_distill

    def random_world_scaling_distill(self, data_dict=None, config=None):
        if data_dict is None:
            return data_dict
        rng = self._rng(data_dict)
        lo, hi = config["WORLD_SCALE_RANGE"]
        if hi - lo < 1e-3:
            return data_dict
        scale = rng.uniform(lo, hi)
        for key in ("points", "radar_points"):
            if key in data_dict:
                data_dict[key][:, :3] *= scale
        boxes = data_dict["gt_boxes"]
        boxes[:, :6] *= scale
        if boxes.shape[1] > 7:
            boxes[:, 7:9] *= scale
        data_dict["noise_scale"] = scale
        return data_dict

    random_world_scaling = random_world_scaling_distill

    def random_world_translation_distill(self, data_dict=None, config=None):
        if data_dict is None:
            return data_dict
        rng = self._rng(data_dict)
        std = np.asarray(config["NOISE_TRANSLATE_STD"], np.float32)
        t = np.array([rng.normal(0, s) for s in std], np.float32)
        for key in ("points", "radar_points"):
            if key in data_dict:
                data_dict[key][:, :3] += t
        data_dict["gt_boxes"][:, :3] += t
        data_dict["noise_translate"] = t
        return data_dict

    random_world_translation = random_world_translation_distill

    # --- control -----------------------------------------------------------

    def disable_augmentation(self, augmentor_configs):
        """Swap the queue per DisableAugmentationHook
        (data_augmentor.py:27-37, train_utils.py:296-311)."""
        aug_list = augmentor_configs["AUG_CONFIG_LIST"]
        disable = augmentor_configs.get("DISABLE_AUG_LIST", [])
        self.data_augmentor_queue = []
        for cfg in aug_list:
            if cfg["NAME"] in disable:
                if self.logger:
                    self.logger.info(f"disabled augmentation: {cfg['NAME']}")
                continue
            self.data_augmentor_queue.append(partial(getattr(self, cfg["NAME"]), config=cfg))

    def forward(self, data_dict):
        for aug in self.data_augmentor_queue:
            data_dict = aug(data_dict=data_dict)
        # wrap headings into [-pi, pi) (dataset prepare_data convention)
        if "gt_boxes" in data_dict and len(data_dict["gt_boxes"]):
            h = data_dict["gt_boxes"][:, 6]
            data_dict["gt_boxes"][:, 6] = (h + np.pi) % (2 * np.pi) - np.pi
        return data_dict

    __call__ = forward
