"""nuScenes datasets (distill / radar / radar-test / plain).

Reference: pcdet/datasets/nuscenes/nuscenes_dataset_distill.py (info-pkl
loading :35-47, balanced resampling :49-84, lidar 10-sweep loader :86-119,
radar 5-sensor×6-sweep loader with ego-motion compensation :211-278,
__getitem__ :286-328, devkit eval bridge :330-384), nuscenes_dataset_radar.py
and nuscenes_dataset_test.py (radar-only variants; the test variant filters
GT by `num_radar_pts`), nuscenes_dataset.py (full lidar dataset + paired
GT-DB creation :426-500).

Radar .pcd parsing is devkit-free (pcd.py); the official mAP/NDS evaluation
still calls nuscenes-devkit when installed (eval_bridge.py) and falls back
to a self-contained BEV-AP metric otherwise.

The port's copy of ``radardistill_tpu/data/nuscenes/dataset.py``, line for
line, on the port's ``DatasetTemplate``: the items are the same numpy dicts,
so the loader, the collate step and ``HostPrecompute`` take them unchanged.
Like the rest of the port's host pipeline, the sweep choice and the
class-balanced resampling draw from numpy's global generator, which the
loader's workers and ``set_random_seed`` seed.
"""

from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ..dataset import DatasetTemplate
from . import pcd


class NuScenesDatasetDistill(DatasetTemplate):
    """Dual-modality (lidar + radar) dataset for distillation training."""

    LIDAR_SWEEPS = 10
    RADAR_SWEEPS = 6

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        self.infos = []
        self.include_nuscenes_data(self.mode)
        if self.training and dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)

    # --- info loading -------------------------------------------------------

    def include_nuscenes_data(self, mode):
        if self.logger:
            self.logger.info("Loading NuScenes dataset")
        infos = []
        for info_path in self.dataset_cfg["INFO_PATH"][mode]:
            p = self.root_path / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                infos.extend(pickle.load(f))
        self.infos.extend(infos)
        if self.logger:
            self.logger.info(f"Total samples for NuScenes dataset: {len(infos)}")

    def balanced_infos_resampling(self, infos):
        """Class-balanced resampling (CBGS, arXiv:1908.09492;
        nuscenes_dataset_distill.py:49-84)."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info["gt_names"]):
                if name in self.class_names:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        cls_dist = {k: len(v) / duplicated for k, v in cls_infos.items()}
        frac = 1.0 / len(self.class_names)
        ratios = [frac / max(v, 1e-9) for v in cls_dist.values()]
        sampled = []
        for cur, ratio in zip(cls_infos.values(), ratios):
            if cur:
                sampled += np.random.choice(cur, int(len(cur) * ratio)).tolist()
        if self.logger:
            self.logger.info(f"Total samples after balanced resampling: {len(sampled)}")
        return sampled

    # --- sweep loaders ------------------------------------------------------

    def _resolve(self, rel_path: str) -> Path:
        # the reference hardcodes its own data root inside stored paths
        # (nuscenes_dataset_distill.py:225); strip any absolute prefix
        rel = str(rel_path)
        for marker in ("samples/", "sweeps/"):
            if marker in rel:
                rel = rel[rel.index(marker):]
                break
        p = self.root_path / rel
        return p if p.exists() else self.root_path.parent / rel

    def get_sweep(self, sweep_info):
        def remove_ego_points(points, center_radius=1.0):
            keep = ~(
                (np.abs(points[:, 0]) < center_radius)
                & (np.abs(points[:, 1]) < center_radius)
            )
            return points[keep]

        path = self._resolve(sweep_info["lidar_path"])
        pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, 5)[:, :4]
        pts = remove_ego_points(pts).T
        if sweep_info.get("transform_matrix") is not None:
            n = pts.shape[1]
            pts[:3, :] = sweep_info["transform_matrix"].dot(
                np.vstack((pts[:3, :], np.ones(n)))
            )[:3, :]
        times = sweep_info["time_lag"] * np.ones((1, pts.shape[1]))
        return pts.T, times.T

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        path = self._resolve(info["lidar_path"])
        points = np.fromfile(str(path), dtype=np.float32).reshape(-1, 5)[:, :4]
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1))]
        n_avail = len(info.get("sweeps", []))
        if n_avail and max_sweeps > 1:
            for k in np.random.choice(n_avail, min(max_sweeps - 1, n_avail), replace=False):
                p, t = self.get_sweep(info["sweeps"][k])
                sweep_points.append(p)
                sweep_times.append(t)
        points = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(sweep_times, axis=0).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    def get_radar_with_sweeps(self, index, max_sweeps=6):
        """5 radar sensors × up to `max_sweeps` sweeps, all filters disabled,
        velocities rotated to the lidar frame and positions motion-compensated
        by velo_comp * Δt (nuscenes_dataset_distill.py:240-278)."""
        info = self.infos[index]
        out = []
        for _, sweeps in info["radars"].items():
            idxes = range(min(len(sweeps), max_sweeps))
            if not len(sweeps):
                continue
            ts = sweeps[0]["timestamp"] * 1e-6
            for idx in idxes:
                sweep = sweeps[idx]
                pts = pcd.load_radar_points(self._resolve(sweep["data_path"]))
                pts = pts.reshape(-1, 6).copy()
                time_diff = ts - sweep["timestamp"] * 1e-6

                velo = np.concatenate([pts[:, 4:6], np.zeros((len(pts), 1))], 1)
                velo = velo @ sweep["sensor2lidar_rotation"].T
                pts[:, 4:6] = velo[:, :2]
                pts[:, :3] = pts[:, :3] @ sweep["sensor2lidar_rotation"].T
                pts[:, :3] += sweep["sensor2lidar_translation"]
                pts[:, :2] += velo[:, :2] * time_diff
                out.append(pts)
        return np.concatenate(out, axis=0) if out else np.zeros((0, 6), np.float32)

    # --- item ---------------------------------------------------------------

    def __len__(self):
        if self._merge_all_iters_to_one_epoch:
            return len(self.infos) * self.total_epochs
        return len(self.infos)

    def _gt_from_info(self, info, input_dict):
        if "gt_boxes" not in info:
            return
        if self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", False):
            mask = info["num_lidar_pts"] > self.dataset_cfg["FILTER_MIN_POINTS_IN_GT"] - 1
        else:
            mask = np.ones(len(info["gt_boxes"]), bool)
        input_dict["gt_names"] = info["gt_names"][mask]
        input_dict["gt_boxes"] = info["gt_boxes"][mask]

    def get_item_raw(self, index):
        info = copy.deepcopy(self.infos[index])
        input_dict = {
            "points": self.get_lidar_with_sweeps(index, self.dataset_cfg.get("MAX_SWEEPS", self.LIDAR_SWEEPS)),
            "radar_points": self.get_radar_with_sweeps(index, self.RADAR_SWEEPS),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info["token"]},
        }
        self._gt_from_info(info, input_dict)
        return input_dict

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch:
            index = index % len(self.infos)
        data_dict = self.prepare_data(self.get_item_raw(index))
        if self.dataset_cfg.get("SET_NAN_VELOCITY_TO_ZEROS", False) and "gt_boxes" in data_dict:
            gb = data_dict["gt_boxes"]
            gb[np.isnan(gb)] = 0
            data_dict["gt_boxes"] = gb
        if not self.dataset_cfg.get("PRED_VELOCITY", True) and "gt_boxes" in data_dict:
            data_dict["gt_boxes"] = data_dict["gt_boxes"][:, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    # --- evaluation ---------------------------------------------------------

    def evaluation(self, det_annos, class_names, **kwargs):
        from .eval_bridge import evaluate_nuscenes

        return evaluate_nuscenes(
            self, det_annos, class_names,
            output_path=kwargs.get("output_path", "./eval_out"),
        )


class NuScenesDatasetRadar(NuScenesDatasetDistill):
    """Radar-only training dataset (student w/o teacher): `points` = radar
    (nuscenes_dataset_radar.py:285-324)."""

    def get_item_raw(self, index):
        info = copy.deepcopy(self.infos[index])
        input_dict = {
            "radar_points": self.get_radar_with_sweeps(index, self.RADAR_SWEEPS),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info["token"]},
        }
        self._gt_from_info(info, input_dict)
        return input_dict


class NuScenesDatasetRadarTest(NuScenesDatasetRadar):
    """Radar-only eval dataset; filters GT boxes by `num_radar_pts`
    (nuscenes_dataset_test.py:298-302)."""

    def _gt_from_info(self, info, input_dict):
        if "gt_boxes" not in info:
            return
        mask = np.ones(len(info["gt_boxes"]), bool)
        if "num_radar_pts" in info:
            mask &= info["num_radar_pts"] > 0
        input_dict["gt_names"] = info["gt_names"][mask]
        input_dict["gt_boxes"] = info["gt_boxes"][mask]


class NuScenesDataset(NuScenesDatasetDistill):
    """Plain lidar dataset (teacher training / test_teacher path)."""

    def get_item_raw(self, index):
        info = copy.deepcopy(self.infos[index])
        input_dict = {
            "points": self.get_lidar_with_sweeps(index, self.dataset_cfg.get("MAX_SWEEPS", 10)),
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info["token"]},
        }
        self._gt_from_info(info, input_dict)
        return input_dict
