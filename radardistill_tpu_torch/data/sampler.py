"""GT-database samplers (host side).

Reference: pcdet/datasets/augmentor/database_sampler_distill.py
(DataBaseSampler_Distill — paired lidar+radar object crops, :99-114 min-point
filters incl. `num_radar_points_in_gt>=1`, :216-250 round-robin sampling with
BEV-IoU collision rejection, :154-217 scene pasting removing scene points
inside enlarged sampled boxes) and database_sampler_radar.py
(filter_by_min_radar_points :113-128).

The BEV-IoU collision test runs through the native host op
(csrc/host_ops.cpp), replacing iou3d_nms_cuda.boxes_iou_bev_cpu.

The port's copy of ``radardistill_tpu/data/sampler.py``, line for line;
the collision test runs through the port's own ``host_ops``.
"""

from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from . import box_np


class DataBaseSampler:
    """Single- or dual-modality GT sampler. `distill=True` pastes paired
    lidar+radar crops (the RadarDistill path)."""

    def __init__(self, root_path, sampler_cfg, class_names, distill=True, logger=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.distill = distill
        self.num_point_features = sampler_cfg.get("NUM_POINT_FEATURES", 5)

        self.db_infos = {}
        for db_path in sampler_cfg["DB_INFO_PATH"]:
            p = self.root_path / db_path
            with open(p, "rb") as f:
                infos = pickle.load(f)
            for cls, lst in infos.items():
                self.db_infos.setdefault(cls, []).extend(lst)

        # integrated-database fast path (reference USE_SHARED_MEMORY +
        # DB_DATA_PATH, database_sampler_distill.py:70-85 / :169-178):
        # instead of SharedArray shm segments, mmap the packed .npy —
        # the page cache is shared by every dataloader worker process.
        self.db_data = self.db_data_radar = None
        if sampler_cfg.get("USE_SHARED_MEMORY", False):
            paths = list(sampler_cfg.get("DB_DATA_PATH", []))
            assert len(paths) >= 1, "USE_SHARED_MEMORY needs DB_DATA_PATH"
            self.db_data = np.load(str(self.root_path / paths[0]), mmap_mode="r")
            radar_p = (
                Path(paths[1]) if len(paths) > 1
                else Path(paths[0]).with_name(Path(paths[0]).stem + "_radar.npy")
            )
            if distill and (self.root_path / radar_p).exists():
                self.db_data_radar = np.load(
                    str(self.root_path / radar_p), mmap_mode="r"
                )
            if self.logger:
                self.logger.info(
                    f"GT-DB integrated array mmapped: {paths[0]} "
                    f"(radar: {self.db_data_radar is not None})"
                )

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        for x in sampler_cfg["SAMPLE_GROUPS"]:
            name, num = x.split(":")
            if name in class_names:
                self.sample_class_num[name] = int(num)
                self.sample_groups[name] = {
                    "sample_num": int(num),
                    "pointer": len(self.db_infos.get(name, [])),
                    "indices": np.arange(len(self.db_infos.get(name, []))),
                }

    # --- PREPARE filters ----------------------------------------------------

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                if self.distill:
                    kept = [
                        i for i in db_infos[name]
                        if i["num_points_in_gt"] >= min_num
                        and i.get("num_radar_points_in_gt", 1) >= 1
                    ]
                else:
                    kept = [i for i in db_infos[name] if i["num_points_in_gt"] >= min_num]
                if self.logger:
                    self.logger.info(
                        f"DB filter by min points {name}: {len(db_infos[name])} => {len(kept)}"
                    )
                db_infos[name] = kept
        return db_infos

    def filter_by_min_radar_points(self, db_infos, min_list):
        for name_num in min_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    i for i in db_infos[name]
                    if i.get("num_radar_points_in_gt", 0) >= min_num
                ]
        return db_infos

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        for key, dinfos in db_infos.items():
            db_infos[key] = [
                i for i in dinfos if i.get("difficulty", 0) not in removed_difficulty
            ]
        return db_infos

    # --- sampling -----------------------------------------------------------

    def sample_with_fixed_number(self, class_name, group, rng):
        n, ptr, idx = group["sample_num"], group["pointer"], group["indices"]
        if ptr >= len(self.db_infos[class_name]):
            idx = rng.permutation(len(self.db_infos[class_name]))
            ptr = 0
        out = [self.db_infos[class_name][i] for i in idx[ptr : ptr + n]]
        group["pointer"] = ptr + n
        group["indices"] = idx
        return out

    def _load_crop(self, info):
        if self.db_data is not None and "global_data_offset" in info:
            s, e = info["global_data_offset"]
            pts = np.array(self.db_data[s:e], np.float32)
        else:
            pts = np.fromfile(
                str(self.root_path / info["path"]), dtype=np.float32
            ).reshape(-1, self.num_point_features)
        radar = None
        if self.distill:
            if (self.db_data_radar is not None
                    and "radar_global_data_offset" in info):
                s, e = info["radar_global_data_offset"]
                radar = np.array(self.db_data_radar[s:e], np.float32)
            else:
                radar = np.fromfile(
                    str(self.root_path / info["radar_path"]), dtype=np.float32
                ).reshape(-1, 6)
        return pts, radar

    def __call__(self, data_dict):
        rng = data_dict.get("_rng") or np.random
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed = gt_boxes
        total_sampled = []

        for class_name, group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(class_name == gt_names))
                group["sample_num"] = self.sample_class_num[class_name] - num_gt
            if group["sample_num"] <= 0 or not self.db_infos.get(class_name):
                continue
            sampled = self.sample_with_fixed_number(class_name, group, rng)
            if not sampled:
                continue
            boxes = np.stack([x["box3d_lidar"] for x in sampled]).astype(np.float32)
            iou1 = box_np.boxes_iou_bev_cpu(boxes[:, :7], existed[:, :7])
            iou2 = box_np.boxes_iou_bev_cpu(boxes[:, :7], boxes[:, :7])
            np.fill_diagonal(iou2, 0)
            if iou1.shape[1] == 0:
                iou1 = iou2
            ok = ((iou1.max(axis=1) + iou2.max(axis=1)) == 0).nonzero()[0]
            total_sampled.extend(sampled[i] for i in ok)
            existed = np.concatenate([existed, boxes[ok]], axis=0)

        sampled_boxes = existed[len(gt_boxes):]
        if not total_sampled:
            return data_dict

        # paste crops into the scene
        mask = data_dict.get("gt_boxes_mask", np.ones(len(gt_boxes), bool))
        gt_boxes = gt_boxes[mask]
        gt_names = gt_names[mask]
        obj_pts, obj_radar = [], []
        for info in total_sampled:
            pts, radar = self._load_crop(info)
            pts[:, :3] += info["box3d_lidar"][:3]
            obj_pts.append(pts)
            if radar is not None:
                radar[:, :3] += info["box3d_lidar"][:3]
                obj_radar.append(radar)

        large = box_np.enlarge_box3d(
            sampled_boxes[:, :7], self.sampler_cfg.get("REMOVE_EXTRA_WIDTH", [0, 0, 0])
        )
        if "points" in data_dict:
            pts = box_np.remove_points_in_boxes3d(data_dict["points"], large)
            data_dict["points"] = np.concatenate([np.concatenate(obj_pts), pts])
        if self.distill and "radar_points" in data_dict and obj_radar:
            rp = box_np.remove_points_in_boxes3d(data_dict["radar_points"], large)
            data_dict["radar_points"] = np.concatenate([np.concatenate(obj_radar), rp])

        data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_boxes])
        data_dict["gt_names"] = np.concatenate(
            [gt_names, np.array([x["name"] for x in total_sampled])]
        )
        data_dict["gt_boxes_mask"] = np.ones(len(data_dict["gt_boxes"]), bool)
        return data_dict
