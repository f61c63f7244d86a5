"""Dataset templates (host side).

Reference: pcdet/datasets/dataset_distill.py (DatasetTemplate_Distill —
augment → class-filter → feature-encode → process pipeline, empty-GT
re-sampling :212-214, prediction-dict generation :61-108) and dataset.py
(single-modality twin).

The collate step differs fundamentally (fixed-capacity padding, see
collate.py); everything up to collation mirrors the reference's per-sample
pipeline.

The port's copy of ``radardistill_tpu/data/dataset.py`` (``DatasetTemplate``,
``SyntheticDataset``), line for line: its scenes come from the port's
``synthetic.make_scene`` and its metric from the port's
``nuscenes/eval_bridge.py``. The nuScenes datasets build on ``DatasetTemplate``
in ``nuscenes/dataset.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from .augmentor import DataAugmentor
from .collate import DEFAULT_CAPACITIES, collate_batch
from .point_feature_encoder import PointFeatureEncoderDistill
from .processor import DataProcessor
from .sampler import DataBaseSampler


class DatasetTemplate:
    """Base dataset: builds augmentor/encoder/processor from DATA_CONFIG.

    Subclasses implement __len__ and get_item_raw(index) returning a dict
    with points / radar_points / gt_boxes(7+C no class col) / gt_names.
    """

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.logger = logger
        self.root_path = Path(root_path or dataset_cfg.get("DATA_PATH", "."))
        self.point_cloud_range = np.asarray(dataset_cfg["POINT_CLOUD_RANGE"], np.float32)
        self._merge_all_iters_to_one_epoch = False
        self.total_epochs = 0

        self.point_feature_encoder = PointFeatureEncoderDistill(
            dataset_cfg.get("POINT_FEATURE_ENCODING", {})
        )

        self.data_augmentor = None
        if training and "DATA_AUGMENTOR" in dataset_cfg:
            db_sampler = None
            aug_cfgs = dataset_cfg["DATA_AUGMENTOR"]
            for a in aug_cfgs.get("AUG_CONFIG_LIST", []):
                if a["NAME"].startswith("gt_sampling"):
                    try:
                        db_sampler = DataBaseSampler(
                            self.root_path, a, self.class_names,
                            distill=a["NAME"].endswith("distill"), logger=logger,
                        )
                    except FileNotFoundError:
                        if logger:
                            logger.warning("GT database not found; gt_sampling disabled")
            self.data_augmentor = DataAugmentor(
                aug_cfgs, self.class_names, training, db_sampler, logger
            )

        self.data_processor = DataProcessor(
            dataset_cfg.get("DATA_PROCESSOR", []),
            self.point_cloud_range,
            training,
            self.point_feature_encoder.num_point_features,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.capacities = dict(DEFAULT_CAPACITIES, **dataset_cfg.get("CAPACITIES", {}))
        self.depth_downsample_factor = None

    @property
    def mode(self):
        return "train" if self.training else "test"

    def merge_all_iters_to_one_epoch(self, merge=True, epochs=None):
        self._merge_all_iters_to_one_epoch = merge
        self.total_epochs = epochs or 0

    # --- pipeline -----------------------------------------------------------

    @staticmethod
    def set_lidar_aug_matrix(data_dict):
        """Record the composed augmentation as a 4x4 matrix so original
        coordinates are recoverable (dataset_distill.py:134-156)."""
        m = np.eye(4)
        if data_dict.get("flip_x"):
            m[:3, :3] = np.diag([1, -1, 1]) @ m[:3, :3]
        if data_dict.get("flip_y"):
            m[:3, :3] = np.diag([-1, 1, 1]) @ m[:3, :3]
        if "noise_rot" in data_dict:
            a = data_dict["noise_rot"]
            rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
            m[:3, :3] = rot @ m[:3, :3]
        if "noise_scale" in data_dict:
            m[:3, :3] *= data_dict["noise_scale"]
        if "noise_translate" in data_dict:
            m[:3, 3] = np.asarray(data_dict["noise_translate"]).reshape(3)
        data_dict["lidar_aug_matrix"] = m
        return data_dict

    def prepare_data(self, data_dict, _depth=0):
        """dataset_distill.py:158-218 minus the torch/voxelization bits."""
        if self.training:
            assert "gt_boxes" in data_dict
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], bool
            )
            data_dict["gt_boxes_mask"] = gt_boxes_mask
            if self.data_augmentor is not None:
                data_dict = self.data_augmentor(data_dict)

        self.set_lidar_aug_matrix(data_dict)

        if data_dict.get("gt_boxes", None) is not None:
            sel = np.array([n in self.class_names for n in data_dict["gt_names"]], bool)
            data_dict["gt_boxes"] = data_dict["gt_boxes"][sel]
            data_dict["gt_names"] = data_dict["gt_names"][sel]
            cls_ids = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]], np.float32
            )
            data_dict["gt_boxes"] = np.concatenate(
                [data_dict["gt_boxes"], cls_ids[:, None]], axis=1
            )

        data_dict = self.point_feature_encoder(data_dict)
        data_dict = self.data_processor(data_dict)

        if self.training and len(data_dict["gt_boxes"]) == 0 and _depth < 20:
            rng = data_dict.get("_rng") or np.random
            return self[int(rng.randint(len(self)))]

        data_dict.pop("gt_names", None)
        data_dict.pop("gt_boxes_mask", None)
        return data_dict

    def collate(self, samples):
        return collate_batch(samples, self.capacities)

    # --- prediction output ---------------------------------------------------

    def generate_prediction_dicts(self, batch_host, final_box_dicts, output_path=None):
        """Fixed-shape device outputs -> per-sample numpy dicts
        (dataset_distill.py:61-108 contract: pred_boxes/pred_scores/pred_labels
        + name strings)."""
        boxes = np.asarray(final_box_dicts["boxes"])
        scores = np.asarray(final_box_dicts["scores"])
        labels = np.asarray(final_box_dicts["labels"])
        valid = np.asarray(final_box_dicts["valid"])
        annos = []
        for i in range(boxes.shape[0]):
            v = valid[i]
            anno = {
                "pred_boxes": boxes[i][v],
                "pred_scores": scores[i][v],
                "pred_labels": labels[i][v].astype(np.int64),
            }
            anno["name"] = np.array(
                [self.class_names[int(l) - 1] for l in anno["pred_labels"]]
            )
            if batch_host is not None and "frame_id" in batch_host:
                anno["frame_id"] = batch_host["frame_id"][i]
            if batch_host is not None and "metadata" in batch_host:
                anno["metadata"] = batch_host["metadata"][i]
            annos.append(anno)
        return annos

    def __len__(self):
        raise NotImplementedError

    def get_item_raw(self, index):
        raise NotImplementedError

    def __getitem__(self, index):
        if self._merge_all_iters_to_one_epoch and len(self) > 0:
            index = index % len(self)
        data_dict = self.get_item_raw(index)
        return self.prepare_data(data_dict)


class SyntheticDataset(DatasetTemplate):
    """Synthetic scenes standing in for nuScenes (tests/bench; the reference's
    `_single` smoke-pkl role)."""

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, num_samples=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger)
        if num_samples is None:
            num_samples = int(dataset_cfg.get("NUM_SAMPLES", 8))
        self.num_samples = num_samples

    def __len__(self):
        return self.num_samples

    def evaluation(self, det_annos, class_names, **kwargs):
        """Internal center-distance AP against the (deterministic) synthetic
        GT — exercises the same fallback metric as the nuScenes path."""
        import numpy as np
        from .nuscenes.eval_bridge import center_distance_ap

        gt_boxes, gt_names, det_boxes, det_scores, det_names = [], [], [], [], []
        for det in det_annos:
            fid = det.get("frame_id", "synthetic_0")
            seed = int(str(fid).split("_")[-1])
            raw = self.get_item_raw(seed)
            gt_boxes.append(raw["gt_boxes"])
            gt_names.append(raw["gt_names"])
            det_boxes.append(det["pred_boxes"])
            det_scores.append(det["pred_scores"])
            det_names.append(det["name"])
        aps = center_distance_ap(gt_boxes, gt_names, det_boxes, det_scores, det_names, class_names)
        mean_aps = {c: float(np.mean(list(v.values()))) for c, v in aps.items()}
        mAP = float(np.mean(list(mean_aps.values()))) if mean_aps else 0.0
        result = "Synthetic internal AP\n" + "\n".join(
            f"{c}: {v:.4f}" for c, v in mean_aps.items()
        ) + f"\nmAP:\t {mAP:.4f}\n"
        return result, {"mAP": mAP}

    def get_item_raw(self, index):
        from .synthetic import make_scene

        scene = make_scene(
            index,
            num_lidar=self.dataset_cfg.get("SYN_NUM_LIDAR", 4000),
            num_radar=self.dataset_cfg.get("SYN_NUM_RADAR", 400),
            num_boxes=self.dataset_cfg.get("SYN_NUM_BOXES", 12),
            num_classes=len(self.class_names),
            pc_range=tuple(self.point_cloud_range),
        )
        boxes10 = scene["gt_boxes"]
        names = np.array([self.class_names[int(c) - 1] for c in boxes10[:, 9]])
        return {
            "points": scene["points"],
            "radar_points": scene["radar_points"],
            "gt_boxes": boxes10[:, :9],  # class col re-appended in prepare_data
            "gt_names": names,
            "frame_id": scene["frame_id"],
            "_rng": np.random.RandomState(index),
        }
