"""Fixed-capacity batch collation.

Reference: DatasetTemplate_Distill.collate_batch
(pcdet/datasets/dataset_distill.py:220-325) concatenates ragged per-sample
point arrays with a batch-index column and max-pads gt_boxes per batch.

The port's copy of ``radardistill_tpu/data/collate.py``: every array is
padded to a STATIC capacity, points (B, N_max, F) + bool mask, gt_boxes
(B, NUM_MAX_OBJS, D), so both packages see the same fixed-shape batch.
Capacities come from DATA_CONFIG.CAPACITIES.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

DEFAULT_CAPACITIES = {
    "MAX_LIDAR_POINTS": 180_000,
    "MAX_RADAR_POINTS": 8192,
    "NUM_MAX_OBJS": 500,
}


def pad_points(points: np.ndarray, capacity: int, rng: Optional[np.random.RandomState] = None):
    """(N, F) -> ((capacity, F), (capacity,) bool). Overflow policy: random
    subsample (keeps spatial coverage; the reference shuffles points anyway,
    data_processor.py:99-114)."""
    n, f = points.shape
    out = np.zeros((capacity, f), points.dtype)
    mask = np.zeros((capacity,), bool)
    if n > capacity:
        rng = rng or np.random.RandomState(0)
        sel = rng.choice(n, capacity, replace=False)
        out[:] = points[sel]
        mask[:] = True
    else:
        out[:n] = points
        mask[:n] = True
    return out, mask


def pad_boxes(boxes: np.ndarray, capacity: int):
    d = boxes.shape[-1]
    out = np.zeros((capacity, d), np.float32)
    m = min(len(boxes), capacity)
    out[:m] = boxes[:m]
    return out


def collate_batch(samples: List[Dict], capacities: Dict[str, int] | None = None, seed: int = 0):
    """samples: list of dicts with optional keys 'points', 'radar_points'
    (both (N, F) with NO batch column) and 'gt_boxes' (M, D). Returns the
    static-shape batch dict the model consumes."""
    caps = dict(DEFAULT_CAPACITIES, **(capacities or {}))
    rng = np.random.RandomState(seed)
    batch: Dict[str, np.ndarray] = {}

    if "points" in samples[0]:
        pts, masks = zip(*[pad_points(s["points"], caps["MAX_LIDAR_POINTS"], rng) for s in samples])
        batch["points"] = np.stack(pts)
        batch["points_mask"] = np.stack(masks)
    if "radar_points" in samples[0]:
        pts, masks = zip(*[pad_points(s["radar_points"], caps["MAX_RADAR_POINTS"], rng) for s in samples])
        batch["radar_points"] = np.stack(pts)
        batch["radar_points_mask"] = np.stack(masks)
    if "gt_boxes" in samples[0]:
        batch["gt_boxes"] = np.stack([pad_boxes(s["gt_boxes"], caps["NUM_MAX_OBJS"]) for s in samples])
    for k in ("frame_id", "metadata", "token"):
        if k in samples[0]:
            batch.setdefault("_host", {})[k] = [s[k] for s in samples]
    return batch
