"""Eval loop + recall instrumentation.

Reference: tools/eval_utils/eval_utils.py:27-162 (batch -> model -> recall
stats -> prediction dicts -> dataset.evaluation) and
detector3d_template.generate_recall_record (:367-409: rcnn recall at IoU
thresholds vs GT).

Counterpart of ``radardistill_tpu/train/eval_utils.py``: the model emits
fixed-shape ``final_box_dicts``; recall is computed on the host with the
port's C++ 3D-IoU op (``data/host_ops.py``). Under data parallelism each
rank evaluates its slice of the data; the caller gathers the detections
(``parallel.multihost.gather_detections``) before the dataset's evaluation.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..data.host_ops import boxes_iou_3d


def update_recall_record(recall_dict, pred_boxes, gt_boxes, thresh_list):
    """pred_boxes: (P, 7+) valid rows; gt_boxes: (G, 7+) valid rows."""
    if recall_dict == {}:
        recall_dict = {"gt": 0}
        for t in thresh_list:
            recall_dict[f"recall_rcnn_{t}"] = 0
    g = len(gt_boxes)
    recall_dict["gt"] += g
    if g == 0:
        return recall_dict
    if len(pred_boxes) == 0:
        return recall_dict
    iou = boxes_iou_3d(np.asarray(pred_boxes), np.asarray(gt_boxes))
    best = iou.max(axis=0)
    for t in thresh_list:
        recall_dict[f"recall_rcnn_{t}"] += int((best > t).sum())
    return recall_dict


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def eval_one_epoch(
    eval_step,
    dataloader,
    dataset,
    logger=None,
    thresh_list=(0.3, 0.5, 0.7),
    infer_time: bool = False,
    similarity_engines=None,
):
    """``eval_step(batch) -> outputs`` (``train_step.make_eval_step``) over
    the (batch, host_meta) pairs of ``dataloader``; each batch's outputs
    also feed the ``similarity_engines`` (``utils.similarity``). Returns
    (det_annos, recall_dict, timing)."""
    det_annos = []
    recall_dict: Dict = {}
    t_infer = []
    n_samples = 0
    seen_frames = set()  # fixed-shape batches wrap the tail (loader.py:82-84)

    for batch, host in dataloader:
        t0 = time.perf_counter()
        out = eval_step(batch)
        fb = _numpy(out["final_box_dicts"])  # the readback waits for the forward
        if infer_time:
            t_infer.append(time.perf_counter() - t0)

        for eng in similarity_engines or []:
            eng.process_batch(out, batch)

        annos = dataset.generate_prediction_dicts(host, fb)
        gt = _numpy(batch["gt_boxes"]) if "gt_boxes" in batch else None
        for i, anno in enumerate(annos):
            # dedup wrap-padded samples by frame id so recall counters and
            # downstream AP see each frame once (the reference instead uses
            # a non-padding eval sampler, pcdet/datasets/__init__.py:41-61)
            fid = anno.get("frame_id")
            if fid is not None:
                if fid in seen_frames:
                    continue
                seen_frames.add(fid)
            det_annos.append(anno)
            n_samples += 1
            if gt is None:
                continue
            gt_valid = gt[i][gt[i][:, -1] > 0]
            v = fb["valid"][i]
            recall_dict = update_recall_record(
                recall_dict, fb["boxes"][i][v][:, :7], gt_valid[:, :7], thresh_list
            )

    if logger and recall_dict.get("gt", 0) > 0:
        for t in thresh_list:
            r = recall_dict[f"recall_rcnn_{t}"] / max(recall_dict["gt"], 1)
            logger.info(f"recall_rcnn_{t}: {r:.4f}")
    timing = {
        "p50_ms": float(np.median(t_infer) * 1e3) if t_infer else None,
        "samples": n_samples,
    }
    return det_annos, recall_dict, timing
