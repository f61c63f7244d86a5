"""Write a nuScenes-layout data tree of synthetic scenes at nuScenes' own
widths, and its info pkls, for runs of the port's nuScenes path without the
dataset: ``python3 tools/torch_nuscenes_tree.py DIR [--train 8 --val 4]``.

The tree is what ``data/nuscenes/info_gen.py`` and the devkit would leave
behind: ``samples/LIDAR_TOP/*.pcd.bin`` key frames (34 720 points of x, y, z,
intensity, ring in float32, a nuScenes sweep's size) with 9 earlier sweeps
each under ``sweeps/LIDAR_TOP/`` (their ego motion in ``transform_matrix``,
their ``time_lag``), 5 radar channels of 6 sweeps of about 100 returns each
in binary .pcd with the 18 fields of nuScenes' radar files (their mounts in
``sensor2lidar_rotation`` / ``translation``), 40-60 boxes a sample over the
10 classes, and ``nuscenes_infos_6radar_10sweeps_{train,val}.pkl`` written
directly (``tests/test_nuscenes_dataset.py`` writes its infos the same way).
About 46% of a sweep's points fall in the shipped range (±54 m), about
160 000 of a sample's ten sweeps, as ``bench.py`` sizes its scenes; 40% of
those lie in the boxes, so every box has points for the GT database.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
           "bicycle", "pedestrian", "traffic_cone")
# typical (length, width, height) of each class, metres
SIZES = ((4.6, 1.9, 1.7), (6.9, 2.5, 2.8), (6.4, 2.8, 3.2), (11.0, 2.9, 3.5), (12.3, 2.9, 3.9),
         (0.5, 2.5, 1.0), (2.1, 0.8, 1.5), (1.7, 0.6, 1.3), (0.7, 0.7, 1.8), (0.4, 0.4, 1.1))
RADAR_CHANNELS = ("RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT", "RADAR_BACK_LEFT",
                  "RADAR_BACK_RIGHT")
RADAR_MOUNTS = {"RADAR_FRONT": (0.0, (3.4, 0.0, 0.5)), "RADAR_FRONT_LEFT": (1.54, (2.4, 0.8, 0.5)),
                "RADAR_FRONT_RIGHT": (-1.54, (2.4, -0.8, 0.5)),
                "RADAR_BACK_LEFT": (3.07, (-0.6, 0.9, 0.5)),
                "RADAR_BACK_RIGHT": (-3.07, (-0.6, -0.9, 0.5))}
# nuScenes' radar .pcd fields: name, numpy type, (PCD TYPE, SIZE)
PCD_FIELDS = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("dyn_prop", "<i1"), ("id", "<i2"),
              ("rcs", "<f4"), ("vx", "<f4"), ("vy", "<f4"), ("vx_comp", "<f4"),
              ("vy_comp", "<f4"), ("is_quality_valid", "<i1"), ("ambig_state", "<i1"),
              ("x_rms", "<i1"), ("y_rms", "<i1"), ("invalid_state", "<i1"), ("pdh0", "<i1"),
              ("vx_rms", "<i1"), ("vy_rms", "<i1")]
LIDAR_POINTS, LIDAR_SWEEPS, RADAR_SWEEPS, RADAR_RETURNS = 34720, 9, 6, 100
IN_RANGE, ON_BOXES, HALF_RANGE = 0.46, 0.4, 54.0


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def write_radar_pcd(path, rows):
    """A binary .pcd v0.7 of the structured ``rows`` (``PCD_FIELDS``)."""
    kinds = [("F" if t[1] == "f" else "I", t[2]) for _, t in PCD_FIELDS]
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format", "VERSION 0.7",
        "FIELDS " + " ".join(n for n, _ in PCD_FIELDS),
        "SIZE " + " ".join(s for _, s in kinds), "TYPE " + " ".join(k for k, _ in kinds),
        "COUNT " + " ".join("1" * len(PCD_FIELDS)), f"WIDTH {len(rows)}", "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0", f"POINTS {len(rows)}", "DATA binary", ""])
    Path(path).write_bytes(header.encode() + rows.tobytes())


def _boxes(rng):
    n = int(rng.randint(40, 61))
    cls = rng.randint(0, len(CLASSES), n)
    dims = np.array(SIZES)[cls] * rng.uniform(0.9, 1.1, (n, 3))
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0:2] = rng.uniform(-HALF_RANGE + 4, HALF_RANGE - 4, (n, 2))
    boxes[:, 2] = -1.8 + dims[:, 2] / 2
    boxes[:, 3:6] = dims
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7:9] = rng.normal(0, 2, (n, 2)) * (cls < 5)[:, None]
    return boxes, np.array([CLASSES[c] for c in cls])


def _in_boxes(rng, boxes, n):
    """n points inside the boxes, about evenly spread over them."""
    k = rng.randint(0, len(boxes), n)
    local = rng.uniform(-0.5, 0.5, (n, 3)) * boxes[k, 3:6]
    c, s = np.cos(boxes[k, 6]), np.sin(boxes[k, 6])
    xyz = np.stack([local[:, 0] * c - local[:, 1] * s + boxes[k, 0],
                    local[:, 0] * s + local[:, 1] * c + boxes[k, 1],
                    local[:, 2] + boxes[k, 2]], 1)
    return xyz, np.bincount(k, minlength=len(boxes))


def _sweep(rng, boxes):
    """One sweep of ``LIDAR_POINTS`` points (x, y, z, intensity, ring) and the
    count of its points in each box."""
    n_in = int(LIDAR_POINTS * IN_RANGE)
    n_box = int(n_in * ON_BOXES)
    on, counts = _in_boxes(rng, boxes, n_box)
    ground = np.column_stack([rng.uniform(-HALF_RANGE, HALF_RANGE, (n_in - n_box, 2)),
                              rng.uniform(-2.0, -1.6, n_in - n_box)])
    r = rng.uniform(80, 110, LIDAR_POINTS - n_in)  # beyond the range in x or y
    a = rng.uniform(-np.pi, np.pi, LIDAR_POINTS - n_in)
    far = np.column_stack([r * np.cos(a), r * np.sin(a), rng.uniform(-2, 4, len(r))])
    xyz = np.concatenate([on, ground, far])
    pts = np.column_stack([xyz, rng.uniform(0, 255, LIDAR_POINTS), rng.randint(0, 32, LIDAR_POINTS)])
    return pts[rng.permutation(LIDAR_POINTS)].astype(np.float32), counts


def _radar_sweep(rng, boxes, mount):
    """About ``RADAR_RETURNS`` returns in the sensor's frame, a third on the
    boxes."""
    n = int(rng.randint(RADAR_RETURNS - 10, RADAR_RETURNS + 11))
    on, _ = _in_boxes(rng, boxes, n // 3)
    xyz = np.concatenate([on, np.column_stack([rng.uniform(-HALF_RANGE, HALF_RANGE, (n - n // 3, 2)),
                                               rng.uniform(-1, 1, n - n // 3)])])
    yaw, t = mount
    sensor = (xyz - np.asarray(t)) @ rot_z(yaw)  # lidar frame -> sensor frame
    rows = np.zeros(n, np.dtype(PCD_FIELDS))
    rows["x"], rows["y"], rows["z"] = sensor.T
    rows["rcs"] = rng.uniform(-5, 30, n)
    rows["vx"], rows["vy"] = rng.normal(0, 3, (2, n))
    rows["vx_comp"], rows["vy_comp"] = rng.normal(0, 2, (2, n))
    rows["dyn_prop"] = rng.randint(0, 8, n)
    rows["id"] = np.arange(n)
    rows["ambig_state"] = 3
    rows["invalid_state"] = 0
    rows["pdh0"] = 1
    return rows


def make_tree(root, n_train=8, n_val=4, seed=0):
    """Write the tree under ``root``; returns (train infos, val infos)."""
    root = Path(root)
    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP", *(f"samples/{c}" for c in RADAR_CHANNELS)):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    splits = {"train": [], "val": []}
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            token = f"{split}_{i:04d}"
            ts = 1_533_151_600_000_000 + 20_000_000 * i
            boxes, names = _boxes(rng)
            key, counts = _sweep(rng, boxes)
            lidar_path = f"samples/LIDAR_TOP/{token}.pcd.bin"
            key.tofile(root / lidar_path)
            sweeps = []
            for k in range(1, LIDAR_SWEEPS + 1):
                pts, _ = _sweep(rng, boxes)
                path = f"sweeps/LIDAR_TOP/{token}_{k}.pcd.bin"
                pts.tofile(root / path)
                tm = np.eye(4)
                tm[:3, :3] = rot_z(rng.normal(0, 0.01))
                tm[:3, 3] = [-0.5 * k, rng.normal(0, 0.05), 0.0]  # the ego moved on
                sweeps.append({"lidar_path": path, "transform_matrix": tm,
                               "time_lag": 0.05 * k})
            radars = {}
            for chan in RADAR_CHANNELS:
                yaw, t = RADAR_MOUNTS[chan]
                radars[chan] = []
                for k in range(RADAR_SWEEPS):
                    path = f"samples/{chan}/{token}_{k}.pcd"
                    write_radar_pcd(root / path, _radar_sweep(rng, boxes, (yaw, t)))
                    radars[chan].append({
                        "data_path": path, "timestamp": ts - 75_000 * k,
                        "sensor2lidar_rotation": rot_z(yaw),
                        "sensor2lidar_translation": np.asarray(t, np.float64)})
            splits[split].append({
                "lidar_path": lidar_path, "token": token, "sweeps": sweeps, "radars": radars,
                "timestamp": ts, "gt_boxes": boxes, "gt_names": names,
                "num_lidar_pts": counts, "num_radar_pts": rng.randint(0, 6, len(boxes))})
        with open(root / f"nuscenes_infos_6radar_10sweeps_{split}.pkl", "wb") as f:
            pickle.dump(splits[split], f)
    return splits["train"], splits["val"]


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("root")
    parser.add_argument("--train", type=int, default=8)
    parser.add_argument("--val", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    train, val = make_tree(args.root, args.train, args.val, args.seed)
    print(f"{len(train)} train and {len(val)} val samples under {args.root}")
