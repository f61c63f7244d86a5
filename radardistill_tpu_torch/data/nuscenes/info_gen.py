"""Offline nuScenes info-pkl + GT-database generation (L8).

Reference: pcdet/datasets/nuscenes/nuscenes_dataset_distill.py:435-538
(create_nuscenes_info incl. the `single=True` one-sample smoke variant),
nuscenes_utils.fill_trainval_infos (:312-497 — lidar sweep transform chains
+ per-sample dict of 5 radar channels × ≤10 sweeps with sensor2lidar
transforms) and nuscenes_dataset.create_groundtruth_database_w_radar
(:426-500 — paired lidar+radar crops per GT box with
num_radar_points_in_gt).

Requires nuscenes-devkit for reading the raw DB (gated); the points-in-box
membership runs through the native host op (csrc/host_ops.cpp) instead of
the reference's roiaware CUDA kernel.

The port's copy of ``radardistill_tpu/data/nuscenes/info_gen.py`` (numpy
and the port's own host ops), line for line but for one repair: the GT
database is made from the train split, as the reference's is (the JAX
package's reads the val split's infos).

CLI:
  python -m radardistill_tpu_torch.data.nuscenes.info_gen --func create_nuscenes_infos \
      --data_path data/nuscenes --version v1.0-trainval [--single]
  python -m radardistill_tpu_torch.data.nuscenes.info_gen --func create_groundtruth_database \
      --data_path data/nuscenes --version v1.0-trainval
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..host_ops import points_in_boxes
from .pcd import quaternion_rotation_matrix, quaternion_inverse, quaternion_multiply, quaternion_yaw

RADAR_CHANNELS = (
    "RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT",
    "RADAR_BACK_LEFT", "RADAR_BACK_RIGHT",
)


def _require_devkit():
    try:
        from nuscenes.nuscenes import NuScenes  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "nuscenes-devkit is required for offline info generation (it reads "
            "the raw nuScenes DB). Install it where the raw data lives; "
            "training/eval on pre-built info pkls has no devkit dependency."
        ) from e


def _transform_matrix(translation, rotation_q, inverse=False):
    tm = np.eye(4)
    rot = quaternion_rotation_matrix(rotation_q)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = rot.T @ (-np.asarray(translation))
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = translation
    return tm


def fill_trainval_infos(nusc, train_scenes, val_scenes, max_sweeps=10, max_radar_sweeps=10):
    """Build per-sample info dicts: lidar path + sweeps with ego-motion
    transform chains, 5 radar channels × ≤max_radar_sweeps with
    sensor2lidar transforms, GT boxes in lidar frame with velocities."""
    from nuscenes.utils.geometry_utils import transform_matrix
    from pyquaternion import Quaternion

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", lidar_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        lidar_path = sd["filename"]

        l2e = transform_matrix(cs["translation"], Quaternion(cs["rotation"]))
        e2g = transform_matrix(pose["translation"], Quaternion(pose["rotation"]))
        car_from_global = np.linalg.inv(e2g)
        ref_from_car = np.linalg.inv(l2e)

        info = {
            "lidar_path": lidar_path,
            "token": sample["token"],
            "sweeps": [],
            "radars": {},
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": sample["timestamp"],
        }

        # lidar sweeps (walk prev chain; nuscenes_utils.fill_trainval_infos)
        sweep_sd = sd
        for _ in range(max_sweeps - 1):
            if sweep_sd["prev"] == "":
                break
            sweep_sd = nusc.get("sample_data", sweep_sd["prev"])
            s_cs = nusc.get("calibrated_sensor", sweep_sd["calibrated_sensor_token"])
            s_pose = nusc.get("ego_pose", sweep_sd["ego_pose_token"])
            s_l2e = transform_matrix(s_cs["translation"], Quaternion(s_cs["rotation"]))
            s_e2g = transform_matrix(s_pose["translation"], Quaternion(s_pose["rotation"]))
            tm = ref_from_car @ car_from_global @ s_e2g @ s_l2e
            info["sweeps"].append({
                "lidar_path": sweep_sd["filename"],
                "transform_matrix": tm,
                "time_lag": (sample["timestamp"] - sweep_sd["timestamp"]) * 1e-6,
            })

        # radar channels
        for chan in RADAR_CHANNELS:
            sweeps = []
            r_sd = nusc.get("sample_data", sample["data"][chan])
            for _ in range(max_radar_sweeps):
                r_cs = nusc.get("calibrated_sensor", r_sd["calibrated_sensor_token"])
                r_pose = nusc.get("ego_pose", r_sd["ego_pose_token"])
                r2e = transform_matrix(r_cs["translation"], Quaternion(r_cs["rotation"]))
                r_e2g = transform_matrix(r_pose["translation"], Quaternion(r_pose["rotation"]))
                s2l = ref_from_car @ car_from_global @ r_e2g @ r2e
                sweeps.append({
                    "data_path": r_sd["filename"],
                    "timestamp": r_sd["timestamp"],
                    "sensor2lidar_rotation": s2l[:3, :3],
                    "sensor2lidar_translation": s2l[:3, 3],
                })
                if r_sd["prev"] == "":
                    break
                r_sd = nusc.get("sample_data", r_sd["prev"])
            info["radars"][chan] = sweeps

        # GT boxes in lidar frame (xyz, dxdydz(wlh->lwh), yaw, vx, vy)
        if not sd["is_key_frame"]:
            continue
        anns = [nusc.get("sample_annotation", t) for t in sample["anns"]]
        locs, dims, rots, names, velocity = [], [], [], [], []
        num_lidar_pts, num_radar_pts = [], []
        from nuscenes.utils.data_classes import Box as NBox

        boxes = nusc.get_boxes(lidar_token)
        for box, ann in zip(boxes, anns):
            box.velocity = nusc.box_velocity(box.token)
            # global -> ego -> lidar
            box.rotate(Quaternion(matrix=car_from_global[:3, :3]))
            box.translate(car_from_global[:3, 3])
            box.rotate(Quaternion(matrix=ref_from_car[:3, :3]))
            box.translate(ref_from_car[:3, 3])
            locs.append(box.center)
            dims.append(box.wlh[[1, 0, 2]])  # wlh -> l, w, h (dx, dy, dz)
            rots.append(box.orientation.yaw_pitch_roll[0])
            names.append(_map_name(box.name))
            v = box.velocity
            velocity.append([v[0], v[1]])
            num_lidar_pts.append(ann["num_lidar_pts"])
            num_radar_pts.append(ann["num_radar_pts"])

        if locs:
            gt_boxes = np.concatenate(
                [np.asarray(locs), np.asarray(dims),
                 np.asarray(rots)[:, None], np.asarray(velocity)], axis=1
            ).astype(np.float32)
        else:
            gt_boxes = np.zeros((0, 9), np.float32)
        info.update({
            "gt_boxes": gt_boxes,
            "gt_names": np.array(names),
            "num_lidar_pts": np.array(num_lidar_pts),
            "num_radar_pts": np.array(num_radar_pts),
        })

        scene = nusc.get("scene", sample["scene_token"])["name"]
        (train_infos if scene in train_scenes else val_infos).append(info)
    return train_infos, val_infos


_NAME_MAP = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
}


def _map_name(raw):
    return _NAME_MAP.get(raw, raw)


def create_nuscenes_infos(data_path, version="v1.0-trainval", max_sweeps=10, single=False):
    _require_devkit()
    from nuscenes.nuscenes import NuScenes
    from nuscenes.utils import splits

    nusc = NuScenes(version=version, dataroot=str(data_path), verbose=True)
    split_map = {
        "v1.0-trainval": (splits.train, splits.val),
        "v1.0-mini": (splits.mini_train, splits.mini_val),
        "v1.0-test": (splits.test, []),
    }
    train_scenes, val_scenes = split_map[version]
    train_infos, val_infos = fill_trainval_infos(nusc, set(train_scenes), set(val_scenes), max_sweeps)
    suffix = "_single" if single else ""
    if single:
        train_infos, val_infos = train_infos[:1], val_infos[:1]
    data_path = Path(data_path)
    with open(data_path / f"nuscenes_infos_6radar_{max_sweeps}sweeps_train{suffix}.pkl", "wb") as f:
        pickle.dump(train_infos, f)
    with open(data_path / f"nuscenes_infos_6radar_{max_sweeps}sweeps_val{suffix}.pkl", "wb") as f:
        pickle.dump(val_infos, f)
    print(f"train: {len(train_infos)}, val: {len(val_infos)}")


def create_groundtruth_database(data_path, version="v1.0-trainval", max_sweeps=10, single=False):
    """Paired lidar+radar GT crops (nuscenes_dataset.py:426-500)."""
    from ..loader import DATASETS
    from ...config import ConfigDict
    from ...utils.common import create_logger

    data_path = Path(data_path)
    suffix = "_single" if single else ""
    cfg = ConfigDict(
        DATASET="NuScenesDataset_Distill",
        DATA_PATH=str(data_path),
        VERSION=version,
        MAX_SWEEPS=max_sweeps,
        INFO_PATH={"train": [f"nuscenes_infos_6radar_{max_sweeps}sweeps_train{suffix}.pkl"],
                   "test": [f"nuscenes_infos_6radar_{max_sweeps}sweeps_val{suffix}.pkl"]},
        POINT_CLOUD_RANGE=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0],
        POINT_FEATURE_ENCODING={},
        DATA_PROCESSOR=[],
    )
    # the train split's infos, as the reference's database (the JAX package
    # builds its dataset with training=False, which reads the val split's)
    dataset = DATASETS["NuScenesDataset_Distill"](
        cfg, class_names=list(_NAME_MAP.values()), training=True,
        root_path=data_path, logger=create_logger(),
    )

    db_dir = data_path / f"gt_database_{max_sweeps}sweeps_with_radar_withvelo{suffix}"
    db_dir.mkdir(parents=True, exist_ok=True)
    db_infos = {}
    for idx in range(len(dataset.infos)):
        info = dataset.infos[idx]
        points = dataset.get_lidar_with_sweeps(idx, max_sweeps)
        radar = dataset.get_radar_with_sweeps(idx, dataset.RADAR_SWEEPS)
        gt_boxes = info["gt_boxes"]
        names = info["gt_names"]
        if len(gt_boxes) == 0:
            continue
        box_idx_l = points_in_boxes(points[:, :3], gt_boxes[:, :7])
        box_idx_r = points_in_boxes(radar[:, :3], gt_boxes[:, :7])
        for k in range(len(gt_boxes)):
            pts = points[box_idx_l == k].copy()
            rpts = radar[box_idx_r == k].copy()
            pts[:, :3] -= gt_boxes[k, :3]
            rpts[:, :3] -= gt_boxes[k, :3]
            fn = f"{Path(info['lidar_path']).stem}_{names[k]}_{k}.bin"
            rfn = f"{Path(info['lidar_path']).stem}_{names[k]}_{k}_radar.bin"
            pts.astype(np.float32).tofile(db_dir / fn)
            rpts.astype(np.float32).tofile(db_dir / rfn)
            db_infos.setdefault(names[k], []).append({
                "name": names[k],
                "path": str(db_dir.name + "/" + fn),
                "radar_path": str(db_dir.name + "/" + rfn),
                "image_idx": idx,
                "gt_idx": k,
                "box3d_lidar": gt_boxes[k],
                "num_points_in_gt": len(pts),
                "num_radar_points_in_gt": len(rpts),
            })
    out = data_path / f"nuscenes_dbinfos_{max_sweeps}sweeps_with_radar_withvelo{suffix}.pkl"
    with open(out, "wb") as f:
        pickle.dump(db_infos, f)
    print(f"GT database: {sum(len(v) for v in db_infos.values())} objects -> {out}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--func", required=True,
                        choices=["create_nuscenes_infos", "create_groundtruth_database"])
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--version", default="v1.0-trainval")
    parser.add_argument("--max_sweeps", type=int, default=10)
    parser.add_argument("--single", action="store_true",
                        help="one-sample smoke infos (the reference's *_single pkls)")
    args = parser.parse_args()
    if args.func == "create_nuscenes_infos":
        create_nuscenes_infos(args.data_path, args.version, args.max_sweeps, args.single)
    else:
        create_groundtruth_database(args.data_path, args.version, args.max_sweeps, args.single)
