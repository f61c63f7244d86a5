"""Devkit-free nuScenes RADAR .pcd parser.

Replaces nuscenes-devkit's `RadarPointCloud.from_file` (used by the reference
at nuscenes_dataset_distill.py:211-238 with ALL filters disabled — the
'none' invalid/dynprop/ambig setting, i.e. every return is kept). The
nuScenes radar files are PCL .pcd v0.7 binary files with 18 fields:

  x y z dyn_prop id rcs vx vy vx_comp vy_comp is_quality_valid ambig_state
  x_rms y_rms invalid_state pdh0 vx_rms vy_rms

This standalone parser reads the header (FIELDS/SIZE/TYPE/COUNT/POINTS/DATA)
and decodes the binary payload — no external dependency.

The port's copy of ``radardistill_tpu/data/nuscenes/pcd.py`` (numpy only),
line for line.
"""

from __future__ import annotations

import numpy as np

_TYPE_MAP = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
             ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path) -> tuple[np.ndarray, list[str]]:
    """Read a binary .pcd -> (structured-as-float (N, n_fields) array, field names)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        assert all(c == 1 for c in counts), "multi-count fields unsupported"
        mode = header["DATA"]

        if mode == "binary":
            dtype = np.dtype([(name, _TYPE_MAP[(t, s)]) for name, t, s in zip(fields, types, sizes)])
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
            out = np.stack([raw[name].astype(np.float64) for name in fields], axis=1)
        elif mode == "ascii":
            out = np.loadtxt(f, max_rows=n).reshape(n, len(fields)).astype(np.float64)
        else:
            raise ValueError(f"unsupported .pcd DATA mode {mode}")
    return out, fields


def load_radar_points(path) -> np.ndarray:
    """-> (N, 6) float32 [x, y, z, rcs, vx_comp, vy_comp] — the exact feature
    selection of the reference loader (nuscenes_dataset_distill.py:227-232),
    with all quality filters disabled ('none')."""
    pts, fields = read_pcd(path)
    idx = {name: i for i, name in enumerate(fields)}
    cols = [idx["x"], idx["y"], idx["z"], idx["rcs"], idx["vx_comp"], idx["vy_comp"]]
    return pts[:, cols].astype(np.float32)


def yaw_to_quaternion(yaw: float) -> list[float]:
    """[w, x, y, z] for rotation by yaw around +z (replaces pyquaternion)."""
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def quaternion_yaw(q) -> float:
    """Yaw of quaternion [w, x, y, z] (projected to the xy plane)."""
    w, x, y, z = q
    # rotate unit x-vector, take atan2 of the result
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + w * z)
    return float(np.arctan2(vy, vx))


def quaternion_rotation_matrix(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quaternion_multiply(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return [
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ]


def quaternion_inverse(q):
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return [w / n, -x / n, -y / n, -z / n]
