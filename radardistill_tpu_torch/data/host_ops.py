"""ctypes bindings for the native host ops (``csrc/host_ops.cpp``).

The port's copy of ``radardistill_tpu/data/host_ops.py``. The library is
compiled with g++ at first use into ``build/radardistill_tpu_torch/`` at the
repository root (where ``ops/cuda_lib.py`` builds the CUDA kernels), never
beside the source, and rebuilt when the source is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host_ops.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "radardistill_tpu_torch"
_SO = _BUILD_DIR / "libhost_ops.so"
_lock = threading.Lock()
_lib = None


def _load():
    global _lib
    # once loaded, no lock: a loader worker forked while another thread held
    # it would otherwise wait on it forever
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = _SO.with_name(f"{_SO.stem}.{os.getpid()}.tmp.so")
            subprocess.check_call(
                ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(str(_SO))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.boxes_iou_bev.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
        lib.boxes_iou_3d.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
        lib.points_in_boxes.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, i32p]
        lib.nms_bev.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float, i32p]
        lib.nms_bev.restype = ctypes.c_int
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.as_build_tap.argtypes = [
            i32p, ctypes.c_int, i32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, u8p, i32p, u8p,
        ]
        lib.as_downsample.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ]
        lib.as_downsample.restype = ctypes.c_int
        lib.pillar_sort_encode.argtypes = [
            f32p, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, u8p, i32p, i32p, i32p, f32p,
        ]
        lib.pillar_sort_encode.restype = ctypes.c_int
        _lib = lib
        return lib


def _c7(boxes):
    return np.ascontiguousarray(boxes[:, :7], np.float32)


def boxes_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    lib = _load()
    a, b = _c7(boxes_a), _c7(boxes_b)
    out = np.zeros((len(a), len(b)), np.float32)
    if len(a) and len(b):
        lib.boxes_iou_bev(a, len(a), b, len(b), out)
    return out


def boxes_iou_3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    lib = _load()
    a, b = _c7(boxes_a), _c7(boxes_b)
    out = np.zeros((len(a), len(b)), np.float32)
    if len(a) and len(b):
        lib.boxes_iou_3d(a, len(a), b, len(b), out)
    return out


def points_in_boxes(points_xyz: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """-> (N,) int32 index of first containing box, -1 outside."""
    lib = _load()
    p = np.ascontiguousarray(points_xyz[:, :3], np.float32)
    b = _c7(boxes)
    out = np.full(len(p), -1, np.int32)
    if len(p) and len(b):
        lib.points_in_boxes(p, len(p), b, len(b), out)
    return out


def nms_bev(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    lib = _load()
    b = _c7(boxes)
    s = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros(len(b), np.int32)
    nk = lib.nms_bev(b, s, len(b), float(thresh), keep)
    return keep[:nk]


def pillar_sort_encode(points: np.ndarray, mask: np.ndarray, pc_range,
                       voxel_size, grid_size, capacity: int,
                       packed: bool = False):
    """Per-sample pillar encode (stable sort by pillar id + compact table).
    Returns (pts_sorted, mask_sorted, ids_sorted, slot, uids, count, mean)
    — same semantics as the device path (models/vfe.encode_table front
    half); ``mean`` (n, 3) is the per-point cluster mean (the host twin of
    models/vfe._slot_mean, equal at f32 resolution). ``packed``: sort by
    the space-to-depth packed key (vfe packed_order twin)."""
    lib = _load()
    n, f = points.shape
    nx, ny = int(grid_size[0]), int(grid_size[1])
    pts = np.ascontiguousarray(points, np.float32)
    msk = np.ascontiguousarray(mask, np.uint8)
    pts_s = np.empty_like(pts)
    mask_s = np.empty(n, np.uint8)
    ids_s = np.empty(n, np.int32)
    slot = np.empty(n, np.int32)
    uids = np.empty(capacity, np.int32)
    mean_s = np.empty((n, 3), np.float32)
    count = lib.pillar_sort_encode(
        pts, msk, n, f,
        float(pc_range[0]), float(pc_range[1]),
        float(voxel_size[0]), float(voxel_size[1]),
        nx, ny, capacity, int(packed), pts_s, mask_s, ids_s, slot, uids,
        mean_s,
    )
    return pts_s, mask_s.astype(bool), ids_s, slot, uids, int(count), mean_s


def as_build_tap(out_uids: np.ndarray, in_uids: np.ndarray, h_in: int,
                 w_in: int, out_w: int, stride: int):
    """Per-sample sparse-conv index tables (active_site.conv_neighbor_table_b
    + invert_taps_b semantics, bit-identical). Returns (nb, msk, inv, imsk)."""
    lib = _load()
    cap_out, cap_in = len(out_uids), len(in_uids)
    nb = np.empty((9, cap_out), np.int32)
    msk = np.empty((9, cap_out), np.uint8)
    inv = np.empty((9, cap_in), np.int32)
    imsk = np.empty((9, cap_in), np.uint8)
    lib.as_build_tap(
        np.ascontiguousarray(out_uids, np.int32), cap_out,
        np.ascontiguousarray(in_uids, np.int32), cap_in,
        h_in, w_in, out_w, stride, nb, msk, inv, imsk,
    )
    return nb, msk.astype(bool), inv, imsk.astype(bool)


def as_downsample(uids: np.ndarray, h: int, w: int, cap_out: int):
    """Per-sample stride-2 active-set growth (active_site.downsample_active
    semantics: receptive-field dilation, overflow drops largest ids).
    Returns (out_uids (cap_out,), true count)."""
    lib = _load()
    out = np.empty(cap_out, np.int32)
    n = lib.as_downsample(
        np.ascontiguousarray(uids, np.int32), len(uids), h, w, cap_out, out
    )
    return out, int(n)
