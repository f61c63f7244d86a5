"""BEV plot of a model's predictions against the ground truth, for the
PyTorch port: ``python tools/torch_demo.py --cfg_file
tools/cfgs/synthetic/pointpillar_smoke.yaml --ckpt_dir
output/pointpillar_smoke/default/ckpt --out demo.png [--device cpu]``, run
from the repository root.

Counterpart of ``tools/demo.py``, with the same arguments; ``--device``
(default ``cuda``, the card) takes the place of ``--platform``. The model is
built from the yaml, its weights drawn from the reference's initializers and
then restored from the newest checkpoint of ``--ckpt_dir`` if there is one;
one eval forward on sample ``--index`` of the test loader, and the points
(grey), the GT boxes (green) and the valid predictions above 0.3 (red) are
drawn in bird's eye view, +x right and +y up, into a PNG of ``--size``
pixels a side. The image is rasterized with numpy and written with
``zlib``: the card's machine has no matplotlib.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


GREY, GREEN, RED = (150, 150, 150), (0, 160, 0), (220, 0, 0)


def to_pixels(xy, pc_range, size):
    """World (x, y) -> (row, col) of a ``size`` x ``size`` image of the range,
    +y up."""
    x0, y0, x1, y1 = pc_range[0], pc_range[1], pc_range[3], pc_range[4]
    col = (xy[..., 0] - x0) / (x1 - x0) * (size - 1)
    row = (y1 - xy[..., 1]) / (y1 - y0) * (size - 1)
    return np.round(row).astype(np.int64), np.round(col).astype(np.int64)


def draw_segment(img, a, b, color, pc_range):
    n = img.shape[0]
    t = np.linspace(0.0, 1.0, 4 * n)[:, None]
    r, c = to_pixels(a[None] * (1 - t) + b[None] * t, pc_range, n)
    ok = (r >= 0) & (r < n) & (c >= 0) & (c < n)
    img[r[ok], c[ok]] = color


def draw_box_bev(img, box, color, pc_range):
    """The box's BEV outline and a heading tick from its centre."""
    from radardistill_tpu_torch.data.box_np import boxes_to_corners_bev

    corners = boxes_to_corners_bev(box[None, :7])[0]
    for i in range(4):
        draw_segment(img, corners[i], corners[(i + 1) % 4], color, pc_range)
    head = box[:2] + np.array([np.cos(box[6]), np.sin(box[6])]) * box[3] / 2
    draw_segment(img, box[:2], head, color, pc_range)


def write_png(path, img):
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    import struct
    import zlib

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w, _ = img.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(img, np.uint8))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--ckpt_dir", default=None)
    parser.add_argument("--index", type=int, default=0)
    parser.add_argument("--out", default="demo_bev.png")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cpu for small runs without a card)")
    parser.add_argument("--size", type=int, default=1000, help="image side in pixels")
    args = parser.parse_args(argv)

    import torch

    from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file
    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.train.train_step import create_train_state, make_eval_step

    cfg = ConfigDict()
    cfg_from_yaml_file(args.cfg_file, cfg)
    test_set, test_loader = build_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, 1,
        root_path=cfg.DATA_CONFIG.get("DATA_PATH", None), training=False)
    info = {
        "grid_size": tuple(int(x) for x in test_set.grid_size[:2]),
        "voxel_size": tuple(float(x) for x in test_set.voxel_size),
        "point_cloud_range": tuple(float(x) for x in test_set.point_cloud_range),
        "class_names": tuple(cfg.CLASS_NAMES),
    }
    model = build_network(cfg.MODEL, info, device=args.device)
    state, _ = create_train_state(
        model, cfg.get("OPTIMIZATION", ConfigDict(OPTIMIZER="adam", LR=1e-3)), 1)
    if args.ckpt_dir:
        restored = CheckpointManager(args.ckpt_dir).restore(state)
        if restored:
            state = restored[0]
    for i, (batch, _) in enumerate(test_loader):
        if i == args.index:
            break
    out = make_eval_step(state.model)(batch_to_torch(batch, args.device))
    fb = {k: v.cpu().numpy() for k, v in out["final_box_dicts"].items()}

    pcr = info["point_cloud_range"]
    img = np.full((args.size, args.size, 3), 255, np.uint8)
    key = "radar_points" if "radar_points" in batch else "points"
    pts, msk = np.asarray(batch[key][0]), np.asarray(batch[key + "_mask"][0])
    r, c = to_pixels(pts[msk, :2], pcr, args.size)
    ok = (r >= 0) & (r < args.size) & (c >= 0) & (c < args.size)
    img[r[ok], c[ok]] = GREY
    if "gt_boxes" in batch:
        for b in np.asarray(batch["gt_boxes"][0]):
            if b[-1] > 0:
                draw_box_bev(img, b, GREEN, pcr)
    v = fb["valid"][0]
    for b, s in zip(fb["boxes"][0][v], fb["scores"][0][v]):
        if s > 0.3:
            draw_box_bev(img, b, RED, pcr)
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
