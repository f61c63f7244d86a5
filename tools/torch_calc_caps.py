"""Active-site capacities (``RADAR_BACKBONE_3D.MAX_ACTIVE`` and the sparse
VFE's table capacity) measured from data, for the PyTorch port: ``python
tools/torch_calc_caps.py --cfg_file radar_distill_train.yaml --n_samples 200
--margin 0.25 [--device cpu]``, run from the repository root.

Counterpart of ``tools/calc_caps.py``, with the same arguments; ``--device``
(default ``cuda``, the card) takes the place of ``--platform`` and is where
the occupancy is dilated. Per sample: the radar points' stride-1 occupancy
(``ops.voxelize.compute_pillar_coords``, the sparse VFE's arithmetic), grown
as the strided SparseConv2d stages grow the active set (``layers.
max_pool_mask``, a 3x3 / stride-2 window); then per stage the max, p99.9 and
mean of the active-site counts and a cap: the next multiple of 512 at or
above max x (1 + margin). The scenes are the dataset's where its infos
exist, else the synthetic generator's.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def stage_counts(occ):
    """occ (H, W) bool tensor, the stride-1 occupancy -> the active counts at
    strides 1, 2, 4 and 8 (the four stages with a MAX_ACTIVE cap)."""
    from radardistill_tpu_torch.models.layers import max_pool_mask

    counts = [int(occ.sum())]
    m = occ[None]
    for _ in range(3):
        m = max_pool_mask(m, 3, 2, 1)
        counts.append(int(m.sum()))
    return counts


def occupancy_from_points(xy, pc_range, voxel_size, grid, device):
    import torch

    from radardistill_tpu_torch.ops.voxelize import compute_pillar_coords

    nx, ny = grid
    coords, ok = compute_pillar_coords(torch.as_tensor(np.asarray(xy, np.float32), device=device),
                                       pc_range, voxel_size, grid)
    occ = torch.zeros((ny, nx), dtype=torch.bool, device=device)
    occ[coords[ok, 1].long(), coords[ok, 0].long()] = True
    return occ


def iter_radar_samples(cfg_file, n_samples, grid_override=None):
    """(radar_xy, pc_range, voxel_size, grid) per sample: the dataset's where
    its info files exist, else synthetic scenes."""
    from radardistill_tpu_torch.utils.production import production_cfg

    full, info = production_cfg(cfg_file, grid=grid_override)
    pc_range = [float(x) for x in info["point_cloud_range"]]
    voxel_size = [float(x) for x in info["voxel_size"]]
    grid = (int(info["grid_size"][0]), int(info["grid_size"][1]))
    ds = None
    try:
        from radardistill_tpu_torch.data.loader import build_dataloader

        ds, _ = build_dataloader(full.DATA_CONFIG, list(full.CLASS_NAMES), batch_size=1,
                                 training=True)
        if len(ds) == 0:
            ds = None
    except Exception as e:  # infos absent, or the devkit missing
        print(f"# real dataset unavailable ({type(e).__name__}: {e}); "
              "falling back to synthetic scenes", file=sys.stderr)
    if ds is not None:
        for i in range(min(n_samples, len(ds))):
            s = ds[i]
            yield np.asarray(s.get("radar_points", s.get("points")))[:, :2], pc_range, \
                voxel_size, grid
        return
    from radardistill_tpu_torch.data.synthetic import make_scene

    for i in range(n_samples):
        s = make_scene(i, num_lidar=100, num_radar=3000, num_boxes=50,
                       pc_range=np.asarray(pc_range, np.float32))
        yield s["radar_points"][:, :2], pc_range, voxel_size, grid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg_file", default="radar_distill_train.yaml",
                    help="shipped yaml name under tools/cfgs/radar_distill")
    ap.add_argument("--n_samples", type=int, default=200)
    ap.add_argument("--margin", type=float, default=0.25, help="headroom over the observed max")
    ap.add_argument("--grid", type=int, default=None, help="dev-only grid override")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu for small runs without a card)")
    args = ap.parse_args(argv)

    per_stage = [[] for _ in range(4)]
    n = 0
    for xy, pc_range, voxel_size, grid in iter_radar_samples(args.cfg_file, args.n_samples,
                                                             args.grid):
        occ = occupancy_from_points(xy, pc_range, voxel_size, grid, args.device)
        for k, c in enumerate(stage_counts(occ)):
            per_stage[k].append(c)
        n += 1

    print(f"# {n} samples, cfg {args.cfg_file}")
    rec = []
    for k, counts in enumerate(per_stage):
        a = np.asarray(counts)
        cap = int(np.ceil(a.max() * (1 + args.margin) / 512) * 512)
        rec.append(cap)
        print(f"stage {k + 1} (stride {2 ** k}): max {a.max():6d}  "
              f"p99.9 {int(np.percentile(a, 99.9)):6d}  mean {a.mean():8.1f}  -> cap {cap}")
    print(f"\nrecommended RADAR_BACKBONE_3D.MAX_ACTIVE: {rec}")
    print("(sparse-VFE table capacity = stage-1 cap; re-run on the real dataset once infos "
          "exist: the synthetic fallback is a lower bound, and train-time `as_overflow` is "
          "the safety net)")
    return rec


if __name__ == "__main__":
    main()
