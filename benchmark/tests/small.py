"""A cell of the benchmark cut to a size the CPU runs in seconds: the range
rescaled to a 128² grid at the shipped voxel size (as the program's
``production_cfg(grid=...)`` rescales it), a few hundred points a scene, a
ring of two calls. Only the CPU tests use it; the cells on the card run at
their files' sizes."""

from __future__ import annotations

import copy

GRID = 128


def small_cell(cell, batch_size=2):
    cell = copy.deepcopy(cell)
    extent = GRID * float(cell.config["VOXEL_SIZE"][0]) / 2
    pc = cell.config["POINT_CLOUD_RANGE"]
    pc = [-extent, -extent, pc[2], extent, extent, pc[5]]
    cell.config["POINT_CLOUD_RANGE"] = pc
    rb2 = cell.config["MODEL"].get("RADAR_BACKBONE_2D", {})
    if "GRID_SIZE" in rb2:
        rb2["POINT_CLOUD_RANGE"] = list(pc)
        rb2["GRID_SIZE"] = [GRID, GRID, 1]
    bk = cell.config["MODEL"].get("BACKBONE_3D")
    if bk is not None and "TABLE_CAPACITY" in bk:
        bk["TABLE_CAPACITY"] = 4096
    # the CPU's bfloat16 convolutions take seconds a call: float32 here
    cell.config["precision"]["activations"] = "float32"
    t = cell.traffic
    t.update(batch_size=batch_size, ring_batches=4 if t["kind"] == "train" else 2,
             radar_returns=[150, 250], boxes=[3, 6], trace_calls=2)
    t["caps"] = dict(t["caps"], MAX_RADAR_POINTS=512)
    if "lidar_points" in t:
        t["lidar_points"] = [2000, 3000]
        t["caps"]["MAX_LIDAR_POINTS"] = 4096
    if "compared_calls" in cell.limits:
        cell.limits["compared_calls"] = 2
    return cell
