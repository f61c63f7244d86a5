"""Point -> pillar ids on the BEV grid, on the device.

Counterpart of ``radardistill_tpu/ops/voxelize.py`` for the sparse-table VFE:
``compute_pillar_coords``, ``pillar_ids`` and ``packed_key``. They are what the
VFE runs when a batch arrives without host-built pillar tables. The dense BEV
scatter helpers of that module serve only the dense VFE, which is not ported.
"""

from __future__ import annotations

import torch


def compute_pillar_coords(points_xy: torch.Tensor, pc_range, voxel_size, grid_size):
    """points_xy (..., 2) world x, y -> (coords_xy int32 (..., 2), in_range
    bool (...,)): float32 floor((xy - range) / voxel), then the bounds mask."""
    lo = torch.tensor(tuple(pc_range[:2]), dtype=points_xy.dtype, device=points_xy.device)
    vs = torch.tensor(tuple(voxel_size[:2]), dtype=points_xy.dtype, device=points_xy.device)
    coords = torch.floor((points_xy - lo) / vs).to(torch.int32)
    nx, ny = grid_size
    in_range = ((coords[..., 0] >= 0) & (coords[..., 0] < nx)
                & (coords[..., 1] >= 0) & (coords[..., 1] < ny))
    return coords, in_range


def pillar_ids(coords_xy: torch.Tensor, valid: torch.Tensor, grid_size) -> torch.Tensor:
    """Linear pillar id ``y * nx + x`` (row-major BEV); invalid points get the
    sentinel ``nx * ny``."""
    nx, ny = grid_size
    ids = coords_xy[..., 1] * nx + coords_xy[..., 0]
    return torch.where(valid, ids, nx * ny)


def packed_key(ids: torch.Tensor, grid_size) -> torch.Tensor:
    """Space-to-depth sort key of linear pillar ids: parent-major,
    ``((y//2)*(nx//2) + x//2)*4 + (y%2)*2 + x%2``; the sentinel ``nx * ny``
    maps to itself. The key pairs rows and columns, so both nx and ny must be
    even (an odd grid would alias neighbouring parents)."""
    nx, ny = grid_size
    if nx % 2 or ny % 2:
        raise ValueError(f"packed_key: the packed order needs an even grid, not {(nx, ny)}")
    sent = nx * ny
    y = torch.div(ids, nx, rounding_mode="floor")
    x = ids - y * nx
    key = (((y >> 1) * (nx >> 1) + (x >> 1)) << 2) + ((y & 1) << 1) + (x & 1)
    return torch.where(ids >= sent, ids, key)
