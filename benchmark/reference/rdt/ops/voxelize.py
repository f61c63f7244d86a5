"""Point -> pillar ids on the BEV grid, and reductions into that grid, on
the device.

Counterpart of ``radardistill_tpu/ops/voxelize.py``: ``compute_pillar_coords``,
``pillar_ids`` and ``packed_key`` (what the VFEs run when a batch arrives
without host-built pillar tables), and the dense BEV scatter helpers
``scatter_max_bev``, ``scatter_sum_bev``, ``pillar_count``, ``gather_from_bev``
and ``pillar_mean_per_point``. ``MeanVFE`` reduces through the sum and the
count; the dynamic VFEs reduce into a pillar table instead (``models/vfe.py``).
The JAX package leaves these to XLA; here they are ``index_add`` and
``scatter_reduce``.
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


# ----------------------------------------------------- dense BEV scatter helpers
#
# Leading batch axes are allowed: feats (..., N, C) and ids (..., N) reduce
# into (..., H, W, C), one grid per leading index. Every id >= H*W (the
# sentinel) lands in a junk row per grid that is cut off, the reference's
# ``mode="drop"``.


def _flat_ids(ids: torch.Tensor, hw: int):
    """(..., N) ids -> (flat index into (G * (hw + 1)) rows, G grids)."""
    g = ids.numel() // max(ids.shape[-1], 1)
    ids = ids.reshape(g, -1).long().clamp(0, hw)
    return (ids + (torch.arange(g, device=ids.device) * (hw + 1))[:, None]).reshape(-1), g


def _scatter(feats, ids, grid_size, reduce):
    nx, ny = grid_size
    hw, c = nx * ny, feats.shape[-1]
    flat, g = _flat_ids(ids, hw)
    src = feats.reshape(-1, c)
    if reduce == "sum":
        out = torch.zeros((g * (hw + 1), c), dtype=feats.dtype, device=feats.device)
        out = out.index_add(0, flat, src)
    else:
        out = torch.full((g * (hw + 1), c), float("-inf"), dtype=feats.dtype, device=feats.device)
        out = out.scatter_reduce(0, flat[:, None].expand(-1, c), src, reduce="amax",
                                 include_self=True)
        out = torch.where(torch.isneginf(out), 0.0, out)
    return out.reshape(g, hw + 1, c)[:, :hw].reshape(*feats.shape[:-2], ny, nx, c)


def scatter_max_bev(feats: torch.Tensor, ids: torch.Tensor, grid_size) -> torch.Tensor:
    """Per-pillar max of point features into the dense grid, (..., H, W, C);
    empty pillars are 0. The gradient is shared evenly among tied points
    (``scatter_reduce`` with ``amax``), as the reference's ``scatter_max``
    shares it."""
    return _scatter(feats, ids, grid_size, "max")


def scatter_sum_bev(feats: torch.Tensor, ids: torch.Tensor, grid_size) -> torch.Tensor:
    """Per-pillar sum of point features into the dense grid, (..., H, W, C)."""
    return _scatter(feats, ids, grid_size, "sum")


def pillar_count(ids: torch.Tensor, grid_size, dtype=torch.float32) -> torch.Tensor:
    """Points per pillar, (..., H, W)."""
    ones = torch.ones(ids.shape + (1,), dtype=dtype, device=ids.device)
    return scatter_sum_bev(ones, ids, grid_size)[..., 0]


def gather_from_bev(bev: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Each point's row of its pillar: bev (..., H, W, C), ids (..., N) ->
    (..., N, C), zeros for the sentinel (the ``x_max[unq_inv]`` pattern)."""
    h, w, c = bev.shape[-3:]
    rows = bev.reshape(-1, h * w, c)
    rows = torch.cat([rows, rows.new_zeros((rows.shape[0], 1, c))], dim=1)
    flat, _ = _flat_ids(ids, h * w)
    return rows.reshape(-1, c)[flat].reshape(*ids.shape, c)


def pillar_mean_per_point(points_xyz: torch.Tensor, ids: torch.Tensor, grid_size) -> torch.Tensor:
    """Mean xyz of each point's pillar, gathered back per point (scatter-mean +
    gather)."""
    sums = scatter_sum_bev(points_xyz, ids, grid_size)
    cnt = pillar_count(ids, grid_size, points_xyz.dtype)
    return gather_from_bev(sums / cnt.clamp(min=1.0)[..., None], ids)
