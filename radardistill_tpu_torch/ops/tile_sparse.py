"""Block-sparse (tile-gather) convolution primitives.

Counterpart of ``radardistill_tpu/ops/tile_sparse.py``. A masked-dense stage
spends its operations on empty space; these primitives run it on the active
tiles only, with static shapes:

1. ``tile_activity``: (B, H, W) mask -> (B, nty, ntx) any-active per tile;
2. ``select_tiles``: the active tiles -> a fixed-capacity list of linear tile
   ids, their validity and an overflow flag (more active tiles than the
   capacity: the lowest-priority ones are dropped);
3. ``gather_tiles``: each tile with a halo ring out of the padded map, as a
   (T, tile + 2·halo, tile + 2·halo, C) patch batch that convolutions see as
   VALID dense convs;
4. ``scatter_tiles``: the tile cores back into the dense map (invalid tiles
   into a dump row).

The JAX package leaves these to XLA and reaches no Pallas kernel here; the
port uses stock torch ops (a stable sort for ``top_k``, advanced indexing
for the gathers, ``index_put`` for the scatter).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tile_activity(mask: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, H, W) bool / float -> (B, H // tile, W // tile) bool."""
    b, h, w = mask.shape
    m = mask.reshape(b, h // tile, tile, w // tile, tile)
    return (m != 0).any(dim=4).any(dim=2)


def select_tiles(act: torch.Tensor, max_tiles: int):
    """(B, nty, ntx) -> (ids (max_tiles,) int64 linear over B·nty·ntx, valid
    (max_tiles,) bool, overflowed scalar bool). The active tiles in index
    order first (``jax.lax.top_k``'s order of ties)."""
    flat = act.reshape(-1).to(torch.int32)
    k = min(max_tiles, flat.shape[0])
    score, ids = torch.sort(flat, descending=True, stable=True)
    score, ids = score[:k], ids[:k]
    valid = score > 0
    if k < max_tiles:
        ids = F.pad(ids, (0, max_tiles - k))
        valid = F.pad(valid, (0, max_tiles - k))
    overflow = flat.sum() > valid.sum()
    return ids, valid, overflow


def _tile_coords(ids, hw, tile):
    h, w = hw
    ntx, nty = w // tile, h // tile
    per = nty * ntx
    r = ids % per
    return ids // per, r // ntx, r % ntx


def gather_tiles(x: torch.Tensor, ids, valid, tile: int, halo: int) -> torch.Tensor:
    """(B, H, W, C) -> (T, tile + 2·halo, tile + 2·halo, C); invalid tiles
    zero."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, halo, halo, halo, halo))
    bi, ty, tx = _tile_coords(ids, (h, w), tile)
    off = torch.arange(tile + 2 * halo, device=x.device)
    rows = ty[:, None] * tile + off[None, :]
    cols = tx[:, None] * tile + off[None, :]
    patches = xp[bi[:, None, None], rows[:, :, None], cols[:, None, :]]
    return patches * valid[:, None, None, None].to(patches.dtype)


def scatter_tiles(patches: torch.Tensor, ids, valid, out_shape) -> torch.Tensor:
    """(T, tile, tile, C) cores -> the dense (B, H, W, C); the valid tiles
    are disjoint, every invalid one lands in a dump row."""
    b, h, w, c = out_shape
    t, tile = patches.shape[:2]
    bi, ty, tx = _tile_coords(ids, (h, w), tile)
    iy = torch.arange(tile, device=patches.device)
    rows = bi[:, None] * h + ty[:, None] * tile + iy[None, :]
    cols = tx[:, None] * tile + iy[None, :]
    flat = rows[:, :, None] * w + cols[:, None, :]
    flat = torch.where(valid[:, None, None], flat, b * h * w)
    out = patches.new_zeros((b * h * w + 1, c))
    out = out.index_put((flat.reshape(-1),), patches.reshape(-1, c))
    return out[:b * h * w].reshape(b, h, w, c)
