"""Active-site sparse 2D convolution primitives (forward, host rulebooks).

Counterpart of ``radardistill_tpu/ops/active_site.py``. An active set is a
fixed-capacity table of sorted linear site ids ``uids`` (sentinel ``H*W``)
with features ``(B, cap, C)`` beside it; a 3x3 conv reads its neighbours
through per-stage tap tables ``nb``/``msk`` ``(B, 9, cap_out)`` built on the
host (``data/host_precompute.py``). Everything here is batched over the
leading axis; the port is forward only so far, so the custom backward passes
of the JAX functions have no counterpart yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .expand import expand_rows


def site_index_grid(uids: torch.Tensor, hw: int, cap: int) -> torch.Tensor:
    """(B, cap) sorted site ids -> (B, hw) int32 table row of each site
    (``cap`` where empty). Sentinel ids (>= hw) are dropped."""
    b = uids.shape[0]
    grid = torch.full((b * hw,), cap, dtype=torch.int32, device=uids.device)
    rows = torch.arange(cap, dtype=torch.int32, device=uids.device).expand(b, cap)
    keep = uids < hw
    flat = uids.long() + (torch.arange(b, device=uids.device) * hw)[:, None]
    grid[flat[keep]] = rows[keep]
    return grid.view(b, hw)


def gather_taps_inv_b(feats: torch.Tensor, nb: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """feats (B, cap_in, C), nb/msk (B, 9, cap_out) -> (B, 9, cap_out, C);
    missing neighbours are zero. The forward of the JAX function; its
    gather-formulated backward (through ``inv``/``imsk``) is not ported."""
    b, cap_in, c = feats.shape
    k, cap_out = nb.shape[1], nb.shape[2]
    flat = nb.long() + (torch.arange(b, device=nb.device) * cap_in)[:, None, None]
    g = feats.reshape(-1, c)[flat.reshape(-1).clamp(0, b * cap_in - 1)]
    return g.reshape(b, k, cap_out, c) * msk[..., None].to(feats.dtype)


def conv3x3_as_b(feats: torch.Tensor, tap, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """3x3 conv on active sites: feats (B, cap_in, Ci), tap = (nb, msk, inv,
    imsk), kernel HWIO (3, 3, Ci, Co) -> (B, cap_out, Co) in feats' dtype:
    one flat gather and one matmul over the (tap, Ci) axis."""
    nb, msk = tap[0], tap[1]
    ci, co = kernel.shape[2], kernel.shape[3]
    g = gather_taps_inv_b(feats, nb, msk)  # (B, 9, n, Ci)
    b, k, n, _ = g.shape
    y = torch.matmul(g.permute(0, 2, 1, 3).reshape(b, n, k * ci),
                     kernel.reshape(k * ci, co).to(g.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def densify_batch(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """(B, cap, C) tables -> (B, H, W, C) dense + (B, H, W) bool mask.

    The inverse site map indexes a flat (B*(cap+1), C) table whose last row
    per sample is zero; K5 (``expand_rows``) does the row gather."""
    h, w = hw
    b, cap, c = feats.shape
    feats_z = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1).reshape(b * (cap + 1), c)
    inv = site_index_grid(uids, h * w, cap)  # (B, hw)
    flat_idx = inv + (torch.arange(b, dtype=torch.int32, device=inv.device) * (cap + 1))[:, None]
    rows = expand_rows(feats_z, flat_idx.reshape(-1))
    return rows.reshape(b, h, w, c), (inv < cap).reshape(b, h, w)


def packed_addr(uids: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Space-to-depth flat address of linear site ids on the (h, w) grid:
    parent-major, phase = (y%2)*2 + x%2. The sentinel h*w maps to itself.
    The address pairs rows and columns, so h and w must be even (an odd grid
    would alias neighbouring parents)."""
    if h % 2 or w % 2:
        raise ValueError(f"packed_addr: the packed layout needs an even grid, not {(h, w)}")
    y = torch.div(uids, w, rounding_mode="floor")
    x = uids - y * w
    addr = (((y >> 1) * (w >> 1) + (x >> 1)) << 2) + ((y & 1) << 1) + (x & 1)
    return torch.where(uids >= h * w, h * w, addr)


def densify_packed_direct_batch(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """PACKED-ORDER (B, cap, C) tables (rows sorted by ``packed_addr``, id
    values linear) -> (B, H/2, W/2, 4*C) packed dense + (B, H/2, W/2, 4) bool
    packed mask (phase-major). The inverse site map is scattered directly at
    packed addresses, so the row gather lands in the packed layout with no
    transpose; K5 (``expand_rows``) does the gather, also for int8 tables.
    Forward only."""
    h, w = hw
    b, cap, c = feats.shape
    feats_z = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1).reshape(b * (cap + 1), c)
    addr = packed_addr(uids, h, w)  # (B, cap)
    inv = torch.full((b * h * w,), cap, dtype=torch.int32, device=uids.device)
    rows = torch.arange(cap, dtype=torch.int32, device=uids.device).expand(b, cap)
    keep = addr < h * w
    flat = addr.long() + (torch.arange(b, device=uids.device) * (h * w))[:, None]
    inv[flat[keep]] = rows[keep]
    inv = inv.view(b, h * w)
    flat_idx = inv + (torch.arange(b, dtype=torch.int32, device=inv.device) * (cap + 1))[:, None]
    dense = expand_rows(feats_z, flat_idx.reshape(-1))
    return dense.reshape(b, h // 2, w // 2, 4 * c), (inv < cap).reshape(b, h // 2, w // 2, 4)
