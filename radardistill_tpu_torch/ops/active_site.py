"""Active-site sparse 2D convolution primitives (host rulebooks).

Counterpart of ``radardistill_tpu/ops/active_site.py``. An active set is a
fixed-capacity table of sorted linear site ids ``uids`` (sentinel ``H*W``)
with features ``(B, cap, C)`` beside it; a 3x3 conv reads its neighbours
through per-stage tap tables ``nb``/``msk`` ``(B, 9, cap_out)`` built on the
host (``data/host_precompute.py``) with their per-tap inverses ``inv``/``imsk``
``(B, 9, cap_in)`` beside them. Everything here is batched over the leading
axis. What the student crosses is differentiable in the features, with the
reference's gather-formulated backward passes: ``gather_taps_inv_b`` (a gather
of the cotangent through ``inv``/``imsk``) and ``densify_batch`` (a row gather
at the site ids). Both are deterministic; plain autograd of the index ops
would give the same numbers through ``index_add_``, whose order of additions
on CUDA changes from run to run. The teacher's ``densify_packed_direct_batch``
runs under ``no_grad`` and has no backward.
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


def _flat_tap_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows (B, R, C), idx (B, K, N) row numbers within each sample's R rows
    -> (B, K, N, C): one flat gather."""
    b, r, c = rows.shape
    flat = idx.long() + (torch.arange(b, device=idx.device) * r)[:, None, None]
    g = rows.reshape(-1, c)[flat.reshape(-1).clamp(0, b * r - 1)]
    return g.reshape(*idx.shape, c)


class _GatherTapsInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, nb, msk, inv, imsk):
        ctx.save_for_backward(inv, imsk)
        return _flat_tap_gather(feats, nb) * msk[..., None].to(feats.dtype)

    @staticmethod
    def backward(ctx, grad):
        # each tap is injective, so its transpose is a gather of the cotangent
        # rows at the inverse map, masked and summed over the taps
        inv, imsk = ctx.saved_tensors
        b, k, cap_out, c = grad.shape
        seg = (torch.arange(k, device=inv.device) * cap_out)[None, :, None]
        g = _flat_tap_gather(grad.reshape(b, k * cap_out, c), inv.long() + seg)
        g = (g * imsk[..., None].to(grad.dtype)).sum(dim=1)
        return g, None, None, None, None


def gather_taps_inv_b(feats: torch.Tensor, nb: torch.Tensor, msk: torch.Tensor,
                      inv: torch.Tensor, imsk: torch.Tensor) -> torch.Tensor:
    """feats (B, cap_in, C), nb/msk (B, 9, cap_out), inv/imsk (B, 9, cap_in)
    -> (B, 9, cap_out, C); missing neighbours are zero. Both directions are one
    flat gather: forward of the neighbour rows, backward of the cotangent rows
    at the per-tap inverse maps."""
    return _GatherTapsInv.apply(feats, nb, msk, inv, imsk)


def conv3x3_as_b(feats: torch.Tensor, tap, kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """3x3 conv on active sites: feats (B, cap_in, Ci), tap = (nb, msk, inv,
    imsk), kernel HWIO (3, 3, Ci, Co) -> (B, cap_out, Co) in feats' dtype:
    one flat gather and one matmul over the (tap, Ci) axis."""
    ci, co = kernel.shape[2], kernel.shape[3]
    g = gather_taps_inv_b(feats, *tap)  # (B, 9, n, Ci)
    b, k, n, _ = g.shape
    y = torch.matmul(g.permute(0, 2, 1, 3).reshape(b, n, k * ci),
                     kernel.reshape(k * ci, co).to(g.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class _DensifyRows(torch.autograd.Function):
    """(B, cap, C) tables -> (B*hw, C) dense rows through K5; the backward is
    the row gather of the cotangent at each table row's own cell (site ids are
    unique, so no two rows share a cell)."""

    @staticmethod
    def forward(ctx, feats, uids, inv, hw_flat):
        b, cap, c = feats.shape
        ctx.save_for_backward(uids)
        ctx.hw_flat = hw_flat
        feats_z = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1).reshape(b * (cap + 1), c)
        flat_idx = inv + (torch.arange(b, dtype=torch.int32, device=inv.device) * (cap + 1))[:, None]
        return expand_rows(feats_z, flat_idx.reshape(-1))

    @staticmethod
    def backward(ctx, g_dense):
        (uids,) = ctx.saved_tensors
        hw_flat = ctx.hw_flat
        b, cap = uids.shape
        valid = uids < hw_flat
        flat_u = uids.long().clamp(0, hw_flat - 1) + (
            torch.arange(b, device=uids.device) * hw_flat)[:, None]
        g = g_dense[flat_u.reshape(-1)].reshape(b, cap, -1)
        return g * valid[..., None].to(g.dtype), None, None, None


def densify_batch(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """(B, cap, C) tables -> (B, H, W, C) dense + (B, H, W) bool mask.

    The inverse site map indexes a flat (B*(cap+1), C) table whose last row
    per sample is zero; K5 (``expand_rows``) does the row gather."""
    h, w = hw
    b, cap, c = feats.shape
    inv = site_index_grid(uids, h * w, cap)  # (B, hw)
    rows = _DensifyRows.apply(feats, uids, inv, h * w)
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
    No backward: only the frozen teacher takes it, without gradients."""
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
