"""Active-site sparse 2D convolution primitives.

Counterpart of ``radardistill_tpu/ops/active_site.py``. An active set is a
fixed-capacity table of sorted linear site ids ``uids`` (sentinel ``H*W``)
with features ``(B, cap, C)`` beside it; a 3x3 conv reads its neighbours
through per-stage tap tables ``nb``/``msk`` ``(B, 9, cap_out)`` with their
per-tap inverses ``inv``/``imsk`` ``(B, 9, cap_in)`` beside them. The tables
come from the host (``data/host_precompute.py``) or, for a batch without them,
from the device-side functions here (``compact_unique_sorted``,
``downsample_active``, ``conv_neighbor_table_b``, ``invert_taps_b``), which
give the same int32 tables bit for bit. Everything here is batched over the
leading axis. What the student crosses is differentiable in the features, with the
reference's gather-formulated backward passes: ``gather_taps_inv_b`` (a gather
of the cotangent through ``inv``/``imsk``) and ``densify_batch`` (a row gather
at the site ids). Both are deterministic; plain autograd of the index ops
would give the same numbers through ``index_add_``, whose order of additions
on CUDA changes from run to run. The space-to-depth teacher's two packed
densifies (``densify_packed_batch`` for a linear-order table,
``densify_packed_direct_batch`` for a packed-order one) have the same kind of
backward, a row gather of the cotangent at each table row's packed address,
so a teacher outside ``FREEZE_PIPELINE`` trains through them.

The JAX package's unbatched forms (``conv_neighbor_table``, ``gather_taps``,
``invert_taps``, ``gather_taps_inv``, ``conv3x3_as``, ``densify``,
``densify_packed``, ``sparsify``: one sample, no leading axis) are here too,
as the batched functions at B = 1 with the same backward passes; no model
path calls them.
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


def compact_unique_sorted(ids_s: torch.Tensor, cap: int, sentinel: int):
    """Sorted ids (B, N) int32 (invalid entries == ``sentinel``, which sorts
    last) -> a fixed-capacity table of the unique ids.

    Returns ``uids`` (B, cap) sorted unique ids with empty slots = sentinel
    (beyond ``cap`` the largest ids are dropped), ``slot`` (B, N) the row of
    each input id in ``uids`` (``cap`` for invalid and dropped ids) and
    ``count`` (B,) the number of unique valid ids before capping. Only the
    first occurrence of an id writes its row; everything else lands in a junk
    column ``cap`` that is cut off (the reference's ``mode="drop"``)."""
    b = ids_s.shape[0]
    prev = torch.cat([ids_s.new_full((b, 1), -1), ids_s[:, :-1]], dim=1)
    valid = ids_s < sentinel
    first = (ids_s != prev) & valid
    pos = torch.cumsum(first, dim=1, dtype=torch.int32) - 1
    slot = torch.where(valid & (pos < cap), pos, cap)
    write_idx = torch.where(first, slot, cap)
    uids = torch.full((b, cap + 1), sentinel, dtype=torch.int32, device=ids_s.device)
    uids.scatter_(1, write_idx.long(), ids_s.to(torch.int32))
    return uids[:, :cap].contiguous(), slot, first.sum(dim=1, dtype=torch.int32)


def compact_unique(ids: torch.Tensor, cap: int, sentinel: int):
    """:func:`compact_unique_sorted` after a sort; ``slot`` is aligned with the
    sorted ids, not with the input order."""
    return compact_unique_sorted(torch.sort(ids, dim=1).values, cap, sentinel)


_KY = (0, 0, 0, 1, 1, 1, 2, 2, 2)
_KX = (0, 1, 2, 0, 1, 2, 0, 1, 2)


def conv_neighbor_table_b(out_uids: torch.Tensor, in_grid: torch.Tensor,
                          in_hw: Tuple[int, int], out_w: int, stride: int, cap_in: int):
    """Neighbour tables of a 3x3 pad-1 conv (stride 1 submanifold, 2 down):
    out_uids (B, cap_out) sorted output site ids, in_grid (B, H_in*W_in) from
    :func:`site_index_grid` of the input set -> ``nb`` (B, 9, cap_out) int32
    rows of the input table, monotone per tap (holes filled forward, clipped
    to [0, cap_in-1]) and ``msk`` (B, 9, cap_out) bool, true where the
    neighbour exists. Tap k = (ky, kx) of output (oy, ox) reads input
    (oy*stride - 1 + ky, ox*stride - 1 + kx)."""
    h_in, w_in = in_hw
    b = out_uids.shape[0]
    dev = out_uids.device
    oy = torch.div(out_uids, out_w, rounding_mode="floor")
    ox = out_uids - oy * out_w
    out_valid = oy < (h_in // stride)  # sentinel rows have oy == H_out
    ky = torch.tensor(_KY, dtype=torch.int32, device=dev)[None, :, None]
    kx = torch.tensor(_KX, dtype=torch.int32, device=dev)[None, :, None]
    iy = oy[:, None, :] * stride - 1 + ky  # (B, 9, cap_out)
    ix = ox[:, None, :] * stride - 1 + kx
    ok = out_valid[:, None, :] & (iy >= 0) & (iy < h_in) & (ix >= 0) & (ix < w_in)
    hw = h_in * w_in
    q = (iy * w_in + ix).clamp(0, hw - 1).long()
    q_flat = q + (torch.arange(b, device=dev) * hw)[:, None, None]
    nb = in_grid.reshape(-1)[q_flat]
    exists = ok & (nb < cap_in)
    nb_ff = torch.cummax(torch.where(exists, nb, -1), dim=2).values
    return nb_ff.clamp(0, cap_in - 1), exists


def invert_taps_b(nb: torch.Tensor, msk: torch.Tensor, cap_in: int):
    """Invert per-tap neighbour tables: nb/msk (B, 9, cap_out) -> ``inv``
    (B, 9, cap_in) int32, the output position that reads input row r through
    tap k (holes filled forward, clipped to [0, cap_out-1]) and ``imsk``
    (B, 9, cap_in) bool, true where row r is really read. For a fixed tap the
    valid entries are injective, so one flat scatter-min over all samples and
    taps finds them: masked entries write ``cap_out``, which any valid
    position beats."""
    b, k, cap_out = nb.shape
    dev = nb.device
    o_idx = torch.arange(cap_out, dtype=torch.int32, device=dev).expand(b, k, cap_out)
    seg = (torch.arange(b * k, device=dev) * cap_in).reshape(b, k, 1)
    flat_pos = (seg + nb.long()).reshape(-1)
    vals = torch.where(msk, o_idx, cap_out).reshape(-1)
    tgt = torch.full((b * k * cap_in,), cap_out, dtype=torch.int32, device=dev)
    tgt = tgt.scatter_reduce(0, flat_pos, vals, reduce="amin", include_self=True)
    tgt = tgt.reshape(b, k, cap_in)
    imsk = tgt < cap_out
    inv_ff = torch.cummax(torch.where(imsk, tgt, -1), dim=2).values
    return inv_ff.clamp(0, cap_out - 1), imsk


def downsample_active(uids: torch.Tensor, in_hw: Tuple[int, int], cap_out: int):
    """Output active set of a 3x3 stride-2 pad-1 sparse conv: uids (B, cap)
    -> (out_uids (B, cap_out), count (B,) before capping). An output site is
    active iff its window touches an active input: input (y, x) touches rows
    {y//2, (y+1)//2} x columns {x//2, (x+1)//2}; the candidates are sorted,
    deduplicated and compacted."""
    h, w = in_hw
    h2, w2 = h // 2, w // 2
    sent_out = h2 * w2
    valid = uids < h * w
    y = torch.div(uids, w, rounding_mode="floor")
    x = uids - y * w
    cy0, cy1 = y >> 1, (y + 1) >> 1
    cx0, cx1 = x >> 1, (x + 1) >> 1
    cands = []
    for cy, dup_y in ((cy0, False), (cy1, True)):
        for cx, dup_x in ((cx0, False), (cx1, True)):
            ok = valid & (cy < h2) & (cx < w2)
            if dup_y:
                ok = ok & (cy1 != cy0)
            if dup_x:
                ok = ok & (cx1 != cx0)
            cands.append(torch.where(ok, cy * w2 + cx, sent_out))
    out_uids, _, count = compact_unique(torch.cat(cands, dim=1), cap_out, sent_out)
    return out_uids, count


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
        return expand_rows(feats_z, _batch_rows(inv, cap))

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
    _check_even(h, w)
    y = torch.div(uids, w, rounding_mode="floor")
    x = uids - y * w
    addr = (((y >> 1) * (w >> 1) + (x >> 1)) << 2) + ((y & 1) << 1) + (x & 1)
    return torch.where(uids >= h * w, h * w, addr)


def _check_even(h: int, w: int):
    if h % 2 or w % 2:
        raise ValueError(f"packed_addr: the packed layout needs an even grid, not {(h, w)}")


class _DensifyPackedRows(torch.autograd.Function):
    """(B, cap, C) tables -> (B*h*w, C) rows of the packed grid through K5:
    ``flat_idx`` holds the flat table row (``B*(cap+1)`` rows, the last of
    each sample zero) of every packed cell. The backward is the row gather of
    the cotangent at each table row's packed address (site ids are unique, so
    no two rows share a cell); sentinel rows take zero. An int8 table takes
    no gradient (autograd tracks no integer tensor)."""

    @staticmethod
    def forward(ctx, feats, uids, flat_idx, hw):
        b, cap, c = feats.shape
        ctx.save_for_backward(uids)
        ctx.hw = hw
        feats_z = torch.cat([feats, feats.new_zeros((b, 1, c))], dim=1).reshape(b * (cap + 1), c)
        return expand_rows(feats_z, flat_idx)

    @staticmethod
    def backward(ctx, g_rows):
        (uids,) = ctx.saved_tensors
        h, w = ctx.hw
        b, cap = uids.shape
        valid = uids < h * w
        addr = packed_addr(uids, h, w).long().clamp(0, h * w - 1) + (
            torch.arange(b, device=uids.device) * (h * w))[:, None]
        g = g_rows[addr.reshape(-1)].reshape(b, cap, -1)
        return g * valid[..., None].to(g.dtype), None, None, None


def _batch_rows(inv: torch.Tensor, cap: int) -> torch.Tensor:
    """(B, M) per-sample table rows -> (B*M,) int32 rows of the flat
    (B*(cap+1), C) table."""
    b = inv.shape[0]
    flat = inv + (torch.arange(b, dtype=torch.int32, device=inv.device) * (cap + 1))[:, None]
    return flat.reshape(-1)


def densify_packed_batch(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """LINEAR-ORDER (B, cap, C) tables (rows sorted by site id) -> (B, H/2,
    W/2, 4*C) packed dense + (B, H, W) bool mask. The inverse site map is built
    in linear order and read in the packed layout, so K5 (``expand_rows``)
    writes the packed grid directly, also for int8 tables."""
    h, w = hw
    _check_even(h, w)
    b, cap, c = feats.shape
    inv = site_index_grid(uids, h * w, cap)  # (B, hw), linear order
    inv_p = inv.view(b, h // 2, 2, w // 2, 2).permute(0, 1, 3, 2, 4).reshape(b, h * w)
    rows = _DensifyPackedRows.apply(feats, uids, _batch_rows(inv_p, cap), (h, w))
    return rows.reshape(b, h // 2, w // 2, 4 * c), (inv < cap).reshape(b, h, w)


def densify_packed_direct_batch(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """PACKED-ORDER (B, cap, C) tables (rows sorted by ``packed_addr``, id
    values linear) -> (B, H/2, W/2, 4*C) packed dense + (B, H/2, W/2, 4) bool
    packed mask (phase-major). The inverse site map is scattered directly at
    packed addresses, so the row gather lands in the packed layout with no
    transpose; K5 (``expand_rows``) does the gather, also for int8 tables."""
    h, w = hw
    b, cap, c = feats.shape
    addr = packed_addr(uids, h, w)  # (B, cap)
    inv = torch.full((b * h * w,), cap, dtype=torch.int32, device=uids.device)
    rows = torch.arange(cap, dtype=torch.int32, device=uids.device).expand(b, cap)
    keep = addr < h * w
    flat = addr.long() + (torch.arange(b, device=uids.device) * (h * w))[:, None]
    inv[flat[keep]] = rows[keep]
    inv = inv.view(b, h * w)
    dense = _DensifyPackedRows.apply(feats, uids, _batch_rows(inv, cap), (h, w))
    return dense.reshape(b, h // 2, w // 2, 4 * c), (inv < cap).reshape(b, h // 2, w // 2, 4)


# ------------------------------------------------- one sample, no batch axis


def conv_neighbor_table(out_uids: torch.Tensor, in_grid: torch.Tensor, in_hw: Tuple[int, int],
                        out_w: int, stride: int, cap_in: int):
    """:func:`conv_neighbor_table_b` of one sample: out_uids (cap_out,),
    in_grid (H_in*W_in,) -> nb, msk (9, cap_out)."""
    nb, msk = conv_neighbor_table_b(out_uids[None], in_grid[None], in_hw, out_w, stride, cap_in)
    return nb[0], msk[0]


def gather_taps(feats: torch.Tensor, nb: torch.Tensor, msk: torch.Tensor) -> torch.Tensor:
    """feats (cap_in, C), nb/msk (9, cap_out) -> (9, cap_out, C), missing
    neighbours zero; autograd's backward (a scatter-add of the cotangent)."""
    return _flat_tap_gather(feats[None], nb[None])[0] * msk[..., None].to(feats.dtype)


def invert_taps(nb: torch.Tensor, msk: torch.Tensor, cap_in: int):
    """:func:`invert_taps_b` of one sample: nb/msk (9, cap_out) -> inv, imsk
    (9, cap_in)."""
    inv, imsk = invert_taps_b(nb[None], msk[None], cap_in)
    return inv[0], imsk[0]


def gather_taps_inv(feats, nb, msk, inv, imsk) -> torch.Tensor:
    """:func:`gather_taps` whose backward gathers the cotangent through the
    inverse maps (:func:`gather_taps_inv_b` of one sample)."""
    return gather_taps_inv_b(feats[None], nb[None], msk[None], inv[None], imsk[None])[0]


def conv3x3_as(feats: torch.Tensor, nb: torch.Tensor, msk: torch.Tensor, kernel: torch.Tensor,
               bias=None, out_dtype=None, inv=None, imsk=None) -> torch.Tensor:
    """3x3 conv on the active sites of one sample: feats (cap_in, Ci), taps
    (9, cap_out), kernel HWIO (3, 3, Ci, Co) -> (cap_out, Co) in ``out_dtype``
    (feats' by default), the product and the bias in float32. With
    ``inv``/``imsk`` the feature gradient is the gather of
    :func:`gather_taps_inv`, else autograd's scatter-add."""
    g = gather_taps_inv(feats, nb, msk, inv, imsk) if inv is not None else gather_taps(
        feats, nb, msk)
    k, n, ci = g.shape
    y = torch.matmul(g.permute(1, 0, 2).reshape(n, k * ci).float(),
                     kernel.reshape(k * ci, -1).float())
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or feats.dtype)


def densify(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """One table (cap, C) -> (H, W, C) dense + (H, W) mask
    (:func:`densify_batch` of one sample, its row-gather backward)."""
    dense, mask = densify_batch(feats[None], uids[None], hw)
    return dense[0], mask[0]


def densify_packed(feats: torch.Tensor, uids: torch.Tensor, hw: Tuple[int, int]):
    """One linear-order table (cap, C) -> (H/2, W/2, 4*C) packed dense + (H, W)
    mask (:func:`densify_packed_batch` of one sample)."""
    dense, mask = densify_packed_batch(feats[None], uids[None], hw)
    return dense[0], mask[0]


def sparsify(bev: torch.Tensor, mask: torch.Tensor, cap: int):
    """Dense (H, W, C) + (H, W) mask -> (feats (cap, C), uids (cap,), count):
    the active sites in id order, beyond ``cap`` the largest dropped; count
    is the active sites before capping."""
    h, w, c = bev.shape
    ids = torch.where(mask.reshape(-1), torch.arange(h * w, dtype=torch.int32,
                                                     device=bev.device), h * w)
    uids, _, count = compact_unique(ids[None], cap, h * w)
    uids = uids[0]
    feats = bev.reshape(h * w, c)[uids.long().clamp(0, h * w - 1)]
    return feats * (uids < h * w)[:, None].to(feats.dtype), uids, count[0]
