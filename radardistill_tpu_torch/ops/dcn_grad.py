"""K3 and K4: the backward of the DCNv2 tap sampling.

Counterparts of ``radardistill_tpu/ops/pallas_dcn.py::dcn_offset_grad`` and
``::dcn_input_grad``. Both take the *unmasked* cotangent of the sampled tensor,
``dsampled (B, Ho, Wo, K²·C)`` tap-major as ``dcn_sample`` writes it, and
recompute the sample geometry of the forward (``ops/dcn_sample.py``) from
``offset`` and ``max_offset``.

``dcn_offset_grad`` -> ``g18 (B, Ho, Wo, 2K²)`` and ``dm9 (B, Ho, Wo, K²)``,
float32. With ``v_j = <dsampled_k, x at corner j>`` (zero off the grid), ``fh,
fw`` the corner's interpolation factors and ``gh, gw = ±1`` their derivatives
(the derivative follows ``floor``, also at integer positions)::

    g18[2k]   = m_k · Σ_j gh_j·fw_j·v_j        dm9[k] = Σ_j fh_j·fw_j·v_j
    g18[2k+1] = m_k · Σ_j fh_j·gw_j·v_j

The mask gradient is exact (no division by the mask) and is with respect to
the sigmoided mask. The clamp's pass-through (no gradient where ``|Δ| > R``)
is *not* applied here: the caller multiplies ``g18`` by it
(``ops/dcn.py``), as the reference does outside its kernel.

``dcn_input_grad`` -> ``dx (B, H, W, C)`` in ``dsampled``'s dtype: every
sample adds ``m_k·fh·fw·dsampled_k`` to its four corner cells, accumulated in
float32 and rounded once.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel (``csrc/dcn_offset_grad.cu``, ``csrc/dcn_input_grad.cu``), or raises if
it cannot. The CUDA kernels take K = 3. K3 reads its rows in 16-byte vectors
(C a multiple of 8 in bfloat16, of 4 in float32). K4 has two routes,
:func:`input_grad_route` chooses: ``"tile"`` for a clamped call (every call of
the model), where a CTA owns a tile of ``dx``, finds the (site, tap) pairs
that reach each cell among the output sites that :func:`reach_window` says
can reach the tile, and sums each cell in registers, 16 lanes a cell, in a
fixed order: ``dx`` repeats bit for bit.
``"atomic"`` for an unclamped call, which has no window: float32 atomics into
a zeroed buffer, cast after, so ``dx`` repeats to rounding only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..utils import profiler
from . import cuda_lib
from .dcn_sample import DTYPE_CODES, corner_terms


def _check(name, x_shape, offset, mask, dsampled, kernel_size):
    kk = kernel_size * kernel_size
    if len(x_shape) != 4 or offset.dim() != 4 or mask.dim() != 4 or dsampled.dim() != 4:
        raise ValueError(f"{name}: x, offset, mask and dsampled must be 4-D (NHWC)")
    b, ho, wo = offset.shape[:3]
    c = x_shape[3]
    if (offset.shape != (b, ho, wo, 2 * kk) or mask.shape != (b, ho, wo, kk)
            or dsampled.shape != (b, ho, wo, kk * c) or x_shape[0] != b):
        raise ValueError(
            f"{name}: x {tuple(x_shape)}, offset {tuple(offset.shape)}, mask "
            f"{tuple(mask.shape)}, dsampled {tuple(dsampled.shape)} for kernel_size {kernel_size}")


def _check_cuda(name, x_shape, offset, mask, dsampled, kernel_size, others=()):
    tensors = (offset, mask, dsampled, *others)
    if dsampled.device.type != "cuda" or any(t.device != dsampled.device for t in tensors):
        raise ValueError(f"{name}: tensors on " + ", ".join(str(t.device) for t in tensors))
    if (dsampled.dtype not in DTYPE_CODES or offset.dtype != torch.float32
            or mask.dtype != torch.float32 or any(t.dtype != dsampled.dtype for t in others)):
        raise TypeError(f"{name}: dsampled {dsampled.dtype}, offset {offset.dtype}, mask "
                        f"{mask.dtype}" + "".join(f", {t.dtype}" for t in others))
    _check(name, x_shape, offset, mask, dsampled, kernel_size)
    if kernel_size != 3:
        raise ValueError(f"{name}: the kernel takes 3x3 taps, not {kernel_size}x{kernel_size}")
    if x_shape[3] % 4:
        raise ValueError(f"{name}: the kernel moves 4-channel vectors; C = {x_shape[3]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every tensor must be contiguous")


def dcn_offset_grad_plain(x: torch.Tensor, offset: torch.Tensor, dsampled: torch.Tensor,
                          mask: torch.Tensor, stride: int = 2, padding: int = 1,
                          kernel_size: int = 3, max_offset: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: four corner gathers and three reductions."""
    _check("dcn_offset_grad", x.shape, offset, mask, dsampled, kernel_size)
    B, H, W, C = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    KK = kernel_size * kernel_size
    dh, dw, m, corners = corner_terms(x.shape, offset, mask, stride, padding, kernel_size,
                                      max_offset)
    x_flat = x.reshape(B * H * W, C)
    ds = dsampled.reshape(B, Ho, Wo, KK, C).float()
    gy = torch.zeros_like(dh)
    gx = torch.zeros_like(dh)
    gm = torch.zeros_like(dh)
    for a, bb, ok, rows in corners:
        fh = dh if a else 1.0 - dh
        fw = dw if bb else 1.0 - dw
        gh = 1.0 if a else -1.0
        gw = 1.0 if bb else -1.0
        vals = x_flat[rows.reshape(-1)].reshape(B, Ho, Wo, KK, C).float()
        v = torch.where(ok, (ds * vals).sum(-1), 0.0)
        gy = gy + gh * fw * v
        gx = gx + fh * gw * v
        gm = gm + fh * fw * v
    g18 = torch.stack([m * gy, m * gx], dim=-1).reshape(B, Ho, Wo, 2 * KK)
    return g18, gm


def _small_bytes(offset, mask):
    return offset.numel() * offset.element_size() + mask.numel() * mask.element_size()


def dcn_offset_grad_work(x, offset, dsampled, mask, stride=2, padding=1, kernel_size=3,
                         max_offset=None):
    """(flops, bytes) of one K3 call (PERF.md's bound of K3): per output site,
    tap, corner and channel a multiply-add (2 x K² x 4 x C float32 operations a
    site); x, dsampled, offset and mask read once, g18 and dm9 written once."""
    b, ho, wo = offset.shape[:3]
    kk, c = kernel_size * kernel_size, x.shape[3]
    sites = b * ho * wo
    return (2 * kk * 4 * c * sites,
            (x.numel() + dsampled.numel()) * x.element_size() + _small_bytes(offset, mask)
            + sites * 3 * kk * 4)


@profiler.counted("dcn_offset_grad", dcn_offset_grad_work)
def dcn_offset_grad(x: torch.Tensor, offset: torch.Tensor, dsampled: torch.Tensor,
                    mask: torch.Tensor, stride: int = 2, padding: int = 1,
                    kernel_size: int = 3, max_offset: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) and dsampled (B, Ho, Wo, K²·C) float32/bfloat16 (one
    dtype); offset (B, Ho, Wo, 2K²) and mask (B, Ho, Wo, K²) float32 ->
    (g18 (B, Ho, Wo, 2K²), dm9 (B, Ho, Wo, K²)) float32."""
    if x.device.type == "cpu":
        return dcn_offset_grad_plain(x, offset, dsampled, mask, stride, padding, kernel_size,
                                     max_offset)
    _check_cuda("dcn_offset_grad", x.shape, offset, mask, dsampled, kernel_size, others=(x,))
    vec = 16 // x.element_size()
    if x.shape[3] % vec:
        raise ValueError(f"dcn_offset_grad: the kernel moves 16-byte vectors of {vec} channels; "
                         f"C = {x.shape[3]}")
    B, Ho, Wo = offset.shape[:3]
    g18 = torch.empty((B, Ho, Wo, 18), dtype=torch.float32, device=x.device)
    dm9 = torch.empty((B, Ho, Wo, 9), dtype=torch.float32, device=x.device)
    launch_offset_grad(x, offset, mask, dsampled, g18, dm9, stride, padding, max_offset)
    dcn_offset_grad.launches += 1
    return g18, dm9


def launch_offset_grad(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                       dsampled: torch.Tensor, g18: torch.Tensor, dm9: torch.Tensor,
                       stride: int, padding: int, max_offset: Optional[float]) -> None:
    """The bare launch of K3 into preallocated ``g18`` and ``dm9``, on checked
    operands; counts nothing."""
    B, H, W, C = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    rc = cuda_lib.lib().rdt_dcn_offset_grad(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), dsampled.data_ptr(),
        g18.data_ptr(), dm9.data_ptr(), DTYPE_CODES[x.dtype], B, H, W, C, Ho, Wo,
        stride, padding, int(max_offset is not None), float(max_offset or 0.0),
        x.device.index, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "dcn_offset_grad")


dcn_offset_grad.launches = 0


def dcn_input_grad_plain(dsampled: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                         H: int, W: int, stride: int = 2, padding: int = 1,
                         kernel_size: int = 3, max_offset: Optional[float] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of K4: one ``index_add_`` per corner into a
    float32 buffer."""
    B, Ho, Wo, KKC = dsampled.shape
    KK = kernel_size * kernel_size
    C = KKC // KK
    _check("dcn_input_grad", (B, H, W, C), offset, mask, dsampled, kernel_size)
    dh, dw, m, corners = corner_terms((B, H, W, C), offset, mask, stride, padding, kernel_size,
                                      max_offset)
    ds = dsampled.reshape(B, Ho, Wo, KK, C).float()
    acc = torch.zeros((B * H * W, C), dtype=torch.float32, device=dsampled.device)
    for a, bb, ok, rows in corners:
        fh = dh if a else 1.0 - dh
        fw = dw if bb else 1.0 - dw
        wt = torch.where(ok, fh * fw * m, 0.0)
        acc.index_add_(0, rows.reshape(-1), (wt[..., None] * ds).reshape(-1, C))
    return acc.reshape(B, H, W, C).to(dsampled.dtype)


# K4's tile route: a CTA of TILE_WARPS warps owns a tile of at most TILE x
# TILE cells (an axis split evenly: 180 -> 23 x 8, 90 -> 12 x 8) x all
# channels; its shared memory holds the geometry of the tile's window's
# (site, tap) pairs, 24 bytes each (10 x 10 x 9 at stride 2 and R 5: 22 KB),
# and a bucket of pairs per cell
TILE = 8
TILE_WARPS = 8
TILE_CHANNELS = 8  # the route takes C in multiples of this (16 bytes of bfloat16)
TILE_SMEM_LIMIT = 227 * 1024  # Hopper's opt-in dynamic shared memory per block
ROUTES = ("tile", "atomic")


def tile_smem_bytes(cap: int, th: int, tw: int) -> int:
    """The tile kernel's dynamic shared memory (``launch_tile`` in
    ``csrc/dcn_input_grad.cu``): 24 bytes per (site, tap) pair of a tile's
    window, and 12 per cell bucket bound."""
    return cap * 24 + (th + 1) * (tw + 1) * 12


def input_grad_route(max_offset: Optional[float], stride: int, padding: int, C: int,
                     dtype: torch.dtype, geometry: Optional[Tuple[int, int, int, int, int]] = None
                     ) -> str:
    """K4's route: ``"tile"`` where the offsets are clamped (the clamp bounds
    the sites that reach a tile) and the tile kernel takes the geometry,
    else ``"atomic"``. With ``geometry`` = (H, W, Ho, Wo, kernel_size) the
    tile route also needs its window to fit in shared memory
    (``TILE_SMEM_LIMIT``): a wide clamp at stride 1 goes to ``"atomic"``."""
    takes = (dtype in DTYPE_CODES and C > 0 and C % TILE_CHANNELS == 0 and stride >= 1
             and padding >= 0)
    if max_offset is not None and math.isfinite(max_offset) and takes:
        if geometry is not None:
            H, W, Ho, Wo, kernel_size = geometry
            th, tw, _ = tile_plan(H, W)
            cap = tile_windows(H, W, Ho, Wo, stride, padding, kernel_size, max_offset, th, tw,
                               "cpu")[1]
            if tile_smem_bytes(cap, th, tw) > TILE_SMEM_LIMIT:
                return "atomic"
        return "tile"
    return "atomic"


def reach_window(lo: int, hi: int, stride: int, padding: int, kernel_size: int,
                 max_offset: float, n_out: int) -> Tuple[int, int]:
    """The output rows ``[first, last]`` whose clamped samples can put a
    corner in input rows ``lo..hi`` (empty when ``first > last``). The same
    holds for columns.

    A tap of output row ``ho`` samples row ``ho·stride − padding + ki + Δ``
    with ``ki`` in ``[0, K)`` and ``Δ`` in ``[−R, R]``; its corners are the
    floor of that and the row below, so they lie in ``[ho·stride − padding −
    ceil(R), ho·stride − padding + K + floor(R)]``."""
    first = -((kernel_size + math.floor(max_offset) - padding - lo) // stride)
    last = (hi + padding + math.ceil(max_offset)) // stride
    return max(first, 0), min(last, n_out - 1)


def tile_plan(H: int, W: int) -> Tuple[int, int, int]:
    """K4's tile for an input of ``H x W`` cells: ``(rows, columns, warps)``,
    each axis split evenly into ``ceil(n / TILE)`` parts."""
    th, tw = (-(-n // -(-n // TILE)) if n else 1 for n in (H, W))
    return th, tw, TILE_WARPS


_windows = {}


def tile_windows(H: int, W: int, Ho: int, Wo: int, stride: int, padding: int,
                 kernel_size: int, max_offset: float, th: int, tw: int,
                 device) -> Tuple[torch.Tensor, int]:
    """The kernel's window table, int32 on ``device``: ``[first, last]`` of
    :func:`reach_window` for each tile row of ``th`` rows, then for each tile
    column of ``tw`` columns; and the most (site, tap) pairs in one tile's
    window, which sizes the kernel's shared memory. Made once per geometry
    and device."""
    key = (H, W, Ho, Wo, stride, padding, kernel_size, float(max_offset), th, tw, str(device))
    if key not in _windows:
        rows = [reach_window(r, min(r + th, H) - 1, stride, padding, kernel_size, max_offset,
                             Ho) for r in range(0, H, th)]
        cols = [reach_window(q, min(q + tw, W) - 1, stride, padding, kernel_size, max_offset,
                             Wo) for q in range(0, W, tw)]
        span = lambda win: max(max(0, last - first + 1) for first, last in win)  # noqa: E731
        table = torch.tensor(rows + cols, dtype=torch.int32).reshape(-1).to(device)
        _windows[key] = table, span(rows) * span(cols) * kernel_size * kernel_size
    return _windows[key]


def launch_tile(dsampled: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                window: Tuple[torch.Tensor, int], dx: torch.Tensor, stride: int, padding: int,
                max_offset: float, plan: Tuple[int, int, int]) -> None:
    """The bare launch of K4's tile route into a preallocated ``dx`` (B, H,
    W, C) of dsampled's dtype, on checked operands, for the tile ``plan``
    (:func:`tile_plan`) and its window table (:func:`tile_windows`); counts
    nothing."""
    B, H, W, C = dx.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    th, tw, warps = plan
    table, cap = window
    rc = cuda_lib.lib().rdt_dcn_input_grad_tile(
        dsampled.data_ptr(), offset.data_ptr(), mask.data_ptr(), table.data_ptr(),
        dx.data_ptr(), DTYPE_CODES[dsampled.dtype], B, H, W, C, Ho, Wo, stride, padding,
        float(max_offset), th, tw, warps, cap, dsampled.device.index,
        cuda_lib.stream_of(dsampled))
    cuda_lib.check(rc, "dcn_input_grad (tile)")


def dcn_input_grad_work(dsampled, offset, mask, H, W, stride=2, padding=1, kernel_size=3,
                        max_offset=None):
    """(flops, bytes) of one K4 call (PERF.md's bound of K4): K3's operations;
    dsampled, offset and mask read once, dx written once."""
    b, ho, wo, kkc = dsampled.shape
    c = kkc // (kernel_size * kernel_size)
    return (2 * kkc * 4 * b * ho * wo,
            (dsampled.numel() + b * H * W * c) * dsampled.element_size()
            + _small_bytes(offset, mask))


@profiler.counted("dcn_input_grad", dcn_input_grad_work)
def dcn_input_grad(dsampled: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   H: int, W: int, stride: int = 2, padding: int = 1, kernel_size: int = 3,
                   max_offset: Optional[float] = None) -> torch.Tensor:
    """dsampled (B, Ho, Wo, K²·C) float32/bfloat16; offset and mask float32
    -> dx (B, H, W, C) in dsampled's dtype. On the card each launch counts in
    ``dcn_input_grad.launches`` and ``dcn_input_grad.route_launches[route]``."""
    if dsampled.device.type == "cpu":
        return dcn_input_grad_plain(dsampled, offset, mask, H, W, stride, padding, kernel_size,
                                    max_offset)
    B, Ho, Wo, KKC = dsampled.shape
    C = KKC // (kernel_size * kernel_size)
    _check_cuda("dcn_input_grad", (B, H, W, C), offset, mask, dsampled, kernel_size)
    if dsampled.data_ptr() % 16:
        raise ValueError("dcn_input_grad: the kernels read dsampled in 16-byte vectors; it lies "
                         f"at {dsampled.data_ptr():#x}")
    route = input_grad_route(max_offset, stride, padding, C, dsampled.dtype,
                             (H, W, Ho, Wo, kernel_size))
    if route == "tile":
        plan = tile_plan(H, W)
        window = tile_windows(H, W, Ho, Wo, stride, padding, kernel_size, max_offset, *plan[:2],
                              dsampled.device)
        dx = torch.empty((B, H, W, C), dtype=dsampled.dtype, device=dsampled.device)
        launch_tile(dsampled, offset, mask, window, dx, stride, padding, max_offset, plan)
    else:
        acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=dsampled.device)
        rc = cuda_lib.lib().rdt_dcn_input_grad(
            dsampled.data_ptr(), offset.data_ptr(), mask.data_ptr(), acc.data_ptr(),
            DTYPE_CODES[dsampled.dtype], B, H, W, C, Ho, Wo, stride, padding,
            int(max_offset is not None), float(max_offset or 0.0),
            dsampled.device.index, cuda_lib.stream_of(dsampled))
        cuda_lib.check(rc, "dcn_input_grad (atomic)")
        dx = acc.to(dsampled.dtype)
    dcn_input_grad.launches += 1
    dcn_input_grad.route_launches[route] += 1
    return dx


dcn_input_grad.launches = 0
dcn_input_grad.route_launches = dict.fromkeys(ROUTES, 0)
