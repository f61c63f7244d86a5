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

In this copy every device takes the plain PyTorch versions, counted as K3
and K4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import profiler
from .dcn_sample import corner_terms


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
    return dcn_offset_grad_plain(x, offset, dsampled, mask, stride, padding, kernel_size,
                                 max_offset)


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
    -> dx (B, H, W, C) in dsampled's dtype."""
    return dcn_input_grad_plain(dsampled, offset, mask, H, W, stride, padding, kernel_size,
                                max_offset)


