"""K2: DCNv2 masked bilinear tap sampling, tap-major output.

Counterpart of ``radardistill_tpu/ops/pallas_dcn.py::dcn_sample``. For output
site ``p = (ho, wo)`` and tap ``k = (ki, kj)`` (row-major), the sample sits at
``(ho*stride - pad + ki + dy_k, wo*stride - pad + kj + dx_k)``; its four
corner weights are computed in float32, multiplied by the modulation mask
``m_k``, and corners off the grid read zeros. The output is
``(B, Ho, Wo, K*K*C)`` with the taps on the slow half of the last axis, so the
weight contraction around it is a plain last-axis matmul.

``max_offset``: clamp every offset to ``[-max_offset, max_offset]`` first
(``None`` = no clamp). Unlike the TPU kernel, Wo is never padded.

The clamp keeps a NaN offset NaN, as ``torch.clamp`` and the reference's
``jnp.clip`` do: its four corners fall off the grid and the tap reads zeros.

In this copy every device takes the plain PyTorch version, counted as K2.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import profiler


def _check(x, offset, mask, kernel_size):
    kk = kernel_size * kernel_size
    if x.dim() != 4 or offset.dim() != 4 or mask.dim() != 4:
        raise ValueError("dcn_sample: x, offset and mask must be 4-D (NHWC)")
    b, ho, wo = offset.shape[:3]
    if (offset.shape != (b, ho, wo, 2 * kk) or mask.shape != (b, ho, wo, kk)
            or x.shape[0] != b):
        raise ValueError(
            f"dcn_sample: x {tuple(x.shape)}, offset {tuple(offset.shape)}, "
            f"mask {tuple(mask.shape)} for kernel_size {kernel_size}")


def corner_terms(x_shape, offset: torch.Tensor, mask: torch.Tensor, stride: int,
                 padding: int, kernel_size: int, max_offset: Optional[float]):
    """The geometry that the forward and both backward functions share, in
    float32: ``(dh, dw, m, corners)`` with dh, dw, m of shape (B, Ho, Wo, K²)
    and ``corners`` a list of ``(a, bb, ok, rows)`` for the four corners:
    ``ok`` says whether the corner lies on the grid and ``rows`` is its flat
    row index into ``x.reshape(B*H*W, C)`` (0 where it does not)."""
    B, H, W, _ = x_shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    K = kernel_size
    KK = K * K
    dev = offset.device
    off = offset.float().reshape(B, Ho, Wo, KK, 2)
    if max_offset is not None:
        off = off.clamp(-max_offset, max_offset)
    ki = torch.arange(K, device=dev).repeat_interleave(K)
    kj = torch.arange(K, device=dev).repeat(K)
    base_h = (torch.arange(Ho, device=dev) * stride - padding)[:, None] + ki  # (Ho, KK)
    base_w = (torch.arange(Wo, device=dev) * stride - padding)[:, None] + kj  # (Wo, KK)
    ph = base_h.float()[None, :, None, :] + off[..., 0]  # (B, Ho, Wo, KK)
    pw = base_w.float()[None, None, :, :] + off[..., 1]
    h0 = torch.floor(ph)
    w0 = torch.floor(pw)
    b_off = (torch.arange(B, device=dev) * (H * W)).view(B, 1, 1, 1)
    corners = []
    for a in (0, 1):
        for bb in (0, 1):
            r = (h0 + a).detach()
            q = (w0 + bb).detach()
            ok = (r >= 0) & (r <= H - 1) & (q >= 0) & (q <= W - 1)
            rows = torch.where(ok, r * W + q, 0.0).long() + b_off
            corners.append((a, bb, ok, rows))
    return ph - h0, pw - w0, mask.float().reshape(B, Ho, Wo, KK), corners


def dcn_sample_plain(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                     stride: int = 2, padding: int = 1, kernel_size: int = 3,
                     max_offset: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic, same order)."""
    _check(x, offset, mask, kernel_size)
    B, H, W, C = x.shape
    Ho, Wo = offset.shape[1], offset.shape[2]
    KK = kernel_size * kernel_size
    dh, dw, m, corners = corner_terms(x.shape, offset, mask, stride, padding, kernel_size,
                                      max_offset)
    x_flat = x.reshape(B * H * W, C)
    acc = torch.zeros((B, Ho, Wo, KK, C), dtype=torch.float32, device=x.device)
    for a, bb, ok, rows in corners:
        fh = dh if a else 1.0 - dh
        fw = dw if bb else 1.0 - dw
        wt = torch.where(ok, fh * fw * m, 0.0)
        vals = x_flat[rows.reshape(-1)].reshape(B, Ho, Wo, KK, C)
        acc = acc + wt[..., None] * vals.float()
    return acc.reshape(B, Ho, Wo, KK * C).to(x.dtype)


def dcn_sample_work(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                    stride: int = 2, padding: int = 1, kernel_size: int = 3,
                    max_offset: Optional[float] = None):
    """(flops, bytes) of one K2 call (PERF.md's bound of K2): per sampled
    value four corner multiply-adds and the mask's multiply, 9 float32
    operations; x, offset and mask read once, the samples written once."""
    b, ho, wo = offset.shape[:3]
    out = b * ho * wo * kernel_size * kernel_size * x.shape[3]
    return 9 * out, ((x.numel() + out) * x.element_size() + offset.numel() * offset.element_size()
                     + mask.numel() * mask.element_size())


@profiler.counted("dcn_sample", dcn_sample_work)
def dcn_sample(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
               stride: int = 2, padding: int = 1, kernel_size: int = 3,
               max_offset: Optional[float] = None) -> torch.Tensor:
    """x (B, H, W, C) float32/bfloat16; offset (B, Ho, Wo, 2K²) and mask
    (B, Ho, Wo, K²) float32 -> (B, Ho, Wo, K²·C) in x's dtype: the plain
    version."""
    return dcn_sample_plain(x, offset, mask, stride, padding, kernel_size, max_offset)


