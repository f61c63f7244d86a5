"""Modulated deformable convolution (DCNv2): K2 tap sampling + one matmul.

Counterpart of ``radardistill_tpu/ops/dcn.py::modulated_deform_conv``. The
JAX dispatcher clamps offsets to ±5 cells exactly when
``pallas_dcn.shapes_supported`` holds (the Pallas kernels' window needs it)
and otherwise runs the unclamped XLA formulation. The port keeps that
function of the shapes, on the CPU and on the GPU alike, so the kernel and
its plain version always compute the same thing: ``shapes_supported`` below
is the same gate, and it only decides the clamp.

Offset channel convention: channel 2k is Δy of tap k, 2k+1 is Δx (taps
row-major). Layouts are NHWC; the weight is HWIO ``(K, K, Cin, Cout)``.
"""

from __future__ import annotations

import torch

from .dcn_sample import dcn_sample

DCN_MAX_OFFSET = 5  # production clamp of the reference's kernel path (cells)

# the Pallas kernels' geometry, as far as the gate reads it
# (radardistill_tpu/ops/pallas_dcn.py: patch_rows, grad_rows, GRAD_IR)
_GRAD_IR = 10


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def shapes_supported(x_shape, offset_shape, stride, padding, kernel_size,
                     max_offset=DCN_MAX_OFFSET) -> bool:
    """The reference's static gate (pallas_dcn.shapes_supported)."""
    _, H, _, C = x_shape
    Ho = offset_shape[1]
    return (
        kernel_size == 3
        and stride == 2
        and padding == 1
        and max_offset <= 9
        and H >= _round8(2 * max_offset + 6)
        and H % _GRAD_IR == 0
        and Ho >= _round8(max_offset + 9)
        and C % 128 == 0
    )


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, stride: int = 1, padding: int = 1,
                          kernel_size: int = 3) -> torch.Tensor:
    """x (B, H, W, Cin); offset (B, Ho, Wo, 2K²); mask (B, Ho, Wo, K²), already
    sigmoided; weight (K, K, Cin, Cout) -> (B, Ho, Wo, Cout) in x's dtype."""
    clamp = shapes_supported(x.shape, offset.shape, stride, padding, kernel_size)
    sampled = dcn_sample(
        x.contiguous(), offset.float().contiguous(), mask.float().contiguous(),
        stride, padding, kernel_size, DCN_MAX_OFFSET if clamp else None)
    K, cin = kernel_size, x.shape[-1]
    w9c = weight.reshape(K * K * cin, weight.shape[-1]).to(sampled.dtype)
    return torch.matmul(sampled, w9c)
