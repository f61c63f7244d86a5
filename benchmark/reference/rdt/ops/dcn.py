"""Modulated deformable convolution (DCNv2), differentiable: K2 tap sampling +
one matmul forward; K3 and K4 backward.

Counterpart of ``radardistill_tpu/ops/dcn.py::modulated_deform_conv``. The
JAX dispatcher clamps offsets to ±5 cells exactly when
``pallas_dcn.shapes_supported`` holds (the Pallas kernels' window needs it)
and otherwise runs the unclamped XLA formulation. The port keeps that
function of the shapes, on the CPU and on the GPU alike, so the kernel and
its plain version always compute the same thing: ``shapes_supported`` below
is the same gate, and it only decides the clamp.

The backward is the reference's ``_mdcn_bwd``: ``dW = sampledᵀ·dy`` and
``dsampled = dy·Wᵀ`` are plain matmuls (``sampled`` is saved from the forward
for the first), K3 (``ops/dcn_grad.py::dcn_offset_grad``) turns the unmasked
``dsampled`` into the offset and mask gradients, K4 (``dcn_input_grad``) into
``dx``. Where the offsets are clamped the gradient of an offset passes only
for ``|Δ| <= R`` (inclusive, as the reference's ``in_win``); the mask gradient
is not gated.

Offset channel convention: channel 2k is Δy of tap k, 2k+1 is Δx (taps
row-major). Layouts are NHWC; the weight is HWIO ``(K, K, Cin, Cout)``.
"""

from __future__ import annotations

import os

import torch

from .dcn_grad import dcn_input_grad, dcn_offset_grad
from .dcn_sample import dcn_sample

DCN_MAX_OFFSET = 5  # production clamp of the reference's kernel path (cells)


def dcn_max_offset() -> int:
    """The clamp R in cells: ``DCN_R`` from the environment, else the
    production ``DCN_MAX_OFFSET``. Read at every call, so one process can run
    two legs with different clamps (``tools/torch_quality_gate.py --variant
    dcn_r8``); the gate below keeps the reference's default R of 5."""
    return int(os.environ.get("DCN_R", str(DCN_MAX_OFFSET)))

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


class _ModulatedDeformConv(torch.autograd.Function):
    """x (B, H, W, Cin), offset and mask float32, weight HWIO; ``max_offset``
    None = no clamp."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, stride, padding, kernel_size, max_offset):
        sampled = dcn_sample(x, offset, mask, stride, padding, kernel_size, max_offset)
        ctx.save_for_backward(x, offset, mask, weight, sampled)
        ctx.geometry = (stride, padding, kernel_size, max_offset)
        w9c = weight.reshape(-1, weight.shape[-1]).to(sampled.dtype)
        return torch.matmul(sampled, w9c)

    @staticmethod
    def backward(ctx, dy):
        x, offset, mask, weight, sampled = ctx.saved_tensors
        stride, padding, kernel_size, max_offset = ctx.geometry
        k9c, co = sampled.shape[-1], weight.shape[-1]
        dy = dy.contiguous()
        w9c = weight.reshape(k9c, co).to(dy.dtype)
        dweight = torch.matmul(sampled.reshape(-1, k9c).t(), dy.reshape(-1, co))
        dsampled = torch.matmul(dy, w9c.t())
        g18, dm9 = dcn_offset_grad(x, offset, dsampled, mask, stride, padding, kernel_size,
                                   max_offset)
        if max_offset is not None:
            g18 = g18 * (offset.abs() <= max_offset).to(g18.dtype)
        dx = dcn_input_grad(dsampled, offset, mask, x.shape[1], x.shape[2], stride, padding,
                            kernel_size, max_offset)
        return (dx, g18, dm9, dweight.reshape(weight.shape).to(weight.dtype),
                None, None, None, None)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                          weight: torch.Tensor, stride: int = 1, padding: int = 1,
                          kernel_size: int = 3) -> torch.Tensor:
    """x (B, H, W, Cin); offset (B, Ho, Wo, 2K²); mask (B, Ho, Wo, K²), already
    sigmoided; weight (K, K, Cin, Cout) -> (B, Ho, Wo, Cout) in x's dtype.
    Differentiable in all four."""
    clamp = shapes_supported(x.shape, offset.shape, stride, padding, kernel_size)
    return _ModulatedDeformConv.apply(
        x.contiguous(), offset.float().contiguous(), mask.float().contiguous(), weight,
        stride, padding, kernel_size, dcn_max_offset() if clamp else None)
