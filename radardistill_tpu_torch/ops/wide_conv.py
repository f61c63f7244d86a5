"""K9: the trainable 3x3 convolution (stride 1, padding 1, no bias, NHWC).

Counterpart of ``radardistill_tpu/ops/pallas_wide_conv.py`` (``_wide_kernel``,
entered through ``conv3x3_wide`` -> ``_wide_call``, with its custom VJP). The
TPU kernel exists to present the matrix unit a wide N (three ky taps stacked
into one operand, C = 64 inputs paired along W); what it computes is the plain
convolution at the operands' dtype with float32 accumulation, and that is what
is ported: the forward is the float link's kernel with an identity epilogue
(``ops.conv_block.conv_block_fp(identity=True)``, ``csrc/conv_block_fp.cu``).

The backward follows the JAX package: ``dx`` is the same kernel on ``dy``
with the spatially flipped, in/out-transposed kernel; ``dW`` is left to a
stock convolution, accumulated in float32. As in the JAX package, nothing in
the models calls it: the dispatch that did was removed there after it lost on
the TPU.
"""

from __future__ import annotations

import torch

from .conv_block import _full_float32_matmul, conv_block_fp, conv_block_fp_plain


def _forward(x, kernel, block):
    return block(x.contiguous(), kernel.to(x.dtype).contiguous(), identity=True)


def conv3x3_wide_plain(x, kernel):
    """Plain PyTorch version of the forward (no gradient of its own: autograd
    differentiates it)."""
    return _forward(x, kernel, conv_block_fp_plain)


def _launch(x, kernel):
    """The convolution through ``conv_block_fp``; a kernel launch it makes is
    counted here, not as a launch of the float link."""
    before = conv_block_fp.launches
    y = _forward(x, kernel, conv_block_fp)
    conv3x3_wide.launches += conv_block_fp.launches - before
    conv_block_fp.launches = before
    return y


class _Conv3x3Wide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _launch(x, kernel)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            k_t = kernel.flip(0, 1).transpose(2, 3)  # (3, 3, Co, Ci)
            dx = _launch(dy, k_t).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # a stock convolution with batch and channels swapped, in float32
            with _full_float32_matmul():
                dw = torch.nn.grad.conv2d_weight(
                    x.float().permute(0, 3, 1, 2), (kernel.shape[3], kernel.shape[2], 3, 3),
                    dy.float().permute(0, 3, 1, 2), stride=1, padding=1)
            dw = dw.permute(2, 3, 1, 0).to(kernel.dtype)
        return dx, dw


def conv3x3_wide(x, kernel):
    """x (B, H, W, Ci) bfloat16 or float32, kernel (3, 3, Ci, Co) -> (B, H, W,
    Co) in x's dtype: the 3x3 stride-1 padding-1 convolution at x's dtype with
    float32 accumulation, differentiable in both arguments."""
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3_wide: kernel {tuple(kernel.shape)}")
    return _Conv3x3Wide.apply(x, kernel)


conv3x3_wide.launches = 0
