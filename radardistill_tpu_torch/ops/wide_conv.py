"""K9: the trainable 3x3 convolution (stride 1, padding 1, no bias, NHWC).

Counterpart of ``radardistill_tpu/ops/pallas_wide_conv.py`` (``_wide_kernel``,
entered through ``conv3x3_wide`` -> ``_wide_call``, with its custom VJP). The
TPU kernel exists to present the matrix unit a wide N (three ky taps stacked
into one operand, C = 64 inputs paired along W); what it computes is the plain
convolution at the operands' dtype with float32 accumulation, and that is what
is ported. In bfloat16 on the card both y and dx run on the TMA + ``wgmma``
conv mainloop (``ops/conv3x3_wgmma.py``, ``csrc/conv3x3_wgmma.cu``), which
takes C a multiple of 64 and Co a multiple of 128 (dx: the other way round,
so both multiples of 128 for a backward) and raises otherwise. float32 on the
card stays on the float link's kernel with an identity epilogue
(``ops.conv_block.conv_block_fp(identity=True)``): it exists for card-vs-CPU
parity.

The backward follows the JAX package: ``dx`` is the same convolution on
``dy`` with the spatially flipped, in/out-transposed kernel; ``dW`` is left
to a stock convolution, accumulated in float32. The bfloat16 kernel reads
the weight K-major, (9, Co, C): the forward makes that one transposing copy
(with the cast to bfloat16), and dx reads the (3, 3, C, Co) kernel as it
lies, which is its K-major (9, C, Co) with the taps reversed. As in the JAX
package, nothing in the models calls it: the dispatch that did was removed
there after it lost on the TPU.
"""

from __future__ import annotations

import torch

from ..utils import profiler
from . import conv3x3_wgmma
from .conv_block import _check_on_card, _full_float32_matmul, conv_block_fp, conv_block_fp_plain


def conv3x3_wide_plain(x, kernel):
    """Plain PyTorch version of the forward (no gradient of its own: autograd
    differentiates it)."""
    return conv_block_fp_plain(x.contiguous(), kernel.to(x.dtype).contiguous(), identity=True)


def wgmma_weights(kernel, backward=False):
    """The bfloat16 K-major taps the card's kernel reads: for y the transposing
    copy (9, Co, C); for dx the kernel as it lies, (9, C, Co), which the
    kernel reads with its taps reversed."""
    kh, kw, c, co = kernel.shape
    if backward:
        return kernel.to(torch.bfloat16).contiguous().view(9, c, co)
    kt = torch.empty((kh, kw, co, c), dtype=torch.bfloat16, device=kernel.device)
    kt.copy_(kernel.permute(0, 1, 3, 2))
    return kt.view(9, co, c)


def conv_or_dx_work(x, kernel, backward=False):
    """(operations, bytes) of one K9 call (PERF.md's bound of K9): 9 x C x
    Co multiply-adds an output pixel, padding taps included; x, the kernel
    and the output each moved once in x's dtype."""
    b, h, w, c = x.shape
    co = kernel.shape[2] if backward else kernel.shape[3]
    return (2 * b * h * w * 9 * c * co,
            (x.numel() + kernel.numel() + b * h * w * co) * x.element_size())


@profiler.counted("conv3x3_wide", conv_or_dx_work)
def conv_or_dx(x, kernel, backward=False):
    """y (or, with ``backward``, dx = the conv of dy = x with the flipped,
    transposed kernel) on the card or, for a CPU tensor, the plain version:
    one launch, counted, without autograd."""
    x = x.contiguous()
    if x.device.type == "cuda" and x.dtype == torch.bfloat16:
        wk = wgmma_weights(kernel, backward)
        b, h, w, c = x.shape
        co = wk.shape[1]
        if not conv3x3_wgmma.takes(c, co):
            raise ValueError(f"conv3x3_wide: the bfloat16 kernel takes C % 64 == 0 and Co % 128 "
                             f"== 0 for {'dx' if backward else 'y'}, not C {c}, Co {co}")
        _check_on_card("conv3x3_wide", [x, wk])
        out = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
        conv3x3_wgmma.launch(x, wk, out, "conv", padded=False, flip=backward)
        conv3x3_wide.launches += 1
        return out
    k = kernel.flip(0, 1).transpose(2, 3) if backward else kernel
    k = k.to(x.dtype).contiguous()
    if x.device.type == "cpu":
        return conv_block_fp_plain(x, k, identity=True)
    # counted here, not as a launch of the float link
    before, routes = conv_block_fp.launches, dict(conv_block_fp.route_launches)
    y = conv_block_fp(x, k, identity=True)
    conv3x3_wide.launches += conv_block_fp.launches - before
    conv_block_fp.launches = before
    conv_block_fp.route_launches.update(routes)
    return y


class _Conv3x3Wide(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return conv_or_dx(x, kernel)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_or_dx(dy.to(x.dtype), kernel, backward=True)
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
