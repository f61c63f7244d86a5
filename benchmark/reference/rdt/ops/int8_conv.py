"""K7: the first-generation fused int8 conv link of the frozen LiDAR teacher.

Counterpart of ``radardistill_tpu/ops/pallas_int8_conv.py`` (``_chain_kernel``,
entered through ``int8_block_conv`` -> ``_chain_call``). The math is K1's
(``ops/conv_block.py``): int8 x int8 -> int32 conv, dequant and BN affine,
optional int8 residual, relu, mask, requantization to the next int8 carry.
The operands are this generation's own:

  - the input arrives **pre-padded in H**: ``int8_block_conv`` pads the carry
    with ``(1, kh - 2)`` rows of ``zpad = -zero`` (the code that dequantizes
    to an exact 0) and hands the kernel ``(B, H + kh - 1, W, C)``; columns are
    not padded, the kernel reads ``zpad`` beyond them;
  - the mask is **lane-expanded**, a full ``(B, H, W, Co)`` int8 tensor read
    per output channel (it may differ from channel to channel);
  - the output is int8 only.

The teacher's ``INT8_STAGES: 5`` chain enters its dense conv5 stage through
this link ((2, 2, 1024, 256) on the space-to-depth packing of the stage-4
carry, all-ones mask), and ``CONV_BLOCK_V1=1`` sends every link through it
(``ops.conv_block.int8_block``). The TPU kernel's padding of W to 8 and of C
and Co to 128 lanes is not carried over.

``chain_conv`` is, in this copy, ``chain_conv_plain`` on every device,
counted as K7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiler
from .conv_block import int_conv_exact, link_constants, link_epilogue_flops, link_taps


def _check(xp, kq, ab, mask_q, res):
    if xp.dim() != 4 or kq.dim() != 4 or mask_q.dim() != 4:
        raise ValueError("chain_conv: x, kernel and mask must be 4-D")
    kh, kw, c, co = kq.shape
    b, hp, w, cx = xp.shape
    h = hp - (kh - 1)
    if kh != kw or kh not in (2, 3) or cx != c or h <= 0:
        raise ValueError(f"chain_conv: kernel {tuple(kq.shape)} on padded x {tuple(xp.shape)}")
    if tuple(mask_q.shape) != (b, h, w, co):
        raise ValueError(f"chain_conv: mask {tuple(mask_q.shape)}, want {(b, h, w, co)}")
    if tuple(ab.shape) != (8, co):
        raise ValueError(f"chain_conv: ab {tuple(ab.shape)}, want (8, {co})")
    if res is not None and tuple(res.shape) != (b, h, w, co):
        raise ValueError(f"chain_conv: residual {tuple(res.shape)}, want {(b, h, w, co)}")
    if (xp.dtype != torch.int8 or kq.dtype != torch.int8 or mask_q.dtype != torch.int8
            or ab.dtype != torch.float32 or (res is not None and res.dtype != torch.int8)):
        raise TypeError(f"chain_conv: x {xp.dtype}, kernel {kq.dtype}, mask {mask_q.dtype}, "
                        f"ab {ab.dtype}")


def chain_conv_plain(xp, kq, ab, mask_q, res=None, zpad: int = 0):
    """Plain PyTorch version of the kernel: same integers, same float32
    operations in the same order."""
    _check(xp, kq, ab, mask_q, res)
    kh = kq.shape[0]
    acc = int_conv_exact(xp, kq, 1, ((0, 0), (1, kh - 2)), zpad)
    y = acc.to(torch.float32) * ab[0] + ab[1]
    if res is not None:
        y = y + (res.to(torch.float32) * ab[3, 0] + ab[4, 0])
    y = torch.relu(y) * mask_q.to(torch.float32)
    return torch.clamp(torch.round(y * ab[2, 0]) - 127.0, -127.0, 127.0).to(torch.int8)


def chain_conv_work(xp, kq, ab, mask_q, res=None, zpad: int = 0, variant=None):
    """(operations, bytes) of one K7 call, K1's formula on the link's own
    H x W (the ``zpad`` rows of xp are padding, which the kernel never reads):
    the int8 multiply-adds over the real taps and the epilogue with a mask
    per output channel; x's interior, kernel, mask, constants and residual
    read once, the output written once."""
    kh, _, c, co = kq.shape
    b, hp, w, _ = xp.shape
    h = hp - (kh - 1)
    ops = (2 * b * c * co * link_taps(h, w, kh)
           + link_epilogue_flops(b * h * w, co, co, res is not None, torch.int8))
    nbytes = (b * h * w * c + kq.numel() + mask_q.numel() + b * h * w * co
              + ab.numel() * ab.element_size() + (0 if res is None else res.numel()))
    return ops, nbytes


@profiler.counted("chain_conv", chain_conv_work)
def chain_conv(xp, kq, ab, mask_q, res=None, zpad: int = 0, variant=None):
    """xp (B, H + kh - 1, W, C) int8, padded in H with (1, kh - 2) rows of
    ``zpad``; kernel (kh, kh, C, Co) int8 HWIO; ab (8, Co) float32 (rows:
    alpha, beta, s_out, rs, rsh); mask (B, H, W, Co) int8; res (B, H, W, Co)
    int8 or None -> (B, H, W, Co) int8: the plain version, whatever
    ``variant`` (the program's route) says."""
    return chain_conv_plain(xp, kq, ab, mask_q, res, zpad)


def int8_block_conv(xc, kq, sw, bias, gt, sh, bound, mask_q, res=None, block=chain_conv):
    """One fused chain link, the JAX function's contract: xc and res are
    carries ``(q int8 NHWC, bound, zero)``; kq (kh, kh, C, Co) int8 with its
    scales ``sw``, kh 3 (padding (1, 1)) or 2 (padding (1, 0), the
    space-to-depth packed strided conv); ``gt``, ``sh`` the eval-BN affine and
    ``bound`` its analytic output bound; mask_q (B, H, W, Co) int8. Returns the
    next carry ``(q, b_out, 127.0)``. ``block`` is the convolution
    (``chain_conv``, or ``chain_conv_plain`` to force the plain version)."""
    xq, _, zero = xc
    kh = kq.shape[0]
    ab, b_out = link_constants(xc, kq, sw, bias, gt, sh, bound, res)
    zpad = -int(zero)
    xp = F.pad(xq, (0, 0, 0, 0, 1, kh - 2), value=zpad)
    q = block(xp, kq, ab, mask_q.contiguous(), None if res is None else res[0], zpad=zpad)
    return q, b_out, 127.0
