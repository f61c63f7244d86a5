"""K1 and K6: the fused int8 and float conv links of the frozen LiDAR teacher.

Counterpart of ``radardistill_tpu/ops/pallas_conv_block.py`` (``_block_kernel``
in int8 mode, entered through ``int8_block`` -> ``int8_block_conv_v2``). One
link is

    acc = conv(x, k)                       int8 x int8 -> int32, stride 1
    y   = acc * alpha + beta               float32, per output channel
    y   = y + (r * rs + rsh)               with a residual carry r (int8)
    y   = relu(y) * mask                   compact phase mask
    q   = clip(round(y * s_out) - 127, -127, 127)   int8 out (half-to-even)

with a 3x3 window padded (1, 1) or a 2x2 window padded (1, 0) per dimension.
Cells of the padding hold ``zpad = -zero``, the code that dequantizes to an
exact 0. The mask is compact: ``(B, H, W, nph)`` with phase ``p`` covering the
output channels ``[p * Co/nph, (p+1) * Co/nph)``; ``nph`` is 1 on a dense grid
and 4 on the space-to-depth packed grid. With ``out_dtype`` float32 or
bfloat16 the link writes ``y`` and skips the requantization (a chain's last
link).

``int8_block_conv_v2`` builds the epilogue's constants (``alpha``, ``beta``,
``s_out``, ``rs``, ``rsh``) in float32 from the carry's bound, the kernel's
per-channel scales and the eval-BN affine, in the JAX package's order of
operations, and hands them to ``conv_block`` as one ``(8, Co)`` tensor that
stays on the device (the bounds are device scalars; nothing syncs).

``conv_block`` is, in this copy, ``conv_block_plain`` on every device: an
exact integer convolution, then the same float32 epilogue one operation at
a time, counted as K1 (``conv_block_work``).

``int8_block`` is the dispatcher the backbone calls: the link above, or with
``CONV_BLOCK_V1=1`` in the environment the first-generation link of
``ops/int8_conv.py`` (K7) on the lane-expanded mask.

K6, the float link (counterpart of ``_block_kernel`` in bf16 mode, entered
through ``fp_block_conv``), for the stages a ``FP_STAGES`` teacher runs fused:

    acc = conv(x, k)                       x's dtype, float32 accumulation
    y   = acc * gt + (bias * gt + shift)   float32, the eval-BN affine
    y   = y + r                            with a residual r, as float32
    out = relu(y) * mask                   rounded once to x's dtype

``fp_block_conv`` casts the kernel to x's dtype and builds the affine;
``conv_block_fp`` is ``conv_block_fp_plain`` on every device, counted as K6.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils import profiler


@contextlib.contextmanager
def _full_float32_matmul():
    """float32 matmuls and convolutions in full float32 (no TF32) while the
    body runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def int_conv_exact(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                   padding: Tuple[Tuple[int, int], Tuple[int, int]], pad_value: int = 0):
    """Exact int8 x int8 NHWC conv with an int32 result, from stock ops.

    xq (B, H, W, C) int8, kq (kh, kw, C, Co) int8 HWIO, explicit padding
    ((top, bottom), (left, right)) filled with ``pad_value``. One float32
    matmul per tap (every partial sum is an integer below 2**24 while
    C * 127² < 2**24, so the matmul is exact in any summation order; wider
    inputs take float64), summed over the taps in int32."""
    kh, kw, c, co = kq.shape
    b, h, w, _ = xq.shape
    (pt, pb), (pl, pr) = padding
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb), value=pad_value)
    ho = (h + pt + pb - kh) // stride + 1
    wo = (w + pl + pr - kw) // stride + 1
    dt = torch.float32 if c * 127 * 127 < 2 ** 24 else torch.float64
    xf, kf = xp.to(dt), kq.to(dt)
    acc = torch.zeros((b * ho * wo, co), dtype=torch.int32, device=xq.device)
    with _full_float32_matmul():
        for ky in range(kh):
            for kx in range(kw):
                xs = xf[:, ky:ky + (ho - 1) * stride + 1:stride,
                        kx:kx + (wo - 1) * stride + 1:stride]
                acc += torch.matmul(xs.reshape(-1, c), kf[ky, kx]).to(torch.int32)
    return acc.reshape(b, ho, wo, co)


def _check(xq, kq, ab, mask_c, res, out_dtype):
    if xq.dim() != 4 or kq.dim() != 4 or mask_c.dim() != 4:
        raise ValueError("conv_block: x, kernel and mask must be 4-D")
    kh, kw, c, co = kq.shape
    b, h, w, cx = xq.shape
    nph = mask_c.shape[-1]
    if kh != kw or kh not in (2, 3) or cx != c:
        raise ValueError(f"conv_block: kernel {tuple(kq.shape)} on x {tuple(xq.shape)}")
    if tuple(mask_c.shape[:3]) != (b, h, w) or co % nph:
        raise ValueError(f"conv_block: mask {tuple(mask_c.shape)} for out (.., {co})")
    if tuple(ab.shape) != (8, co):
        raise ValueError(f"conv_block: ab {tuple(ab.shape)}, want (8, {co})")
    if res is not None and tuple(res.shape) != (b, h, w, co):
        raise ValueError(f"conv_block: residual {tuple(res.shape)}, want {(b, h, w, co)}")
    if (xq.dtype != torch.int8 or kq.dtype != torch.int8 or mask_c.dtype != torch.int8
            or ab.dtype != torch.float32 or (res is not None and res.dtype != torch.int8)
            or out_dtype not in (torch.int8, torch.float32, torch.bfloat16)):
        raise TypeError(f"conv_block: x {xq.dtype}, kernel {kq.dtype}, mask {mask_c.dtype}, "
                        f"ab {ab.dtype}, out {out_dtype}")


def conv_block_plain(xq, kq, ab, mask_c, res=None, zpad: int = 0, out_dtype=torch.int8):
    """Plain PyTorch version of the kernel: same integers, same float32
    operations in the same order (a multiply and an add are two roundings)."""
    _check(xq, kq, ab, mask_c, res, out_dtype)
    kh, co, nph = kq.shape[0], kq.shape[3], mask_c.shape[-1]
    pad = (1, 1) if kh == 3 else (1, 0)
    acc = int_conv_exact(xq, kq, 1, (pad, pad), zpad)
    y = acc.to(torch.float32) * ab[0] + ab[1]
    if res is not None:
        y = y + (res.to(torch.float32) * ab[3, 0] + ab[4, 0])
    y = torch.relu(y)
    y = y * mask_c.to(torch.float32).repeat_interleave(co // nph, dim=-1)
    if out_dtype != torch.int8:
        return y.to(out_dtype)
    return torch.clamp(torch.round(y * ab[2, 0]) - 127.0, -127.0, 127.0).to(torch.int8)


def link_taps(h: int, w: int, kh: int) -> int:
    """(output pixel, tap) pairs of a link's window over an h x w image that
    read a real input cell (3x3 padded (1, 1), 2x2 padded (1, 0)): the taps
    XLA's convolution count takes, padding taps left out."""
    return profiler.real_taps(h, h, kh, 1, 1) * profiler.real_taps(w, w, kh, 1, 1)


def link_epilogue_flops(pixels: int, co: int, nph: int, res: bool, out_dtype) -> int:
    """Operations of an int8 link's epilogue, one an elementwise op of the
    plain version: per output ``acc * alpha + beta`` with its conversion (3),
    the residual's conversion, affine and add (4), the relu and the mask's
    multiply (2), and the requantization (5: scale, round, shift, clip, cast)
    or the cast of a bfloat16 output (1); per pixel the mask's ``nph``
    conversions."""
    per = 5 + (4 if res else 0) + (5 if out_dtype == torch.int8
                                   else int(out_dtype != torch.float32))
    return pixels * (co * per + nph)


def conv_block_work(xq, kq, ab, mask_c, res=None, zpad: int = 0, out_dtype=torch.int8,
                    variant: Optional[str] = None):
    """(operations, bytes) of one K1 call, the figures of PERF.md's bound of
    K1: the int8 multiply-adds over the real taps (2 operations each) and
    the epilogue (:func:`link_epilogue_flops`); x, kernel, mask, constants and
    residual read once, the output written once."""
    b, h, w, c = xq.shape
    kh, co, nph = kq.shape[0], kq.shape[3], mask_c.shape[-1]
    ops = (2 * b * c * co * link_taps(h, w, kh)
           + link_epilogue_flops(b * h * w, co, nph, res is not None, out_dtype))
    nbytes = (xq.numel() + kq.numel() + mask_c.numel() + b * h * w * co * out_dtype.itemsize
              + ab.numel() * ab.element_size() + (0 if res is None else res.numel()))
    return ops, nbytes


@profiler.counted("conv_block", conv_block_work)
def conv_block(xq, kq, ab, mask_c, res=None, zpad: int = 0, out_dtype=torch.int8,
               variant: Optional[str] = None):
    """x (B, H, W, C) int8, kernel (kh, kh, C, Co) int8 in its natural HWIO
    layout, ab (8, Co) float32 (rows: alpha, beta, s_out, rs, rsh), mask
    (B, H, W, nph) int8, res (B, H, W, Co) int8 or None -> (B, H, W, Co) in
    ``out_dtype`` (int8, float32 or bfloat16): the plain version, whatever
    ``variant`` (the program's route) says."""
    return conv_block_plain(xq, kq, ab, mask_c, res, zpad, out_dtype)


def link_constants(xc, kq, sw, bias, gt, sh, bound, res=None):
    """The epilogue's constants of one int8 link as one (8, Co) float32 tensor
    (rows: alpha, beta, s_out, rs, rsh) and the output carry's bound, in the
    JAX package's order of float32 operations. Both generations of the link
    build them the same way."""
    xq, bnd, zero = xc
    co = kq.shape[-1]
    f32 = torch.float32
    s_in = torch.clamp(bnd.to(f32), min=1e-8) / (127.0 + zero)
    alpha = (s_in * sw * gt).to(f32)
    ksum = kq.to(f32).sum(dim=(0, 1, 2))
    beta = zero * ksum * alpha
    if bias is not None:
        beta = beta + bias * gt
    beta = (beta + sh).to(f32)
    ab = torch.zeros((8, co), dtype=f32, device=xq.device)
    ab[0], ab[1] = alpha, beta
    if res is not None:
        _, rb, rz = res
        rs = torch.clamp(rb.to(f32), min=1e-8) / (127.0 + rz)
        b_out = bound + rb
        ab[3], ab[4] = rs, rz * rs
    else:
        b_out = bound
    ab[2] = 254.0 / torch.clamp(b_out, min=1e-8)
    return ab, b_out


def int8_block_conv_v2(xc, kq, sw, bias, gt, sh, bound, mask_c, res=None,
                       deq_out: Optional[torch.dtype] = None, block=conv_block):
    """One fused int8 chain link, the JAX function's contract.

    xc = (xq int8 (B, H, W, C), bound, zero): the carry, dequantized as
    ``(xq + zero) * max(bound, 1e-8) / (127 + zero)``; ``zero`` is a Python
    number (0 symmetric, 127 for a post-relu carry), ``bound`` a float32
    scalar tensor. kq (kh, kh, C, Co) int8 with per-channel scales ``sw``;
    ``bias`` (Co,) or None; ``gt``, ``sh`` the eval-BN affine and ``bound`` its
    analytic output bound; mask_c (B, H, W, nph) int8; res an optional carry
    added before the relu. Returns the next carry ``(q, b_out, 127.0)``, or
    with ``deq_out`` the link's float output in that dtype. ``block`` is the
    convolution (``conv_block``, or ``conv_block_plain`` to force the plain
    version on any device)."""
    xq, _, zero = xc
    ab, b_out = link_constants(xc, kq, sw, bias, gt, sh, bound, res)
    out = block(xq, kq, ab, mask_c, None if res is None else res[0], zpad=-int(zero),
                out_dtype=deq_out if deq_out is not None else torch.int8)
    if deq_out is not None:
        return out
    return out, b_out, 127.0


def int8_block(xc, kq, sw, bias, gt, sh, bound, mask_c, res=None, deq_out=None):
    """The chain link the backbone calls (the JAX package's dispatcher of the
    same name): the link above, or with ``CONV_BLOCK_V1=1`` in the environment
    the first-generation link (``ops/int8_conv.py``) on the lane-expanded mask.
    That link has no float output: with ``deq_out`` its int8 carry is
    dequantized, one requantization more than the link above makes."""
    if os.environ.get("CONV_BLOCK_V1") == "1":
        from .int8_conv import int8_block_conv

        co = kq.shape[-1]
        mq = mask_c.repeat_interleave(co // mask_c.shape[-1], dim=-1)
        q, b_out, zero = int8_block_conv(xc, kq, sw, bias, gt, sh, bound, mq, res=res)
        if deq_out is not None:
            # layers.deq8, written out (layers imports this module)
            return ((q.float() + zero) * (torch.clamp(b_out, min=1e-8) / (127.0 + zero))
                    ).to(deq_out)
        return q, b_out, zero
    return int8_block_conv_v2(xc, kq, sw, bias, gt, sh, bound, mask_c, res=res,
                              deq_out=deq_out)


# ------------------------------------------------------------------ K6


def _check_fp(x, k, ab, mask_c, res, identity):
    if x.dim() != 4 or k.dim() != 4:
        raise ValueError("conv_block_fp: x and kernel must be 4-D")
    kh, kw, c, co = k.shape
    b, h, w, cx = x.shape
    if kh != kw or kh not in (2, 3) or cx != c:
        raise ValueError(f"conv_block_fp: kernel {tuple(k.shape)} on x {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or k.dtype != x.dtype:
        raise TypeError(f"conv_block_fp: x {x.dtype}, kernel {k.dtype}")
    if identity:
        if ab is not None or mask_c is not None or res is not None:
            raise ValueError("conv_block_fp: the bare convolution takes no epilogue operand")
        return
    if mask_c.dim() != 4 or tuple(mask_c.shape[:3]) != (b, h, w) or co % mask_c.shape[-1]:
        raise ValueError(f"conv_block_fp: mask {tuple(mask_c.shape)} for out (.., {co})")
    if tuple(ab.shape) != (2, co):
        raise ValueError(f"conv_block_fp: ab {tuple(ab.shape)}, want (2, {co})")
    if res is not None and tuple(res.shape) != (b, h, w, co):
        raise ValueError(f"conv_block_fp: residual {tuple(res.shape)}, want {(b, h, w, co)}")
    if (mask_c.dtype != torch.int8 or ab.dtype != torch.float32
            or (res is not None and res.dtype != x.dtype)):
        raise TypeError(f"conv_block_fp: mask {mask_c.dtype}, ab {ab.dtype}, "
                        f"res {None if res is None else res.dtype}")


def conv_block_fp_plain(x, k, ab=None, mask_c=None, res=None, identity=False):
    """Plain PyTorch version of the float kernel: the convolution of x and k
    (values of x's dtype) accumulated in float32 without TF32, then the
    float32 epilogue one operation at a time, rounded once to x's dtype."""
    _check_fp(x, k, ab, mask_c, res, identity)
    kh, co = k.shape[0], k.shape[3]
    lo, hi = 1, kh - 2
    xn = F.pad(x.float().permute(0, 3, 1, 2), (lo, hi, lo, hi))
    with _full_float32_matmul():
        acc = F.conv2d(xn, k.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    if identity:
        return acc.to(x.dtype).contiguous()
    y = acc * ab[0] + ab[1]
    if res is not None:
        y = y + res.float()
    y = torch.relu(y)
    y = y * mask_c.to(torch.float32).repeat_interleave(co // mask_c.shape[-1], dim=-1)
    return y.to(x.dtype).contiguous()


def conv_block_fp_work(x, k, ab=None, mask_c=None, res=None, identity=False,
                       variant: Optional[str] = None):
    """(operations, bytes) of one K6 call, the figures of PERF.md's bound of
    K6: the multiply-adds over the real taps (2 operations each) and the
    epilogue, one an elementwise op of the plain version (per output the
    affine 2, the residual's conversion and add 2, the relu and the mask's
    multiply 2, the cast to bfloat16 1; per pixel the mask's ``nph``
    conversions; the bare convolution only its cast); x, kernel, mask,
    constants and residual read once, the output written once."""
    b, h, w, c = x.shape
    kh, co = k.shape[0], k.shape[3]
    cast = int(x.dtype != torch.float32)
    if identity:
        epilogue = b * h * w * co * cast
    else:
        per = 4 + (2 if res is not None else 0) + cast
        epilogue = b * h * w * (co * per + mask_c.shape[-1])
    nbytes = (x.numel() + k.numel() + b * h * w * co
              + (0 if res is None else res.numel())) * x.element_size()
    if not identity:
        nbytes += mask_c.numel() * mask_c.element_size() + ab.numel() * ab.element_size()
    return 2 * b * c * co * link_taps(h, w, kh) + epilogue, nbytes


@profiler.counted("conv_block_fp", conv_block_fp_work)
def conv_block_fp(x, k, ab=None, mask_c=None, res=None, identity=False,
                  variant: Optional[str] = None):
    """x (B, H, W, C) bfloat16 or float32, kernel (kh, kh, C, Co) in x's dtype
    and its natural HWIO layout, ab (2, Co) float32 (rows: alpha, beta), mask
    (B, H, W, nph) int8, res (B, H, W, Co) in x's dtype or None -> (B, H, W,
    Co) in x's dtype; with ``identity`` the bare convolution of x and k: the
    plain version, whatever ``variant`` (the program's route) says."""
    return conv_block_fp_plain(x, k, ab, mask_c, res, identity)


def fp_block_conv(x, kernel, bias, gt, sh, mask_c, res=None, block=conv_block_fp):
    """One fused float chain link, the JAX function's contract:
    ``relu(conv(x) * gt + (bias * gt + sh) [+ res]) * mask`` in x's dtype.

    x (B, H, W, C) bfloat16 or float32; kernel (kh, kh, C, Co) the raw float
    parameters, cast to x's dtype before the product (the BN affine is not
    folded into them); ``bias`` (Co,) or None; ``gt``, ``sh`` the eval-BN
    affine, applied in float32 on the accumulator; mask_c (B, H, W, nph) int8;
    res an optional residual in x's dtype, added before the relu. ``block`` is
    the convolution (``conv_block_fp``, or ``conv_block_fp_plain`` to force
    the plain version on any device)."""
    f32 = torch.float32
    beta = sh if bias is None else bias * gt + sh
    ab = torch.stack([gt.to(f32), beta.to(f32)])
    return block(x, kernel.to(x.dtype).contiguous(), ab, mask_c.contiguous(), res)
