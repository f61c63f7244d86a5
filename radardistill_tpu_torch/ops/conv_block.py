"""K1: the fused int8 conv link of the frozen LiDAR teacher.

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

``conv_block`` on a CPU tensor takes ``conv_block_plain``, the plain PyTorch
version (an exact integer convolution, then the same float32 epilogue one
operation at a time). On a CUDA tensor it launches the kernel
(``csrc/conv_block.cu``), or raises if it cannot.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_lib

OUT_CODES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
# dynamic shared memory a block may ask for on sm_90: 227 KB, less the
# kernel's 1 KB of static shared memory (alpha and beta)
SMEM_LIMIT = 232448 - 1024
TILE_H, TILE_W = 8, 16  # output pixels of one block tile (csrc/conv_block.cu)


@contextlib.contextmanager
def _full_float32_matmul():
    """float32 matmuls in full float32 (no TF32) while the body runs."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


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
            or out_dtype not in OUT_CODES):
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


def smem_bytes(kh: int, c: int, co: int) -> int:
    """Dynamic shared memory of one block of the kernel: the whole repacked
    weight and one input tile with its halo (strides as in the .cu)."""
    c4 = c // 4
    return 4 * (kh * kh * c4 * (co + 8) + (TILE_H + kh - 1) * (TILE_W + kh - 1) * (c4 + 4))


def conv_block(xq, kq, ab, mask_c, res=None, zpad: int = 0, out_dtype=torch.int8):
    """x (B, H, W, C) int8, kernel (kh, kh, C, Co) int8 in its natural HWIO
    layout, ab (8, Co) float32 (rows: alpha, beta, s_out, rs, rsh), mask
    (B, H, W, nph) int8, res (B, H, W, Co) int8 or None -> (B, H, W, Co) in
    ``out_dtype`` (int8, float32 or bfloat16). The CUDA kernel takes C a
    multiple of 32, Co in {16, 32, 64, 128}, and a weight that fits in shared
    memory beside one input tile; the plain version any shape."""
    if xq.device.type == "cpu":
        return conv_block_plain(xq, kq, ab, mask_c, res, zpad, out_dtype)
    _check(xq, kq, ab, mask_c, res, out_dtype)
    tensors = [xq, kq, ab, mask_c] + ([res] if res is not None else [])
    if xq.device.type != "cuda" or any(t.device != xq.device for t in tensors):
        raise ValueError(f"conv_block: tensors on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_block: every tensor must be contiguous")
    kh, _, c, co = kq.shape
    b, h, w, _ = xq.shape
    nph = mask_c.shape[-1]
    if c % 32 or co not in (16, 32, 64, 128):
        raise ValueError(f"conv_block: the kernel takes C % 32 == 0 and Co in "
                         f"(16, 32, 64, 128), not C {c}, Co {co}")
    smem = smem_bytes(kh, c, co)
    if smem > SMEM_LIMIT:
        raise ValueError(f"conv_block: a ({kh}, {kh}, {c}, {co}) weight and one input tile "
                         f"need {smem} bytes of shared memory, over {SMEM_LIMIT}")
    if xq.data_ptr() % 16:
        raise ValueError("conv_block: the kernel loads x 16 bytes at a time; x at "
                         f"{xq.data_ptr():#x}")
    out = torch.empty((b, h, w, co), dtype=out_dtype, device=xq.device)
    rc = cuda_lib.lib().rdt_conv_block(
        xq.data_ptr(), kq.data_ptr(), ab.data_ptr(), mask_c.data_ptr(),
        res.data_ptr() if res is not None else None, out.data_ptr(),
        b, h, w, c, co, kh, nph, int(zpad), OUT_CODES[out_dtype], smem,
        xq.device.index, cuda_lib.stream_of(xq))
    cuda_lib.check(rc, "conv_block")
    conv_block.launches += 1
    return out


conv_block.launches = 0


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
        resq, rb, rz = res
        rs = torch.clamp(rb.to(f32), min=1e-8) / (127.0 + rz)
        b_out = bound + rb
        ab[3], ab[4] = rs, rz * rs
    else:
        resq, b_out = None, bound
    ab[2] = 254.0 / torch.clamp(b_out, min=1e-8)
    out = block(xq, kq, ab, mask_c, resq, zpad=-int(zero),
                out_dtype=deq_out if deq_out is not None else torch.int8)
    if deq_out is not None:
        return out
    return out, b_out, 127.0


def int8_block(xc, kq, sw, bias, gt, sh, bound, mask_c, res=None, deq_out=None):
    """The chain link the backbone calls (the JAX package's dispatcher of the
    same name; its other route, the pre-padded first-generation kernel, is
    not ported)."""
    return int8_block_conv_v2(xc, kq, sw, bias, gt, sh, bound, mask_c, res=res,
                              deq_out=deq_out)
