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

``chain_conv`` on a CPU tensor takes ``chain_conv_plain``; on a CUDA tensor
it launches the kernel on one of two routes, or raises if the route cannot
take the link. :func:`chain_route_of` is the rule:

  - ``wgmma`` where K1's ``wgmma`` route takes the widths
    (``conv3x3_wgmma.takes_link``: C and Co multiples of 128, or Co 64 with C
    a multiple of 64; that is the conv5 link of ``INT8_STAGES: 5`` and all 24
    links under ``CONV_BLOCK_V1=1``): K1's link on the Hopper conv mainloop
    (``csrc/conv3x3_wgmma.cu``, ``rdt_chain_conv_wgmma``; the Co-64 links on
    its transposed ``conv_co64_kernel``, as K1's), which reads the interior
    rows ``xp[:, 1 : 1 + H]`` through a strided tensor map, never the
    ``zpad`` rows, and gives the border K1's exact int32 correction
    (``conv_block.border_correction``), so its accumulator equals the padded
    convolution's; its epilogue reads the mask per output channel;
  - ``streamed`` for the rest (widths no model of the repository has, e.g.
    C 64 into Co 16, or C 96): ``rdt_chain_conv`` (``csrc/conv_block.cu``,
    the streamed ``mma.sync`` kernel of K1 with this addressing, the same
    product and epilogue device code).

Every int8 code equals K1's on operands both can take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiler
from . import conv3x3_wgmma, cuda_lib
from .conv_block import (_check_on_card, int_conv_exact, link_constants, link_epilogue_flops,
                         link_taps, streamed_co, tap_sums)

ROUTES = ("wgmma", "streamed")


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


def chain_route_of(kh: int, c: int, co: int) -> str:
    """The dispatch rule of ``chain_conv`` on the card: ``wgmma`` where C and
    Co are multiples of 128 or Co is 64 with C a multiple of 64
    (``conv3x3_wgmma.takes_link``; both windows, kh 2 and 3), else
    ``streamed`` (which raises on C % 32 or a Co it has no tile for)."""
    if kh not in (2, 3):
        raise ValueError(f"chain_route_of: kh {kh}")
    return "wgmma" if conv3x3_wgmma.takes_link(c, co) else "streamed"


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
    int8 or None -> (B, H, W, Co) int8. On the card the route is
    :func:`chain_route_of`, or ``variant`` (one of ``ROUTES``) forces one:
    ``wgmma`` takes C and Co multiples of 128, or Co 64 with C a multiple of
    64, ``streamed`` C a multiple of 32 and Co in {16, 32, 64} or a multiple
    of 128; a forced route that does not take the link raises. Each launch
    counts in ``chain_conv.launches`` and ``chain_conv.route_launches[route]``.
    The plain version takes any shape."""
    if xp.device.type == "cpu":
        return chain_conv_plain(xp, kq, ab, mask_q, res, zpad)
    _check(xp, kq, ab, mask_q, res)
    _check_on_card("chain_conv", [xp, kq, ab, mask_q] + ([res] if res is not None else []))
    kh, _, c, co = kq.shape
    b, hp, w, _ = xp.shape
    h = hp - (kh - 1)
    route = chain_route_of(kh, c, co) if variant is None else variant
    out = torch.empty((b, h, w, co), dtype=torch.int8, device=xp.device)
    if route == "wgmma":
        if not conv3x3_wgmma.takes_link(c, co):
            raise ValueError(f"chain_conv: the wgmma route takes C and Co multiples of 128, or "
                             f"Co 64 with C a multiple of 64, not C {c}, Co {co}")
        conv3x3_wgmma.launch_chain(xp, conv3x3_wgmma.wgmma_taps(kq), ab, mask_q, res,
                                   tap_sums(kq), out, zpad)
    elif route == "streamed":
        if c % 32 or not streamed_co(co):
            raise ValueError(f"chain_conv: the streamed kernel takes C % 32 == 0 and Co in (16, "
                             f"32, 64) or a multiple of 128, not C {c}, Co {co}")
        rc = cuda_lib.lib().rdt_chain_conv(
            xp.data_ptr(), kq.data_ptr(), ab.data_ptr(), mask_q.data_ptr(),
            res.data_ptr() if res is not None else None, out.data_ptr(),
            b, h, w, c, co, kh, int(zpad), xp.device.index, cuda_lib.stream_of(xp))
        cuda_lib.check(rc, "chain_conv")
    else:
        raise ValueError(f"chain_conv: variant {variant!r} is not one of {ROUTES}")
    chain_conv.launches += 1
    chain_conv.route_launches[route] += 1
    return out


chain_conv.launches = 0
chain_conv.route_launches = dict.fromkeys(ROUTES, 0)


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
