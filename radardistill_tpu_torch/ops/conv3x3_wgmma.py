"""The Hopper conv mainloop (``csrc/conv3x3_wgmma.cu``): TMA loads into
mbarrier rings, ``wgmma`` from shared memory, a persistent grid.

Five wrappers launch it and count their launches: K1's ``conv_block`` and
K6's ``conv_block_fp`` on their ``wgmma`` routes (``ops/conv_block.py``, the
fused int8 and bfloat16 links, 3x3 or 2x2; the Co-64 links of both on the
kernel's transposed form), K7's ``chain_conv`` on its ``wgmma`` route
(``ops/int8_conv.py``: K1's link on a pre-padded input and a mask per output
channel, its Co-64 links on the transposed form too), K9's ``conv3x3_wide``
(``ops/wide_conv.py``, bfloat16 y and dx) and P1's ``conv_probe(...,
route="wgmma")`` (``ops/probes.py``, ``conv``, ``dots`` and ``int8``). This
module holds what they share: the shapes the kernel takes and the bare ctypes
calls on tensors the caller prepared, which ``chip_smoke.py`` also times
alone. It has no plain version of its own: each wrapper keeps the
plain version of its function.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MODES = ("conv", "dots", "int8")


def takes(c: int, co: int, int8: bool = False) -> bool:
    """The kernel stages 128 bytes of input channels at a time (C a multiple
    of 64 in bfloat16, of 128 in int8) and 128 output channels per tile."""
    return c > 0 and co > 0 and c % (128 if int8 else 64) == 0 and co % 128 == 0


def takes_link(c: int, co: int) -> bool:
    """K1's and K7's int8 link: C and Co multiples of 128 (the mainloop), or
    Co exactly 64 (the transposed kernel: the 64 channels as ``wgmma``'s M)
    with C a multiple of 64 (chunks of 64 channels, 64 bytes in the 64-byte
    swizzle)."""
    return takes(c, co, int8=True) or (co == 64 and c > 0 and c % 64 == 0)


def takes_fp(c: int, co: int) -> bool:
    """K6's link: C a multiple of 64 bfloat16 channels (one 128-byte chunk),
    Co a multiple of 128 (tiles of 128 channels) or exactly 64 (the
    transposed kernel: the 64 channels as ``wgmma``'s M)."""
    return c > 0 and c % 64 == 0 and (co == 64 or (co > 0 and co % 128 == 0))


def wgmma_taps(k: torch.Tensor) -> torch.Tensor:
    """The taps (kh, kh, C, Co) or (kh * kh, C, Co) as the kernel reads them,
    K-major (kh * kh, Co, C): one transposing copy."""
    c, co = k.shape[-2:]
    return k.reshape(-1, c, co).transpose(1, 2).contiguous()


def launch(x: torch.Tensor, wk: torch.Tensor, out: torch.Tensor, mode: str, padded: bool,
           flip: bool = False, scale: torch.Tensor | None = None, relu: bool = False) -> None:
    """One launch into ``out``, nothing allocated and nothing counted.

    x (B, Hin, W, C): unpadded (``padded=False``, Hin = H, the conv's padding
    rows read as zero) or with one zero row above and below (Hin = H + 2);
    wk (9, Co, C), the taps K-major, read in reverse order with ``flip``; out
    (B, H, W, Co). ``mode``: ``conv``, ``dots`` (every tap reads the centre
    pixel) in bfloat16, or ``int8`` (the ``dots`` products in int8, then P1's
    requant with ``scale`` (Co,) float32 and ``relu``). The caller has checked
    device, dtype, contiguity and :func:`takes`."""
    b, hin, w, c = x.shape
    rc = cuda_lib.lib().rdt_conv3x3_wgmma(
        x.data_ptr(), wk.data_ptr(), None if scale is None else scale.data_ptr(), out.data_ptr(),
        b, hin, out.shape[1], w, c, wk.shape[1], 0 if padded else -1, MODES.index(mode),
        int(flip), int(relu), x.device.index, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv3x3_wgmma")


def launch_link(x: torch.Tensor, wk: torch.Tensor, ab: torch.Tensor, mask: torch.Tensor,
                res: torch.Tensor | None, wsum: torch.Tensor, out: torch.Tensor,
                zpad: int, lib=None) -> None:
    """One launch of K1's link into ``out``, nothing allocated and nothing
    counted: x (B, H, W, C) int8, wk (kh * kh, Co, C) int8 (the taps K-major),
    ab (8, Co) float32, mask (B, H, W, nph) int8 with nph 1, 2 or 4, res (B, H,
    W, Co) int8 or None, wsum (kh * kh, Co) int32 (wk summed over C), out (B,
    H, W, Co) int8 or bfloat16; padding cells hold ``zpad``. The caller has
    checked device, dtype, contiguity, alignment and :func:`takes_link`.
    ``lib``: the library to call, ``cuda_lib.lib()`` unless another build of
    this kernel is given (bound with ``cuda_lib.bind``)."""
    b, h, w, c = x.shape
    taps, co = wk.shape[:2]
    rc = (lib or cuda_lib.lib()).rdt_conv_block_wgmma(
        x.data_ptr(), wk.data_ptr(), ab.data_ptr(), mask.data_ptr(),
        None if res is None else res.data_ptr(), wsum.data_ptr(), out.data_ptr(),
        b, h, w, c, co, 3 if taps == 9 else 2, mask.shape[-1], int(zpad),
        0 if out.dtype == torch.int8 else 2, x.device.index, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv_block (wgmma)")


def interior_rows(xp: torch.Tensor, kh: int) -> torch.Tensor:
    """The rows of K7's padded input (B, H + kh - 1, W, C) that hold the
    image, ``xp[:, 1 : 1 + H]``: a view (no copy) whose image stride is
    still xp's, as the kernel's tensor map reads it."""
    return xp[:, 1:xp.shape[1] - (kh - 2)]


def launch_chain(xp: torch.Tensor, wk: torch.Tensor, ab: torch.Tensor, mask: torch.Tensor,
                 res: torch.Tensor | None, wsum: torch.Tensor, out: torch.Tensor,
                 zpad: int, lib=None) -> None:
    """One launch of K7's link into ``out``, nothing allocated and nothing
    counted: xp (B, H + kh - 1, W, C) int8, padded in H by the caller with
    (1, kh - 2) rows of ``zpad``, of which the kernel reads only
    :func:`interior_rows` (its border is K1's exact correction, so the
    padding rows need not be read); wk (kh * kh, Co, C) int8 (the taps
    K-major), ab (8, Co) float32, mask (B, H, W, Co) int8 (a byte per output
    channel), res (B, H, W, Co) int8 or None, wsum (kh * kh, Co) int32, out
    (B, H, W, Co) int8. Co 64 runs the transposed kernel, whose tensor map
    reads the same interior rows. The caller has checked device, dtype,
    contiguity, alignment and :func:`takes_link`. ``lib`` as for
    :func:`launch_link`."""
    taps, co = wk.shape[:2]
    kh = 3 if taps == 9 else 2
    x = interior_rows(xp, kh)
    b, h, w, c = x.shape
    rc = (lib or cuda_lib.lib()).rdt_chain_conv_wgmma(
        x.data_ptr(), wk.data_ptr(), ab.data_ptr(), mask.data_ptr(),
        None if res is None else res.data_ptr(), wsum.data_ptr(), out.data_ptr(),
        b, h, w, c, co, kh, x.stride(0) // (w * c), int(zpad), x.device.index,
        cuda_lib.stream_of(x))
    cuda_lib.check(rc, "chain_conv (wgmma)")


def launch_fp_link(x: torch.Tensor, wk: torch.Tensor, ab: torch.Tensor, mask: torch.Tensor,
                   res: torch.Tensor | None, out: torch.Tensor, lib=None) -> None:
    """One launch of K6's link into ``out``, nothing allocated and nothing
    counted: x (B, H, W, C) bfloat16, wk (kh * kh, Co, C) bfloat16 (the taps
    K-major), ab (2, Co) float32, mask (B, H, W, nph) int8 with nph 1, 2 or 4,
    res (B, H, W, Co) bfloat16 or None, out (B, H, W, Co) bfloat16; padding
    cells read zero. The caller has checked device, dtype, contiguity,
    alignment and :func:`takes_fp`. ``lib`` as for :func:`launch_link`."""
    b, h, w, c = x.shape
    taps, co = wk.shape[:2]
    rc = (lib or cuda_lib.lib()).rdt_conv_block_fp_wgmma(
        x.data_ptr(), wk.data_ptr(), ab.data_ptr(), mask.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(), b, h, w, c, co,
        3 if taps == 9 else 2, mask.shape[-1], x.device.index, cuda_lib.stream_of(x))
    cuda_lib.check(rc, "conv_block_fp (wgmma)")
