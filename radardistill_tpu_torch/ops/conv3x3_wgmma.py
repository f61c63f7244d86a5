"""The Hopper 3x3 conv mainloop (``csrc/conv3x3_wgmma.cu``): TMA loads into
mbarrier rings, ``wgmma`` from shared memory, a persistent grid.

Two wrappers launch it and count its launches: K9's ``conv3x3_wide``
(``ops/wide_conv.py``, bfloat16 y and dx) and P1's ``conv_probe(...,
route="wgmma")`` (``ops/probes.py``, ``conv``, ``dots`` and ``int8``). This
module holds what they share: the shapes the kernel takes and the bare ctypes
call on tensors the caller prepared, which ``chip_smoke.py`` also times alone.
It has no plain version of its own: each wrapper keeps the plain version of
its function.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MODES = ("conv", "dots", "int8")


def takes(c: int, co: int, int8: bool = False) -> bool:
    """The kernel stages 128 bytes of input channels at a time (C a multiple
    of 64 in bfloat16, of 128 in int8) and 128 output channels per tile."""
    return c > 0 and co > 0 and c % (128 if int8 else 64) == 0 and co % 128 == 0


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
