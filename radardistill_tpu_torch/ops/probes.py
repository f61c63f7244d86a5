"""P1 and P2: the tensor-core probes, ``conv_probe`` and ``mma_rate``.

Counterparts of the two TPU measuring tools ``tools/pallas_conv_proto.py``
(the conv probes: what a 3x3 conv costs beyond its nine products) and
``tools/mxu_rate.py`` (the matrix unit's rate against the width N, operands
resident on chip). No model calls them; ``tools/torch_conv_probe.py`` and
``tools/torch_mma_rate.py`` drive them and print the rate tables.

``mma_rate`` (``csrc/mma_rate.cu``) computes ``sum_r round(A + r) @ B`` on two
routes, ``mma.sync`` and ``wgmma.mma_async`` (the latter with A in
registers: :func:`rotate_plain` is the rule by which both routes form
``round(A + r)`` there); ``conv_probe`` computes one
of three functions of a pre-padded activation (``conv``, ``dots``, ``int8``)
on two routes as well: ``csrc/conv_probe.cu`` (``mma.sync``, one load path for
the three) and the conv mainloop of ``csrc/conv3x3_wgmma.cu``. A CPU tensor
takes the plain PyTorch version beside each; a CUDA tensor launches the kernel,
or raises if it cannot.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiler
from . import conv3x3_wgmma, cuda_lib
from .conv_block import _check_on_card, _full_float32_matmul

ROUTES = ("mma_sync", "wgmma")
RATE_DTYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
MODES = ("conv", "dots", "int8")


def _rate_out_dtype(dtype):
    return torch.int32 if dtype == torch.int8 else dtype


def _check_rate(a, b, reps):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mma_rate: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.dtype not in RATE_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"mma_rate: a {a.dtype}, b {b.dtype}")
    if reps < 1:
        raise ValueError(f"mma_rate: reps {reps}")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: 10 mantissa
    bits kept, to nearest, ties away from zero (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def rotate_plain(a: torch.Tensor, r: int) -> torch.Tensor:
    """``round(a + r)`` in a's type as the kernels form it, one 32-bit
    register word at a time: bfloat16 adds in float32 and rounds once to
    nearest even (``__hadd2``; the float32 sum of a bfloat16 and an integer
    below 8 rounds to the same bfloat16 as the exact sum); int8 adds with
    wrap-around (``__vadd4``); float32 adds in float32, then rounds to TF32
    (:func:`tf32_round`). For bfloat16 and int8 this is ``(a + r).to(a.dtype)``
    of :func:`mma_rate_plain`; for float32 it differs from that by the TF32
    rounding, at most 2**-11 of the value."""
    if a.dtype == torch.bfloat16:
        return (a.float() + r).to(torch.bfloat16)
    if a.dtype == torch.int8:
        return ((a.to(torch.int32) + r + 128) % 256 - 128).to(torch.int8)
    if a.dtype == torch.float32:
        return tf32_round(a + r)
    raise TypeError(f"rotate_plain: {a.dtype}")


def mma_rate_plain(a: torch.Tensor, b: torch.Tensor, reps: int = 8) -> torch.Tensor:
    """Plain PyTorch P2: ``sum over r < reps of (a + r).to(a.dtype) @ b``. The
    add is done and rounded in a's dtype (int8 wraps); products and sums are
    float32 for bfloat16 and float32 operands (full float32, no TF32) and
    exact for int8 (taken in float64, every partial sum below 2**53). The
    result has a's dtype, int32 for int8."""
    _check_rate(a, b, reps)
    wide = torch.float64 if a.dtype == torch.int8 else torch.float32
    bw = b.to(wide)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=wide, device=a.device)
    with _full_float32_matmul():
        for r in range(reps):
            acc += (a + r).to(a.dtype).to(wide) @ bw
    return acc.to(_rate_out_dtype(a.dtype))


def mma_rate_work(a, b, reps=8, route="mma_sync", grid_reps=1):
    """(operations, bytes) of one P2 call (PERF.md's bound of P2): ``reps``
    products of (M, K) x (K, N) for each of ``grid_reps`` passes; a and b
    read once, the sum written once."""
    (m, k), n = a.shape, b.shape[1]
    return (2 * m * k * n * reps * grid_reps,
            (a.numel() + b.numel()) * a.element_size() + m * n * _rate_out_dtype(a.dtype).itemsize)


@profiler.counted("mma_rate", mma_rate_work)
def mma_rate(a: torch.Tensor, b: torch.Tensor, reps: int = 8, route: str = "mma_sync",
             grid_reps: int = 1) -> torch.Tensor:
    """a (M, K), b (K, N), both bfloat16, int8 or float32 -> (M, N) in a's
    dtype (int32 for int8): ``sum over r < reps of round(a + r) @ b``, the sum
    in float32 (int32 for int8). float32 operands are rounded to TF32 for the
    products. ``route`` picks the tensor-core instruction, ``mma.sync`` or
    ``wgmma.mma_async``; both keep a block's operands on chip across the
    ``reps`` products (the ``wgmma`` route holds A in registers and forms
    :func:`rotate_plain` there). ``grid_reps`` repeats the whole grid inside one
    launch (same work, same values) so that a launch lasts long enough to
    time. The kernel takes M a multiple of 64, N a multiple of 32 and K times
    the element size a power of two from 128 to 8192 bytes; b is read
    transposed, so pass ``bt.t()`` of a contiguous (N, K) tensor to avoid a
    copy."""
    if a.device.type == "cpu":
        return mma_rate_plain(a, b, reps)
    _check_rate(a, b, reps)
    if route not in ROUTES:
        raise ValueError(f"mma_rate: route {route!r} is not one of {ROUTES}")
    bt = b.t()
    if not bt.is_contiguous():
        bt = bt.contiguous()
    _check_on_card("mma_rate", [a, bt])
    (m, k), n = a.shape, b.shape[1]
    lib = cuda_lib.lib()
    code, route_i = RATE_DTYPES[a.dtype], ROUTES.index(route)
    if m % 64 or not 1 <= grid_reps <= 65535 or lib.rdt_mma_rate_bn(n, k, code, route_i) == 0:
        raise ValueError(f"mma_rate: the {route} kernel does not take (M, K, N) = "
                         f"{(m, k, n)} in {a.dtype} with grid_reps {grid_reps}")
    out = torch.empty((m, n), dtype=_rate_out_dtype(a.dtype), device=a.device)
    rc = lib.rdt_mma_rate(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, k, k, code,
                          route_i, reps, grid_reps, a.device.index, cuda_lib.stream_of(a))
    cuda_lib.check(rc, "mma_rate")
    mma_rate.launches += 1
    return out


mma_rate.launches = 0


def _check_probe(xp, k, mode, a):
    if mode not in MODES:
        raise ValueError(f"conv_probe: mode {mode!r} is not one of {MODES}")
    if xp.dim() != 4 or k.dim() not in (3, 4) or k.numel() != 9 * xp.shape[3] * k.shape[-1]:
        raise ValueError(f"conv_probe: xp {tuple(xp.shape)}, k {tuple(k.shape)} (nine taps of "
                         "(C, Co))")
    if xp.shape[1] < 3:
        raise ValueError("conv_probe: xp carries one padding row above and one below")
    want = (torch.int8,) if mode == "int8" else (torch.bfloat16, torch.float32)
    if xp.dtype not in want or k.dtype != xp.dtype:
        raise TypeError(f"conv_probe {mode}: xp {xp.dtype}, k {k.dtype}")
    if mode == "int8" and (a is None or a.dtype != torch.float32
                           or a.numel() != k.shape[-1]):
        raise ValueError("conv_probe int8: a is one float32 scale per output channel")


def conv_probe_plain(xp, k, mode, a=None, relu=None):
    """Plain PyTorch P1 (see :func:`conv_probe`): float32 sums of products of
    values in xp's dtype without TF32, rounded once to xp's dtype; the int8
    mode's products are exact and its epilogue is one float32 operation at a
    time."""
    _check_probe(xp, k, mode, a)
    b, hp, w, c = xp.shape
    h, co = hp - 2, k.shape[-1]
    k9 = k.reshape(9, c, co)
    with _full_float32_matmul():
        if mode == "conv":
            acc = F.conv2d(xp.float().permute(0, 3, 1, 2),
                           k9.reshape(3, 3, c, co).float().permute(3, 2, 0, 1),
                           padding=(0, 1)).permute(0, 2, 3, 1)
            return acc.to(xp.dtype).contiguous()
        flat = xp[:, :h].reshape(-1, c).float()
        acc = torch.zeros((flat.shape[0], co), device=xp.device,
                          dtype=torch.int32 if mode == "int8" else torch.float32)
        for t in range(9):  # each int8 product sum is below 2**24: exact in float32
            acc += (flat @ k9[t].float()).to(acc.dtype)
    acc = acc.reshape(b, h, w, co)
    if mode == "dots":
        return acc.to(xp.dtype)
    y = acc.to(torch.float32) * a.reshape(-1)
    if (co == 128) if relu is None else relu:
        y = torch.relu(y)
    return torch.clamp(torch.round(y * 0.37) - 127.0, -127.0, 127.0).to(torch.int8)


def conv_probe_work(xp, k, mode, a=None, relu=None, route="mma_sync"):
    """(operations, bytes) of one P1 call (PERF.md's bound of P1): nine
    products of C x Co multiply-adds an output pixel; xp, the taps and the
    output each moved once in xp's dtype."""
    b, hp, w, c = xp.shape
    co = k.shape[-1]
    return (2 * b * (hp - 2) * w * 9 * c * co,
            (xp.numel() + k.numel() + b * (hp - 2) * w * co) * xp.element_size())


@profiler.counted("conv_probe", conv_probe_work)
def conv_probe(xp, k, mode, a=None, relu=None, route="mma_sync"):
    """xp (B, H + 2, W, C), the activation with one zero row above and one
    below; k (3, 3, C, Co) or (9, C, Co), the nine taps -> (B, H, W, Co).

    - ``"conv"``: the 3x3 stride-1 pad-1 convolution (columns padded here),
      bfloat16 in and out, float32 accumulation;
    - ``"dots"``: the same nine products without the shifted views,
      ``out[b, h] = sum_t xp[b, h] @ k[t]`` for the first H rows of xp;
    - ``"int8"``: the nine products of ``dots`` in int8 -> int32, then
      ``y = acc * a[co]``, ``relu`` (by default only where Co == 128, as the
      two TPU probes have it), ``clip(round_half_even(y * 0.37) - 127, -127,
      127)`` as int8.

    The CUDA kernel takes bfloat16 (C a multiple of 16) or, for ``"int8"``,
    int8 (C a multiple of 32), and Co a multiple of 128; the plain version
    also takes float32 and any width. ``route="wgmma"`` runs the three modes
    on the TMA + ``wgmma.mma_async`` conv mainloop (``ops/conv3x3_wgmma.py``)
    instead of ``mma.sync``: C a multiple of 64 (int8: 128), Co of 128; the
    taps are transposed to (9, Co, C) first, by a stock op
    (``conv3x3_wgmma.wgmma_taps``)."""
    if xp.device.type == "cpu":
        return conv_probe_plain(xp, k, mode, a, relu)
    _check_probe(xp, k, mode, a)
    _check_on_card("conv_probe", [t for t in (xp, k, a) if t is not None])
    if route not in ROUTES:
        raise ValueError(f"conv_probe: route {route!r} is not one of {ROUTES}")
    b, hp, w, c = xp.shape
    co = k.shape[-1]
    relu = co == 128 if relu is None else relu
    if route == "wgmma":
        if xp.dtype == torch.float32 or not conv3x3_wgmma.takes(c, co, mode == "int8"):
            raise ValueError(f"conv_probe {mode}: the wgmma route takes bfloat16 with C % 64 == 0 "
                             f"(int8 with C % 128 == 0) and Co % 128 == 0, not {xp.dtype}, C {c}, "
                             f"Co {co}")
        kt = conv3x3_wgmma.wgmma_taps(k)
        out = torch.empty((b, hp - 2, w, co), dtype=xp.dtype, device=xp.device)
        conv3x3_wgmma.launch(xp, kt, out, mode, padded=True, scale=a, relu=relu)
        conv_probe.launches += 1
        return out
    if xp.dtype == torch.float32 or c % (32 if mode == "int8" else 16) or co % 128:
        raise ValueError(f"conv_probe {mode}: the kernel takes bfloat16 with C % 16 == 0 (int8 "
                         f"with C % 32 == 0) and Co % 128 == 0, not {xp.dtype}, C {c}, Co {co}")
    out = torch.empty((b, hp - 2, w, co), dtype=xp.dtype, device=xp.device)
    rc = cuda_lib.lib().rdt_conv_probe(
        xp.data_ptr(), k.data_ptr(), None if a is None else a.data_ptr(), out.data_ptr(), b, hp - 2,
        w, c, co, MODES.index(mode), int(relu), xp.device.index, cuda_lib.stream_of(xp))
    cuda_lib.check(rc, "conv_probe")
    conv_probe.launches += 1
    return out


conv_probe.launches = 0
