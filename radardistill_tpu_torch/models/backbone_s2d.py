"""Space-to-depth PillarRes18 backbone of the LiDAR teacher (NHWC).

Counterpart of ``radardistill_tpu/models/backbone_s2d.py``:
``PillarRes18BackBone8x_S2D`` and ``_S2D2`` (``pack_stage2``) on every input
route of the JAX module, the dense VFE's grid (``TABLE_INPUT: false``), a
linear-order pillar table (``PACKED_TABLE: false``) and a packed-order one
(the shipped route), with ``INT8`` false, true or ``static``, ``INT8_STAGES``
1-5 and ``FP_STAGES`` 0-5, in train and eval mode. Stage 1 runs on the 2x2
space-to-depth packing of the stride-1 grid, (B, H/2, W/2, 4*32) with channel
= phase * C + c and phase = (y%2)*2 + x%2, and every op is built to equal the
dense-grid stage exactly, on the same parameter tree:

- a 3x3 stride-1 subm conv becomes a 3x3 conv on the packed grid whose
  (4Cin, 4Cout) kernel is assembled from the original (3, 3, Cin, Cout)
  weights (``pack_subm_kernel``);
- the stride-2 conv that consumes stage 1 becomes a 2x2 conv on the packed
  grid padded (1, 0) per dimension (``pack_down_kernel``), and emits the
  unpacked stage-2 grid; under ``pack_stage2`` it is a 3x3 stride-2 conv from
  packed grid to packed grid (``pack_down_kernel_packed_out``) and stage 2
  runs packed too, at (B, H/4, W/4, 4*64);
- the masked BatchNorm of a packed stage is ``MaskedBatchNorm`` on the
  (B, h, w, 4, C) view (``PackedMaskedBatchNorm``): parameters and statistics
  stay (C,) vectors.

The JAX module's switch ``qs = int8_static and not train`` is read at every
call from ``nn.Module.training``: in train mode every block runs its float
path, so one model trains in float and evaluates on the int8 chain. In eval
mode ``INT8: static`` runs the stage-1 links (and under ``pack_stage2`` the
two stage-2 blocks) as fused int8 links (``ops/conv_block.py``, K1) on an
int8 carry ``(q, bound, zero)``. With ``INT8_STAGES`` 1 the chain ends in the
stride-2 conv after it, which consumes the carry with a stock exact integer
conv (``layers.int8_conv_affine``) and returns float; with 2-5 it runs on
through the later stages, unpacked, as fused links: a strided conv as a 2x2
link on the space-to-depth packing of the carry, the ``x_conv2..5`` taps
dequantized on exit, and the dense conv5 stage entered through the
first-generation link (``ops/int8_conv.py``, K7) with an all-ones lane mask.
``FP_STAGES: n`` runs the stages 2..n that the int8 chain does not cover as
fused float links (``ops.conv_block.fp_block_conv``, K6), in eval mode and
not under ``pack_stage2``. ``INT8: true`` quantizes every conv's input on the
fly (``layers.int8_conv``). Stages 2-4 otherwise run the masked dense float
blocks of ``backbone_sparse2d.py`` on host-built or dilated occupancy masks,
conv5 dense. Its ``state_dict`` is the one of the dense-input
``PillarRes18BackBone8x`` (the teacher of ``pillarnet.yaml``,
``backbone_sparse2d.py``), also under ``pack_stage2``, so a teacher trained
by either loads into the other.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import active_site as asx
from ..ops.conv_block import fp_block_conv, int8_block
from ..ops.int8_conv import int8_block_conv
from ..utils.bitpack import unpack_bool
from ..utils.profiler import span
from .backbone_sparse2d import DenseBasicBlock, SparseBasicBlock, SparseDownBlock
from .layers import (BN_EPS_BACKBONE, BN_MOM_BACKBONE, BatchNormTorch, Conv2dTorch,
                     MaskedBatchNorm, deq8, int8_conv, int8_conv_affine, int8_qkernel,
                     max_pool_mask, q8)

# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


def space_to_depth(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel = ((y%2)*2 + x%2)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x, c):
    """Inverse of space_to_depth for original channel count c."""
    b, h2, w2, _ = x.shape
    x = x.reshape(b, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 * 2, w2 * 2, c)


def pack_mask(mask):
    """(B, H, W) occupancy -> (B, H/2, W/2, 4) float32 (phase-major)."""
    return space_to_depth(mask[..., None].float())


def _phase_mask_flat(mask_p, c):
    """(B, h, w, 4) -> (B, h, w, 4c) per-phase multiplier."""
    b, h, w, _ = mask_p.shape
    return mask_p[..., :, None].expand(b, h, w, 4, c).reshape(b, h, w, 4 * c)


# ---------------------------------------------------------------------------
# packed kernel assembly: static tap tables, one gather per kernel
# ---------------------------------------------------------------------------


def _subm_taps() -> np.ndarray:
    """(3, 3, 4, 4) original tap index of packed tap (du, dv, q -> p), 9 where
    the packed tap is empty: dy = 2*du + qy - py must lie in {-1, 0, 1}."""
    taps = np.full((3, 3, 4, 4), 9, np.int64)
    for p in range(4):
        for q in range(4):
            for du in (-1, 0, 1):
                dy = 2 * du + q // 2 - p // 2
                for dv in (-1, 0, 1):
                    dx = 2 * dv + q % 2 - p % 2
                    if abs(dy) <= 1 and abs(dx) <= 1:
                        taps[du + 1, dv + 1, q, p] = (dy + 1) * 3 + dx + 1
    return taps


def _down_taps() -> np.ndarray:
    """(2, 2, 4) original tap index of packed tap (du, dv, q), 9 where empty:
    dy = 2*du + qy with du in {-1, 0}."""
    taps = np.full((2, 2, 4), 9, np.int64)
    for q in range(4):
        for du in (-1, 0):
            dy = 2 * du + q // 2
            for dv in (-1, 0):
                dx = 2 * dv + q % 2
                if abs(dy) <= 1 and abs(dx) <= 1:
                    taps[du + 1, dv + 1, q] = (dy + 1) * 3 + dx + 1
    return taps


def _down_packed_taps() -> np.ndarray:
    """(3, 3, 4, 4) original tap index of packed tap (du, dv, q -> p) of the
    stride-2 conv from packed grid to packed grid, 9 where empty: dy = 2*du +
    qy - 2*py must lie in {-1, 0, 1} (p the output's phase, q the input's)."""
    taps = np.full((3, 3, 4, 4), 9, np.int64)
    for p in range(4):
        for q in range(4):
            for du in (-1, 0, 1):
                dy = 2 * du + q // 2 - 2 * (p // 2)
                for dv in (-1, 0, 1):
                    dx = 2 * dv + q % 2 - 2 * (p % 2)
                    if abs(dy) <= 1 and abs(dx) <= 1:
                        taps[du + 1, dv + 1, q, p] = (dy + 1) * 3 + dx + 1
    return taps


_TAPS = {"subm": _subm_taps, "down": _down_taps, "down_packed": _down_packed_taps}


@functools.lru_cache(maxsize=None)
def _taps_on(kind: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_TAPS[kind]()).to(device)


def _taps_with_zero(k):
    kh, kw, cin, cout = k.shape
    return torch.cat([k.reshape(kh * kw, cin, cout), k.new_zeros((1, cin, cout))])


def pack_subm_kernel(k, cin, cout):
    """(3, 3, Cin, Cout) original kernel -> (3, 3, 4Cin, 4Cout) packed kernel."""
    kp = _taps_with_zero(k)[_taps_on("subm", k.device)]  # (3, 3, q, p, Cin, Cout)
    return kp.permute(0, 1, 2, 4, 3, 5).reshape(3, 3, 4 * cin, 4 * cout)


def pack_down_kernel(k, cin, cout):
    """(3, 3, Cin, Cout) stride-2 kernel -> (2, 2, 4Cin, Cout) packed stride-1
    kernel (output grid == packed grid; padding (1, 0) per dimension)."""
    kp = _taps_with_zero(k)[_taps_on("down", k.device)]  # (2, 2, q, Cin, Cout)
    return kp.reshape(2, 2, 4 * cin, cout)


def pack_down_kernel_packed_out(k, cin, cout):
    """(3, 3, Cin, Cout) stride-2 kernel -> (3, 3, 4Cin, 4Cout) stride-2
    kernel from the packed input grid to the packed output grid (padding 1)."""
    kp = _taps_with_zero(k)[_taps_on("down_packed", k.device)]  # (3, 3, q, p, Cin, Cout)
    return kp.permute(0, 1, 2, 4, 3, 5).reshape(3, 3, 4 * cin, 4 * cout)


def wpair_kernel(k):
    """(3, 3, C, Co) stride-1 kernel -> (3, 3, 2C, 2Co) stride-1 kernel on the
    W-paired layout ((B, H, W, C) -> (B, H, W/2, 2C), a contiguous reshape:
    channel index = (w % 2) * C + c). Packed tap (du, p -> q) carries the
    original tap dx = 2*du + p - q where that lies in {-1, 0, 1}, else zero.
    The JAX package pairs its C = 64 float links this way to fill TPU lanes;
    nothing in the port calls it (the conv it equals is the plain one)."""
    kh, kw, ci, co = k.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"wpair_kernel: kernel {tuple(k.shape)}")
    kp = k.new_zeros((3, 3, 2 * ci, 2 * co))
    for du in (-1, 0, 1):
        for p in range(2):
            for q in range(2):
                dx = 2 * du + p - q
                if abs(dx) <= 1:
                    kp[:, du + 1, p * ci:(p + 1) * ci, q * co:(q + 1) * co] = k[:, dx + 1]
    return kp


def _conv(x, kernel, padding, stride=1):
    """NHWC conv with an HWIO kernel and explicit ((top, bottom), (left,
    right)) zero padding."""
    (pt, pb), (pl, pr) = padding
    xn = x.permute(0, 3, 1, 2)
    if (pt, pl) != (pb, pr):
        xn, pt, pl = F.pad(xn, (pl, pr, pt, pb)), 0, 0
    y = F.conv2d(xn, kernel.permute(3, 2, 0, 1), None, stride, (pt, pl))
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# packed modules: the parameter trees of the dense variants
# ---------------------------------------------------------------------------


class _PackedSubmConv(Conv2dTorch):
    """3x3 subm conv on the packed grid, on the parameters of a 3x3
    ``Conv2dTorch`` under ``conv``: an HWIO ``kernel`` (``hwio``: stage 1, as
    the dense teacher holds it) or an OIHW ``weight`` (stage 2 under
    ``pack_stage2``, as the dense blocks hold it), so that every teacher has
    one ``state_dict``."""

    def __init__(self, cin, cout, use_bias, int8=False, hwio=True):
        super().__init__(cin, cout, 3, 1, 1, use_bias=use_bias, hwio=hwio)
        self.cin, self.cout, self.int8 = cin, cout, int8

    def forward(self, x):
        k, b = self.raw()
        if self.int8:
            kp = pack_subm_kernel(k, self.cin, self.cout)
            return int8_conv(x, kp, 1, ((1, 1), (1, 1)), None if b is None else b.repeat(4),
                             out_dtype=x.dtype)
        kp = pack_subm_kernel(k.to(x.dtype), self.cin, self.cout)
        y = _conv(x, kp, ((1, 1), (1, 1)))
        if b is not None:
            y = y + b.repeat(4).to(y.dtype)
        return y

    def pieces(self):
        """The int8 chain's view: packed quantized kernel, its per-channel
        dequant scales, and the phase-tiled bias."""
        k, b = self.raw()
        kq, sw = int8_qkernel(pack_subm_kernel(k.float(), self.cin, self.cout))
        return kq, sw, (b.repeat(4).float() if b is not None else None)


class PackedMaskedBatchNorm(MaskedBatchNorm):
    """``MaskedBatchNorm`` on (B, h, w, 4C) packed features with the (B, h, w,
    4) packed mask; parameters and running statistics are its (C,) vectors.

    Train mode is ``MaskedBatchNorm`` on the (B, h, w, 4, C) view, which is
    exact: the packed channel is phase * C + c, so the view's rows are the
    original grid's pixels and its channels the original channels, and the
    packed mask gives each of those rows its own occupancy. The masked sums,
    n = sum(mask), the unbiased running variance, the momentum and the
    hand-written backward (``layers._MaskedBatchNormTrain``, which keeps x in
    its dtype) are the dense BatchNorm's, and so is its ``sync_batch`` group.
    Eval mode applies the running statistics tiled over the 4 phases, in
    float32, returned in x's dtype."""

    def forward(self, x, mask_p=None):
        if self.training:
            b, h, w, c4 = x.shape
            y = super().forward(x.reshape(b, h, w, 4, c4 // 4), mask_p)
            return y.reshape(b, h, w, c4)
        inv4 = (torch.rsqrt(self.running_var + self.eps) * self.weight).repeat(4)
        y = (x.float() - self.running_mean.repeat(4)) * inv4 + self.bias.repeat(4)
        return y.to(x.dtype)

    def affine(self):
        """The BN as a packed affine (gt, shift, bound) for the int8 chain."""
        gt, shift, bound = super().affine()
        return gt.repeat(4), shift.repeat(4), bound


class S2DBasicBlock(nn.Module):
    """SparseBasicBlock on the packed grid (the same parameter tree). A
    tensor input runs the float path (train mode always does); an int8 carry
    ``(q, bound, zero)`` runs both links as fused int8 links (K1), the
    residual added on the second link's accumulator, and returns the next
    carry. ``hwio``: the kernels' layout (``_PackedSubmConv``)."""

    def __init__(self, features, int8=False, hwio=True):
        super().__init__()
        self.features = features
        self.conv1 = _PackedSubmConv(features, features, True, int8, hwio)
        self.bn1 = PackedMaskedBatchNorm(features)
        self.conv2 = _PackedSubmConv(features, features, True, int8, hwio)
        self.bn2 = PackedMaskedBatchNorm(features)

    def forward(self, x, mask_p):
        if isinstance(x, tuple):
            mc = mask_p.to(torch.int8)
            q1 = int8_block(x, *self.conv1.pieces(), *self.bn1.affine(), mc)
            return int8_block(q1, *self.conv2.pieces(), *self.bn2.affine(), mc, res=x)
        m = _phase_mask_flat(mask_p, self.features).to(x.dtype)
        y = torch.relu(self.bn1(self.conv1(x), mask_p)) * m
        y = self.bn2(self.conv2(y), mask_p)
        return torch.relu(y + x) * m


class S2DDownBlock(nn.Module):
    """Stride-2 SparseConv2d consuming a packed stage (stage 1, or stage 2
    under ``pack_stage2``): a 2x2 packed conv that emits the UNPACKED
    next-stage tensor in ``dtype``. An int8 carry either goes on
    (``int8_carry``: one fused int8 link, the next carry out) or is consumed
    here (the chain's terminus): one exact integer conv from stock ops with
    the dequant and BN affine as its epilogue, float out. ``hwio``: the
    kernel's layout (``_PackedSubmConv``)."""

    def __init__(self, cin, features, dtype=torch.float32, int8=False, int8_carry=False,
                 hwio=True):
        super().__init__()
        self.cin, self.features, self.dtype = cin, features, dtype
        self.int8, self.int8_carry = int8, int8_carry
        self.conv = Conv2dTorch(cin, features, 3, 2, 1, use_bias=False, hwio=hwio)
        self.bn = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x_packed, new_mask):
        k = self.conv.raw()[0]
        m = new_mask[..., None]
        if isinstance(x_packed, tuple):
            kq, sw = int8_qkernel(pack_down_kernel(k.float(), self.cin, self.features))
            if self.int8_carry:
                return int8_block(x_packed, kq, sw, None, *self.bn.affine(), m.to(torch.int8))
            gt, sh, _ = self.bn.affine()
            y = int8_conv_affine(x_packed, kq, sw, None, gt, sh, 1, ((1, 0), (1, 0)))
            return (torch.relu(y) * m.float()).to(self.dtype)
        if self.int8:
            kp = pack_down_kernel(k, self.cin, self.features)
            y = int8_conv(x_packed, kp, 1, ((1, 0), (1, 0)), out_dtype=x_packed.dtype)
        else:
            kp = pack_down_kernel(k.to(x_packed.dtype), self.cin, self.features)
            y = _conv(x_packed, kp, ((1, 0), (1, 0)))
        y = torch.relu(self.bn(y, new_mask))
        return y * m.to(y.dtype)


class S2DDownBlockPacked(nn.Module):
    """Stride-2 SparseConv2d that keeps both grids packed: (B, h, w, 4Cin) ->
    (B, h/2, w/2, 4Cout), a 3x3 stride-2 conv on the packed grid
    (``pack_down_kernel_packed_out``); BN statistics are the packed fold over
    the next stage's packed mask. The parameter tree is ``SparseDownBlock``'s.
    An int8 carry runs the stock exact integer conv at stride 2
    (``layers.int8_conv_affine``) and requantizes into the next packed
    stage's carry."""

    def __init__(self, cin, features, dtype=torch.float32, int8=False):
        super().__init__()
        self.cin, self.features, self.dtype, self.int8 = cin, features, dtype, int8
        self.conv = Conv2dTorch(cin, features, 3, 2, 1, use_bias=False, hwio=True)
        self.bn = PackedMaskedBatchNorm(features)

    def forward(self, x_packed, new_mask_p):
        k = self.conv.raw()[0]
        pad = ((1, 1), (1, 1))
        if isinstance(x_packed, tuple):
            kq, sw = int8_qkernel(pack_down_kernel_packed_out(k.float(), self.cin,
                                                              self.features))
            gt, sh, bnd = self.bn.affine()
            y = int8_conv_affine(x_packed, kq, sw, None, gt, sh, 2, pad)
            y = torch.relu(y) * _phase_mask_flat(new_mask_p, self.features).float()
            return q8(y, bnd, 127.0), bnd, 127.0
        if self.int8:
            kp = pack_down_kernel_packed_out(k, self.cin, self.features)
            y = int8_conv(x_packed, kp, 2, pad, out_dtype=x_packed.dtype)
        else:
            kp = pack_down_kernel_packed_out(k.to(x_packed.dtype), self.cin, self.features)
            y = _conv(x_packed, kp, pad, stride=2)
        y = torch.relu(self.bn(y, new_mask_p))
        return y * _phase_mask_flat(new_mask_p, self.features).to(y.dtype)


class PillarRes18BackBone8xS2D(nn.Module):
    """PillarRes18BackBone8x with stage 1 (and under ``pack_stage2`` stage 2)
    space-to-depth packed.

    ``forward(bev, mask, hp_masks=None)``: with ``table_input`` the VFE's
    pillar table (B, cap, 32) and its site ids (B, cap), sorted by packed
    address (``packed_table``) or by id, sentinel H*W; otherwise the dense
    VFE's grid (B, H, W, 32) and its (B, H, W) bool occupancy. ``hp_masks``:
    the host-built occupancy masks of the strided stages
    (``data.host_precompute.mask_pyramid``, bit-packed uint8 or bool) or
    None, in which case they are dilated here; ``pack_stage2`` ignores them,
    as the JAX module does. Returns x_conv2..x_conv5 and mask2..mask4
    (``x_conv2_packed`` for x_conv2 under ``pack_stage2``); with
    ``unpack_outputs`` also x_conv1, x_conv2 unpacked and mask1, to hold the
    module against the dense backbone. Under ``int8_static`` in eval mode the
    packed stages exist only as int8 carries and are dequantized on exit.
    Masks dilated here are built in the child span ``<stage>.tables`` of the
    detector's stage (``stage``)."""

    stage = "backbone_3d"

    def __init__(self, hw: Tuple[int, int], dtype=torch.float32, int8=False,
                 int8_static=False, int8_stages=1, fp_stages=0, table_input=True,
                 packed_table=True, pack_stage2=False, unpack_outputs=False):
        super().__init__()
        self.hw, self.dtype, self.int8_static = tuple(hw), dtype, int8_static
        self.table_input, self.packed_table = table_input, packed_table
        self.pack_stage2, self.unpack_outputs = pack_stage2, unpack_outputs
        # what eval mode runs at each stage, with the JAX module's precedence:
        # a stage the int8 chain covers is not a fused float stage, and
        # pack_stage2 keeps the chain to its packed stages. Train mode runs
        # every block's float path (each block reads nn.Module.training).
        stages = 1 if pack_stage2 else int8_stages
        qs = {n: int8_static and stages >= n for n in (2, 3, 4, 5)}
        fp = {n: fp_stages >= n and not qs[n] and not pack_stage2 for n in (2, 3, 4, 5)}
        self.qs, self.fp = qs, fp
        q = int8  # the dynamic int8 path, on every conv
        self.conv1_0 = S2DBasicBlock(32, q)
        self.conv1_1 = S2DBasicBlock(32, q)
        if pack_stage2:
            self.conv2_down = S2DDownBlockPacked(32, 64, dtype, q)
            self.conv2_0 = S2DBasicBlock(64, q, hwio=False)
            self.conv2_1 = S2DBasicBlock(64, q, hwio=False)
            self.conv3_down = S2DDownBlock(64, 128, dtype, q, hwio=False)
        else:
            self.conv2_down = S2DDownBlock(32, 64, dtype, q, int8_carry=qs[2])
            self.conv2_0 = SparseBasicBlock(64, dtype, q, qs[2], fp[2])
            self.conv2_1 = SparseBasicBlock(64, dtype, q, qs[2], fp[2])
            self.conv3_down = SparseDownBlock(64, 128, dtype, q, int8_static=qs[2],
                                              int8_carry=qs[3], fp_block=fp[3])
        self.conv3_0 = SparseBasicBlock(128, dtype, q, qs[3], fp[3])
        self.conv3_1 = SparseBasicBlock(128, dtype, q, qs[3], fp[3])
        self.conv4_down = SparseDownBlock(128, 256, dtype, q, int8_static=qs[3],
                                          int8_carry=qs[4], fp_block=fp[4])
        self.conv4_0 = SparseBasicBlock(256, dtype, q, qs[4], fp[4])
        self.conv4_1 = SparseBasicBlock(256, dtype, q, qs[4], fp[4])
        self.conv5_down_conv = Conv2dTorch(256, 256, 3, 2, 1, use_bias=False, int8=q)
        self.conv5_down_bn = BatchNormTorch(256, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.conv5_0 = DenseBasicBlock(256, dtype, q, qs[5], fp[5])
        self.conv5_1 = DenseBasicBlock(256, dtype, q, qs[5], fp[5])

    def _stage_masks(self, mask, hp_masks: Optional[tuple]):
        """(B, H/2^k, W/2^k) bool occupancy of stages 2-4; ``mask`` gives the
        stride-1 occupancy when called."""
        w0 = self.hw[1]
        if hp_masks is None or self.pack_stage2:
            with span(f"{self.stage}.tables"):
                masks, m = [], mask()
                for _ in range(3):
                    m = max_pool_mask(m, 3, 2, 1)
                    masks.append(m)
            return masks
        return [unpack_bool(m, w0 >> (i + 1)) if m.dtype == torch.uint8 else m
                for i, m in enumerate(hp_masks)]

    def _conv5_down(self, x4c):
        """The dense stride-2 conv into stage 5, on the stage-4 output as the
        chains left it (an int8 carry under ``INT8_STAGES: 5``)."""
        if self.qs[5] and not self.training:
            # the int8 chain: a 2x2 link on the space-to-depth packing of the
            # carry through the first-generation kernel, all-ones lane mask
            x4q, b4, z4 = x4c
            k5 = pack_down_kernel(self.conv5_down_conv.raw()[0].float(), 256, 256)
            kq5, sw5 = int8_qkernel(k5)
            b, h, w, _ = x4q.shape
            mq5 = torch.ones((b, h // 2, w // 2, 256), dtype=torch.int8, device=x4q.device)
            return int8_block_conv((space_to_depth(x4q), b4, z4), kq5, sw5, None,
                                   *self.conv5_down_bn.affine(), mq5)
        if self.fp[5] and not self.training:
            k5 = pack_down_kernel(self.conv5_down_conv.raw()[0].float(), 256, 256)
            gt5, sh5, _ = self.conv5_down_bn.affine()
            b, h, w, _ = x4c.shape
            ones5 = torch.ones((b, h // 2, w // 2, 1), dtype=torch.int8, device=x4c.device)
            return fp_block_conv(space_to_depth(x4c.to(self.dtype)), k5, None, gt5, sh5, ones5)
        return torch.relu(self.conv5_down_bn(self.conv5_down_conv(x4c)))

    def _entry(self, bev, mask, static):
        """The stage-1 input on the packed grid (an int8 carry when
        ``static``), its (B, H/2, W/2, 4) float packed mask, and the stride-1
        (B, H, W) bool occupancy, or None where the route has none."""
        if not self.table_input:
            mask_p = pack_mask(mask)
            x = space_to_depth(bev) * _phase_mask_flat(mask_p, bev.shape[-1]).to(bev.dtype)
            if not static:
                return x.to(self.dtype), mask_p, mask
            # one dynamic abs-max of the packed grid in its own dtype
            bnd0 = torch.clamp(x.abs().max().float(), min=1e-6)
            return (q8(x.float(), bnd0), bnd0, 0.0), mask_p, mask
        table, uids = bev, mask
        if static:
            # quantize the COMPACT table, then densify int8 (exact: q8 is
            # elementwise with q8(0) = 0, so gather(q8(t)) == q8(gather(t))).
            # The bound is the table's abs-max: it equals the dense grid's
            # only because unused table rows are exactly zero (the VFE's
            # -inf max-scatter with its isneginf -> 0 fill guarantees it)
            bnd0 = torch.clamp(table.abs().max().float(), min=1e-6)
            table = q8(table.float(), bnd0)
        if self.packed_table:
            x, mask_pb = asx.densify_packed_direct_batch(table, uids, self.hw)
            mask_p, full = mask_pb.float(), None
        else:
            x, full = asx.densify_packed_batch(table, uids, self.hw)
            mask_p = pack_mask(full)
        return ((x, bnd0, 0.0) if static else x), mask_p, full

    def forward(self, bev, mask, hp_masks=None) -> Dict[str, torch.Tensor]:
        static = self.int8_static and not self.training
        x, mask_p, full = self._entry(bev, mask, static)

        def stride1():
            return full if full is not None else depth_to_space(mask_p, 1)[..., 0] > 0

        mask2, mask3, mask4 = self._stage_masks(stride1, hp_masks)

        def dq(t):
            """A stage's output as a float tensor: an int8 carry dequantized."""
            return deq8(*t).to(self.dtype) if isinstance(t, tuple) else t

        x = self.conv1_0(x, mask_p)
        x1p = self.conv1_1(x, mask_p)
        out = {}
        if self.pack_stage2:
            mask2_p = pack_mask(mask2)
            x = self.conv2_down(x1p, mask2_p)
            x = self.conv2_0(x, mask2_p)
            x2p = self.conv2_1(x, mask2_p)
            x = self.conv3_down(x2p, mask3)
            if self.unpack_outputs:
                out["x_conv2"] = depth_to_space(dq(x2p), 64)
            else:
                out["x_conv2_packed"] = dq(x2p)
        else:
            x = self.conv2_down(x1p, mask2)
            x = self.conv2_0(x, mask2)
            x2c = self.conv2_1(x, mask2)
            out["x_conv2"] = dq(x2c)
            x = self.conv3_down(x2c, mask3)
        x = self.conv3_0(x, mask3)
        x3c = self.conv3_1(x, mask3)
        x = self.conv4_down(x3c, mask4)
        x = self.conv4_0(x, mask4)
        x4c = self.conv4_1(x, mask4)
        x = self._conv5_down(x4c)
        x = self.conv5_0(x)
        out.update({"x_conv3": dq(x3c), "x_conv4": dq(x4c), "x_conv5": dq(self.conv5_1(x)),
                    "mask2": mask2, "mask3": mask3, "mask4": mask4})
        if self.unpack_outputs:
            out["x_conv1"], out["mask1"] = depth_to_space(dq(x1p), 32), stride1()
        return out
