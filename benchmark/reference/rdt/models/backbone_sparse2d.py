"""Masked-dense blocks and the dense-input backbones (NHWC).

Counterpart of ``radardistill_tpu/models/backbone_sparse2d.py``:
``SubMConvBlock``, ``SparseDownBlock`` and ``SparseBasicBlock`` (exact sparse
semantics on dense tensors: a submanifold conv is a dense conv times the
occupancy mask, a strided sparse conv grows the active set to the dilated
mask, which the caller passes in), ``DenseBasicBlock`` (conv5), and the two
backbones fed by a dense VFE, ``PillarRes18BackBone8x`` (the LiDAR teacher of
``pillarnet.yaml`` and the radar backbone of ``pillarnet_radar.yaml``) and
``PillarBackBone8x``. The backbones dilate the occupancy once per strided
stage (``layers.max_pool_mask``, the JAX block's own dilation when it is passed
no ``new_mask``) and hand each down block its stage's mask. The masked blocks
pass their mask to the BN, which reads it in train mode; the dense block's BNs
follow ``nn.Module.training`` on their own.

Each block has the JAX module's switches. In eval mode (a frozen teacher)
``int8_static`` runs its links as fused int8 links on an int8 carry
``(q, bound, zero)`` (``ops.conv_block.int8_block``: K1, or K7 under
``CONV_BLOCK_V1=1``) and ``fp_block`` as fused float links
(``ops.conv_block.fp_block_conv``, K6); a strided conv runs either as a 2x2
conv on the space-to-depth packing of its input. ``int8`` is the dynamic
per-conv int8 path of ``layers.int8_conv``. The precedence is the JAX
module's: int8_static, then fp_block, then the plain path with or without
``int8``. In train mode every block takes the plain path. The float links
run each conv at its real width: the JAX package's lane padding and its
W pairing of the C = 64 links exist only to fill TPU lanes.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv_block import fp_block_conv, int8_block
from .layers import (BN_EPS_BACKBONE, BN_MOM_BACKBONE, BatchNormTorch, Conv2dTorch,
                     MaskedBatchNorm, deq8, int8_qkernel, max_pool_mask)


def _int8_links(x, conv1, bn1, conv2, bn2, mc):
    """Two chained int8 links, the residual carry x added on the second
    link's accumulator; returns the next carry."""
    q1 = int8_block(x, *conv1.qpieces(), *bn1.affine(), mc)
    return int8_block(q1, *conv2.qpieces(), *bn2.affine(), mc, res=x)


def _fp_links(x, conv1, bn1, conv2, bn2, mc):
    """Two chained float links, the residual x added on the second link's
    accumulator."""
    y = fp_block_conv(x, *conv1.raw(), *bn1.affine()[:2], mc)
    return fp_block_conv(y, *conv2.raw(), *bn2.affine()[:2], mc, res=x)


class SparseDownBlock(nn.Module):
    """Strided SparseConv2d + BN1d + ReLU; ``new_mask`` (B, H/2, W/2) bool is
    the dilated occupancy of the output grid. With ``int8_static`` the input
    is an int8 carry and the output the next carry (``int8_carry``) or its
    dequantized float tensor in ``dtype`` (the chain's terminus: it
    requantizes and then dequantizes, as the JAX module does)."""

    def __init__(self, in_ch, features, dtype=torch.float32, int8=False, int8_static=False,
                 int8_carry=False, fp_block=False, hwio=False):
        super().__init__()
        self.in_ch, self.features, self.dtype = in_ch, features, dtype
        self.int8_static, self.int8_carry, self.fp_block = int8_static, int8_carry, fp_block
        self.conv = Conv2dTorch(in_ch, features, 3, 2, 1, use_bias=False, int8=int8, hwio=hwio)
        self.bn = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, new_mask):
        from .backbone_s2d import pack_down_kernel, space_to_depth

        if self.int8_static and not self.training:
            xq, bnd, zero = x
            kq, sw = int8_qkernel(pack_down_kernel(self.conv.raw()[0].float(), self.in_ch,
                                                   self.features))
            out = int8_block((space_to_depth(xq), bnd, zero), kq, sw, None, *self.bn.affine(),
                             new_mask[..., None].to(torch.int8))
            return out if self.int8_carry else deq8(*out).to(self.dtype)
        if self.fp_block and not self.training:
            kp = pack_down_kernel(self.conv.raw()[0].float(), self.in_ch, self.features)
            gt, sh, _ = self.bn.affine()
            return fp_block_conv(space_to_depth(x.to(self.dtype)), kp, None, gt, sh,
                                 new_mask[..., None].to(torch.int8))
        y = torch.relu(self.bn(self.conv(x), new_mask))
        return y * new_mask[..., None].to(y.dtype)


class SparseBasicBlock(nn.Module):
    """Residual submanifold block: conv/bn/relu -> conv/bn -> +identity ->
    relu, all on the active set ``mask`` (B, H, W) bool. The convs carry a
    bias, as in the reference. ``hwio`` keeps their kernels HWIO
    (``layers.KernelHolder``)."""

    def __init__(self, features, dtype=torch.float32, int8=False, int8_static=False,
                 fp_block=False, hwio=False):
        super().__init__()
        self.dtype, self.int8_static, self.fp_block = dtype, int8_static, fp_block
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True, int8=int8, hwio=hwio)
        self.bn1 = MaskedBatchNorm(features, BN_EPS_BACKBONE)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True, int8=int8, hwio=hwio)
        self.bn2 = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, mask):
        if (self.int8_static or self.fp_block) and not self.training:
            links = _int8_links if self.int8_static else _fp_links
            if not self.int8_static:
                x = x.to(self.dtype)
            return links(x, self.conv1, self.bn1, self.conv2, self.bn2,
                         mask[..., None].to(torch.int8))
        m = mask[..., None].to(x.dtype)
        y = torch.relu(self.bn1(self.conv1(x), mask)) * m
        y = self.bn2(self.conv2(y), mask)
        return torch.relu(y + x) * m


class DenseBasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + identity -> ReLU (conv5 stage). The fused
    links take an all-ones mask: the stage is dense."""

    def __init__(self, features, dtype=torch.float32, int8=False, int8_static=False,
                 fp_block=False):
        super().__init__()
        self.dtype, self.int8_static, self.fp_block = dtype, int8_static, fp_block
        self.conv1 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True, int8=int8)
        self.bn1 = BatchNormTorch(features, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.conv2 = Conv2dTorch(features, features, 3, 1, 1, use_bias=True, int8=int8)
        self.bn2 = BatchNormTorch(features, BN_EPS_BACKBONE, BN_MOM_BACKBONE)

    def forward(self, x):
        if (self.int8_static or self.fp_block) and not self.training:
            links = _int8_links if self.int8_static else _fp_links
            if not self.int8_static:
                x = x.to(self.dtype)
            first = x[0] if self.int8_static else x
            ones = torch.ones((*first.shape[:3], 1), dtype=torch.int8, device=first.device)
            return links(x, self.conv1, self.bn1, self.conv2, self.bn2, ones)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + x)


class SubMConvBlock(nn.Module):
    """SubMConv2d (no bias) + BN1d over the active sites + ReLU, re-masked."""

    def __init__(self, in_ch, features):
        super().__init__()
        self.conv = Conv2dTorch(in_ch, features, 3, 1, 1, use_bias=False)
        self.bn = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, mask):
        y = torch.relu(self.bn(self.conv(x), mask))
        return y * mask[..., None].to(y.dtype)


def _masked_stages(backbone, bev, mask):
    """Stages 1-4 of a dense-input backbone (its ``conv{n}_down``,
    ``conv{n}_0``, ``conv{n}_1``): the output dict so far and x_conv4. Each
    strided stage grows the active set by its 3x3 stride-2 window."""
    x = (bev * mask[..., None].to(bev.dtype)).to(backbone.dtype)
    out = {"mask1": mask}
    x = backbone.conv1_0(x, mask)
    out["x_conv1"] = x = backbone.conv1_1(x, mask)
    for n in (2, 3, 4):
        mask = out[f"mask{n}"] = max_pool_mask(mask, 3, 2, 1)
        x = getattr(backbone, f"conv{n}_down")(x, mask)
        x = getattr(backbone, f"conv{n}_0")(x, mask)
        out[f"x_conv{n}"] = x = getattr(backbone, f"conv{n}_1")(x, mask)
    return out, x


class PillarRes18BackBone8x(nn.Module):
    """The dense-input PillarRes18 backbone: (B, H, W, 32) BEV features and
    their (B, H, W) occupancy from a dense VFE -> ``x_conv1``..``x_conv5`` at
    strides 1-16 and ``mask1``..``mask4``. Four masked stages of two residual
    blocks (``_masked_stages``), then the dense conv5 stage. Stage 1
    (``conv1_0``, ``conv1_1``, ``conv2_down``) keeps its kernels HWIO, so the
    ``state_dict`` is the one of ``PillarRes18BackBone8x_S2D``: a checkpoint
    of either teacher loads into the other. ``int8`` is the dynamic per-conv
    int8 of a frozen teacher (``INT8: true``); the features are computed in
    ``dtype``."""

    def __init__(self, in_ch=32, dtype=torch.float32, int8=False):
        super().__init__()
        if in_ch != 32:
            raise ValueError(f"PillarRes18BackBone8x: its first residual block takes 32 "
                             f"channels, not {in_ch}")
        self.dtype = dtype
        q = int8
        self.conv1_0 = SparseBasicBlock(32, dtype, q, hwio=True)
        self.conv1_1 = SparseBasicBlock(32, dtype, q, hwio=True)
        for n, (cin, cout) in ((2, (32, 64)), (3, (64, 128)), (4, (128, 256))):
            self.add_module(f"conv{n}_down", SparseDownBlock(cin, cout, dtype, q, hwio=n == 2))
            self.add_module(f"conv{n}_0", SparseBasicBlock(cout, dtype, q))
            self.add_module(f"conv{n}_1", SparseBasicBlock(cout, dtype, q))
        self.conv5_down_conv = Conv2dTorch(256, 256, 3, 2, 1, use_bias=False, int8=q)
        self.conv5_down_bn = BatchNormTorch(256, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.conv5_0 = DenseBasicBlock(256, dtype, q)
        self.conv5_1 = DenseBasicBlock(256, dtype, q)

    def forward(self, bev, mask):
        out, x = _masked_stages(self, bev, mask)
        x = torch.relu(self.conv5_down_bn(self.conv5_down_conv(x)))
        out["x_conv5"] = self.conv5_1(self.conv5_0(x))
        return out


class PillarBackBone8x(nn.Module):
    """The non-residual variant: each stage [a strided down +] two
    ``SubMConvBlock``s, then conv5 as a strided dense conv and two dense
    conv-BN-ReLU layers. The same inputs and outputs as
    :class:`PillarRes18BackBone8x`; its first conv takes the VFE's width."""

    def __init__(self, in_ch=32, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1_0 = SubMConvBlock(in_ch, 32)
        self.conv1_1 = SubMConvBlock(32, 32)
        for n, (cin, cout) in ((2, (32, 64)), (3, (64, 128)), (4, (128, 256))):
            self.add_module(f"conv{n}_down", SparseDownBlock(cin, cout, dtype))
            self.add_module(f"conv{n}_0", SubMConvBlock(cout, cout))
            self.add_module(f"conv{n}_1", SubMConvBlock(cout, cout))
        for name, stride in (("conv5_down", 2), ("conv5_0", 1), ("conv5_1", 1)):
            self.add_module(f"{name}_conv", Conv2dTorch(256, 256, 3, stride, 1, use_bias=False))
            self.add_module(f"{name}_bn", BatchNormTorch(256, BN_EPS_BACKBONE, BN_MOM_BACKBONE))

    def forward(self, bev, mask):
        out, x = _masked_stages(self, bev, mask)
        for name in ("conv5_down", "conv5_0", "conv5_1"):
            x = torch.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))
        out["x_conv5"] = x
        return out
