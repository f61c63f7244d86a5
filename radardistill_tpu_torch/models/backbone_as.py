"""PillarRes18 backbone, active-site formulation.

Counterpart of ``radardistill_tpu/models/backbone_as.py::PillarRes18BackBone8xAS``:
the stages before ``dense_from`` (2..5) run on fixed-capacity site tables
(B, cap, C) through per-stage tap tables, the last table is densified (K5)
and the remaining stages run masked-dense (``SparseDownBlock`` /
``SparseBasicBlock``); conv5 always runs dense. With ``dense_from = 5`` (the
shipped configs) conv4's table becomes the (B, H/8, W/8, 256) map. The tap
tables and the per-stage active sets come from the host
(``data/host_precompute.as_tables``) or, when ``tables`` is None, are built on
the device in the same order and with the same values. Submodule names mirror
the flax scopes (``conv1_0/conv1/conv``, ``conv2_down/bn``, ...); a stage has
the same parameters in either formulation. Stage 1 (``conv1_0``, ``conv1_1``,
``conv2_down``) keeps its kernels HWIO (``layers.KernelHolder``), as the dense
``PillarRes18BackBone8x`` does, so the radar branch has one ``state_dict`` in
either backbone and a checkpoint of one loads into the other. In train mode every BN of the table
stages takes its statistics over the valid rows of its stage, and the whole
backbone is differentiable in the table (index tables carry no gradient).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..caps import DEFAULT_CAPS, stage_caps
from ..ops import active_site as asx
from ..utils.profiler import span
from .backbone_sparse2d import DenseBasicBlock, SparseBasicBlock, SparseDownBlock
from .layers import (BN_EPS_BACKBONE, BN_MOM_BACKBONE, BatchNormTorch, Conv2dTorch, ConvParams,
                     KernelHolder, MaskedBatchNorm, max_pool_mask)


class ASConv(nn.Module):
    """3x3 active-site conv; weight (O, I, 3, 3) under ``conv``, or with
    ``hwio`` a ``KernelHolder``'s HWIO ``kernel``."""

    def __init__(self, in_ch, features, use_bias=False, hwio=False):
        super().__init__()
        self.conv = (KernelHolder(in_ch, features, use_bias) if hwio
                     else ConvParams(in_ch, features, 3, 1, use_bias))

    def forward(self, feats, tap):
        kernel = (self.conv.kernel if isinstance(self.conv, KernelHolder)
                  else self.conv.weight.permute(2, 3, 1, 0))  # HWIO
        return asx.conv3x3_as_b(feats, tap, kernel, self.conv.bias)


class SparseBasicBlockAS(nn.Module):
    """Residual submanifold block on site tables."""

    def __init__(self, features, hwio=False):
        super().__init__()
        self.conv1 = ASConv(features, features, True, hwio)
        self.bn1 = MaskedBatchNorm(features, BN_EPS_BACKBONE)
        self.conv2 = ASConv(features, features, True, hwio)
        self.bn2 = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, tap, valid):
        m = valid[..., None].to(x.dtype)
        y = torch.relu(self.bn1(self.conv1(x, tap), valid)) * m
        y = self.bn2(self.conv2(y, tap), valid)
        return torch.relu(y + x) * m


class SparseDownBlockAS(nn.Module):
    """Strided 3x3 sparse conv + BN + ReLU on site tables."""

    def __init__(self, in_ch, features, hwio=False):
        super().__init__()
        self.conv = ASConv(in_ch, features, False, hwio)
        self.bn = MaskedBatchNorm(features, BN_EPS_BACKBONE)

    def forward(self, x, tap, new_valid):
        y = torch.relu(self.bn(self.conv(x, tap), new_valid))
        return y * new_valid[..., None].to(y.dtype)


def _device_tap(out_uids, grid, in_hw, out_w, stride, cap_in):
    """(nb, msk, inv, imsk) of one conv, built on the device."""
    nb, msk = asx.conv_neighbor_table_b(out_uids, grid, in_hw, out_w, stride, cap_in)
    return (nb, msk) + asx.invert_taps_b(nb, msk, cap_in)


class PillarRes18BackBone8xAS(nn.Module):
    """Input: pillar table feats (B, cap1, 32) + sorted site ids uids (B, cap1)
    (sentinel H*W) and, optionally, the host tables of
    ``data/host_precompute.as_tables``. ``hw`` is the stride-1 (H, W); caps are
    clipped to each stage's area. ``densify_all`` adds ``x_conv{n}`` /
    ``mask{n}`` of the table stages to the output (tests and analysis).
    The forward's steps have child spans of the detector's stage (``stage``):
    ``.tables`` (the tap tables built on the device), ``.sparse`` (the table
    stages) and ``.dense`` (the hand-off's densify, the dense stages and
    conv5)."""

    stage = "backbone_3d"

    def __init__(self, hw: Tuple[int, int], caps=DEFAULT_CAPS, dense_from: int = 3,
                 densify_all: bool = False):
        super().__init__()
        if not 2 <= dense_from <= 5:
            raise ValueError(f"dense_from must be in 2..5, not {dense_from}")
        self.hw = tuple(hw)
        self.caps = stage_caps(caps, self.hw)
        self.dense_from, self.densify_all = dense_from, densify_all
        self.conv1_0 = SparseBasicBlockAS(32, hwio=True)
        self.conv1_1 = SparseBasicBlockAS(32, hwio=True)
        for stage, (cin, cout) in ((2, (32, 64)), (3, (64, 128)), (4, (128, 256))):
            down, block = ((SparseDownBlockAS, SparseBasicBlockAS) if stage < dense_from
                           else (SparseDownBlock, SparseBasicBlock))
            self.add_module(f"conv{stage}_down", down(cin, cout, hwio=stage == 2))
            self.add_module(f"conv{stage}_0", block(cout))
            self.add_module(f"conv{stage}_1", block(cout))
        self.conv5_down_conv = Conv2dTorch(256, 256, 3, 2, 1, use_bias=False)
        self.conv5_down_bn = BatchNormTorch(256, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.conv5_0 = DenseBasicBlock(256)
        self.conv5_1 = DenseBasicBlock(256)

    def build_tables(self, uids) -> Dict[str, object]:
        """The device twin of ``data/host_precompute.as_tables``: from the
        stage-1 active set uids (B, cap1), the tap tables of the table stages
        (``tap1``, and per stage before ``dense_from`` ``dtap{n}``, ``uids{n}``,
        ``tap{n}``) and the true (uncapped) down counts ``counts`` (B,
        dense_from - 2), all int32 / bool, with the host's values."""
        with span(f"{self.stage}.tables"):
            h, w = self.hw
            cap_in = self.caps[0]
            grid = asx.site_index_grid(uids, h * w, cap_in)
            tables: Dict[str, object] = {"tap1": _device_tap(uids, grid, (h, w), w, 1, cap_in)}
            sh, sw, counts = h, w, []
            for stage in range(2, self.dense_from):
                cap_out = self.caps[stage - 1]
                new_uids, cnt = asx.downsample_active(uids, (sh, sw), cap_out)
                counts.append(cnt)
                tables[f"dtap{stage}"] = _device_tap(new_uids, grid, (sh, sw), sw // 2, 2,
                                                     cap_in)
                sh, sw, cap_in, uids = sh // 2, sw // 2, cap_out, new_uids
                tables[f"uids{stage}"] = uids
                grid = asx.site_index_grid(uids, sh * sw, cap_in)
                tables[f"tap{stage}"] = _device_tap(uids, grid, (sh, sw), sw, 1, cap_in)
            tables["counts"] = (
                torch.stack(counts, dim=1) if counts else
                torch.zeros((uids.shape[0], 0), dtype=torch.int32, device=uids.device))
        return tables

    def forward(self, feats, uids, tables=None) -> Dict[str, torch.Tensor]:
        h, w = self.hw
        if feats.shape[1] != self.caps[0]:
            raise ValueError(f"VFE table capacity {feats.shape[1]} != caps[0] {self.caps[0]}")
        if tables is None:
            tables = self.build_tables(uids)
        out: Dict[str, torch.Tensor] = {}
        with span(f"{self.stage}.sparse"):
            valid = uids < h * w
            x = feats * valid[..., None].to(feats.dtype)
            tap = tables["tap1"]
            x = self.conv1_0(x, tap, valid)
            x = self.conv1_1(x, tap, valid)
            sites = {1: (x, uids)}
            sh, sw = h, w
            overflow = torch.zeros((), dtype=torch.int32, device=feats.device)
            for stage in range(2, self.dense_from):
                down, b0, b1 = (getattr(self, f"conv{stage}_{n}") for n in ("down", "0", "1"))
                cnt = tables["counts"][:, stage - 2]
                overflow = overflow + torch.clamp(
                    cnt - self.caps[stage - 1], min=0).sum().to(torch.int32)
                sh, sw, uids = sh // 2, sw // 2, tables[f"uids{stage}"]
                valid = uids < sh * sw
                x = down(x, tables[f"dtap{stage}"], valid)
                tap = tables[f"tap{stage}"]
                x = b1(b0(x, tap, valid), tap, valid)
                sites[stage] = (x, uids)

        with span(f"{self.stage}.dense"):
            # hand off: densify the last table (conv4's when dense_from == 5)
            dense_x, dense_mask = asx.densify_batch(x, uids, (sh, sw))
            if self.dense_from == 5:
                out["x_conv4"], out["mask4"] = dense_x, dense_mask
            for stage in range(self.dense_from, 5):
                down, b0, b1 = (getattr(self, f"conv{stage}_{n}") for n in ("down", "0", "1"))
                dense_mask = max_pool_mask(dense_mask, 3, 2, 1)
                dense_x = down(dense_x, dense_mask)
                dense_x = b1(b0(dense_x, dense_mask), dense_mask)
                sh, sw = sh // 2, sw // 2
                out[f"x_conv{stage}"], out[f"mask{stage}"] = dense_x, dense_mask
            y = torch.relu(self.conv5_down_bn(self.conv5_down_conv(dense_x)))
            y = self.conv5_0(y)
            out["x_conv5"] = self.conv5_1(y)
            out["as_overflow"] = overflow

            if self.densify_all:
                for stage, (f_, u_) in sites.items():
                    s = 1 << (stage - 1)
                    out[f"x_conv{stage}"], out[f"mask{stage}"] = asx.densify_batch(
                        f_, u_, (h // s, w // s))
        return out
