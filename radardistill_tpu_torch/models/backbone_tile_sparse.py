"""The tile-sparse PillarRes18 backbone: the masked-dense semantics of
``PillarRes18BackBone8x`` with its residual stages computed on the active
tiles only.

Counterpart of ``radardistill_tpu/models/backbone_tile_sparse.py``
(``PillarRes18BackBone8x_TileSparse`` and its ``Radar_`` name). Each
residual stage gathers its active tiles (``ops.tile_sparse``) with a 4-cell
halo (2 blocks x 2 convs), runs VALID convs on the (T, tile + 8, tile + 8, C)
patch batch and scatters the cores back; the strided down convs between the
stages and the conv5 stage stay dense. The BatchNorms' statistics are taken
over the active cells of the tile cores (each active site once, the halo
copies left out), which is the masked BatchNorm of the dense backbone, as
long as no active tile is dropped: ``select_tiles`` keeps at most
``max_tiles`` (``MAX_TILES``, 512 by default) a stage over the whole batch.
Each stage's ``tile_stats`` holds the last forward's active-tile count and
overflow flag (tensors, read without a sync).

The parameter layout is the JAX module's own: a stage holds flat HWIO
kernels ``b{k}_conv{i}_kernel`` and biases, and ``b{k}_bn{i}``; it does not
load a dense backbone's checkpoint. Convolutions are ``F.conv2d``: neither
JAX file reaches a Pallas kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import tile_sparse
from .backbone_sparse2d import DenseBasicBlock
from .layers import (BN_EPS_BACKBONE, BN_MOM_BACKBONE, BatchNormTorch, Conv2dTorch,
                     MaskedBatchNorm, max_pool_mask)

HALO = 4


def _valid_conv(x, kernel, bias):
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(x.dtype),
                 bias.to(x.dtype))
    return y.permute(0, 2, 3, 1)


def _crop(a, k):
    return a[:, k:-k, k:-k] if k else a


def effective_tile(tile: int, h: int, w: int) -> int:
    """The largest tile <= ``tile`` that divides both sides of the map."""
    tile = min(tile, h, w)
    while h % tile or w % tile:
        tile -= 1
    return tile


def dense_name(name: str) -> str:
    """The dense ``PillarRes18BackBone8x``'s name of a tile backbone's
    parameter or buffer (carry weights across with it; a kernel's layout is
    HWIO here and OIHW there past stage 1, and ``down2_conv`` is OIHW here
    and HWIO there):
    ``stage{n}.b{k}_conv{i}_kernel`` / ``_bias`` -> ``conv{n}_{k}.conv{i}.conv.
    weight`` (``kernel`` in the HWIO stage 1) / ``bias``, ``stage{n}.b{k}_bn{i}``
    -> ``conv{n}_{k}.bn{i}``, ``down{n}_conv`` / ``down{n}_bn`` ->
    ``conv{n}_down.conv`` / ``.bn``; conv5's names are shared."""
    head, rest = name.split(".", 1)
    if head.startswith("stage"):
        n = head[5:]
        first, *tail = rest.split(".")
        blk, what = first.split("_", 1)
        if what.startswith("conv"):
            leaf = ("kernel" if n == "1" else "weight") if what.endswith("kernel") else "bias"
            return f"conv{n}_{blk[1:]}.{what[:5]}.conv.{leaf}"
        return ".".join([f"conv{n}_{blk[1:]}", what, *tail])
    if head.startswith("down"):
        n, part = head[4], head[6:]
        if part == "conv" and n == "2":
            return "conv2_down.conv.conv.kernel"
        return f"conv{n}_down.{part}.{rest}"
    return name


def state_from_dense(tile: nn.Module, dense_state: Dict[str, torch.Tensor]):
    """The ``state_dict`` of ``tile`` (a ``PillarRes18BackBone8xTileSparse``)
    that carries a dense ``PillarRes18BackBone8x``'s ``dense_state`` across
    (:func:`dense_name`, kernels re-laid out)."""
    out = {}
    for k, v in tile.state_dict().items():
        d = dense_state[dense_name(k)]
        if d.shape != v.shape:  # OIHW -> HWIO, or the HWIO conv2_down -> OIHW
            d = d.permute(2, 3, 1, 0) if k.endswith("_kernel") else d.permute(3, 2, 0, 1)
        out[k] = d.contiguous()
    return out


class TileSparseResStage(nn.Module):
    """Two residual blocks (conv/bn/relu -> conv/bn -> + identity -> relu,
    re-masked) in the tile domain."""

    def __init__(self, features: int, tile: int = 32, max_tiles: int = 512):
        super().__init__()
        self.tile, self.max_tiles = tile, max_tiles
        c = features
        for blk in range(2):
            for ci in (1, 2):
                self.register_parameter(f"b{blk}_conv{ci}_kernel",
                                        nn.Parameter(torch.empty(3, 3, c, c)))
                self.register_parameter(f"b{blk}_conv{ci}_bias", nn.Parameter(torch.empty(c)))
                self.add_module(f"b{blk}_bn{ci}", MaskedBatchNorm(c, BN_EPS_BACKBONE,
                                                                  BN_MOM_BACKBONE))
        self.tile_stats = None

    def forward(self, x, mask):
        b, h, w, c = x.shape
        tile = effective_tile(self.tile, h, w)
        act = tile_sparse.tile_activity(mask, tile)
        ids, valid, overflow = tile_sparse.select_tiles(act, self.max_tiles)
        self.tile_stats = {"active": act.sum(), "overflow": overflow, "tile": tile}
        p = tile_sparse.gather_tiles(x * mask[..., None].to(x.dtype), ids, valid, tile, HALO)
        pm = tile_sparse.gather_tiles(mask[..., None].float(), ids, valid, tile, HALO)[..., 0]
        cur = HALO
        for blk in range(2):
            identity = _crop(p, 2)
            for ci in (1, 2):
                y = _valid_conv(p, getattr(self, f"b{blk}_conv{ci}_kernel"),
                                getattr(self, f"b{blk}_conv{ci}_bias"))
                cur -= 1
                m_here = _crop(pm, HALO - cur)
                core = torch.zeros_like(m_here[0])
                core[cur:core.shape[0] - cur, cur:core.shape[1] - cur] = 1.0
                y = getattr(self, f"b{blk}_bn{ci}")(y, m_here * core[None])
                if ci == 1:
                    y = torch.relu(y) * m_here[..., None].to(y.dtype)
                p = y
            p = torch.relu(p + identity) * _crop(pm, HALO - cur)[..., None].to(p.dtype)
        return tile_sparse.scatter_tiles(p, ids, valid, (b, h, w, c))


class PillarRes18BackBone8xTileSparse(nn.Module):
    """``PillarRes18BackBone8x`` with tile-sparse residual stages
    (``stage1``..``stage4``), dense ``down{n}_conv`` / ``down{n}_bn`` between
    them and the dense conv5 stage. The same inputs and outputs."""

    def __init__(self, in_ch=32, dtype=torch.float32, tile: int = 32, max_tiles: int = 512):
        super().__init__()
        if in_ch != 32:
            raise ValueError(f"PillarRes18BackBone8x_TileSparse: its first stage takes 32 "
                             f"channels, not {in_ch}")
        self.dtype = dtype
        for n, c in ((1, 32), (2, 64), (3, 128), (4, 256)):
            self.add_module(f"stage{n}", TileSparseResStage(c, tile, max_tiles))
        for n, (cin, cout) in ((2, (32, 64)), (3, (64, 128)), (4, (128, 256))):
            self.add_module(f"down{n}_conv", Conv2dTorch(cin, cout, 3, 2, 1))
            self.add_module(f"down{n}_bn", MaskedBatchNorm(cout, BN_EPS_BACKBONE, BN_MOM_BACKBONE))
        self.conv5_down_conv = Conv2dTorch(256, 256, 3, 2, 1)
        self.conv5_down_bn = BatchNormTorch(256, BN_EPS_BACKBONE, BN_MOM_BACKBONE)
        self.conv5_0 = DenseBasicBlock(256, dtype)
        self.conv5_1 = DenseBasicBlock(256, dtype)

    def tile_stats(self):
        """{stage: its last forward's active tiles, overflow flag, tile}."""
        return {f"stage{n}": getattr(self, f"stage{n}").tile_stats for n in (1, 2, 3, 4)}

    def forward(self, bev, mask) -> Dict[str, torch.Tensor]:
        x = (bev * mask[..., None].to(bev.dtype)).to(self.dtype)
        out = {"mask1": mask}
        out["x_conv1"] = x = self.stage1(x, mask)
        for n in (2, 3, 4):
            new_m = out[f"mask{n}"] = max_pool_mask(mask, 3, 2, 1)
            y = getattr(self, f"down{n}_bn")(getattr(self, f"down{n}_conv")(x), new_m)
            x = torch.relu(y) * new_m[..., None].to(y.dtype)
            mask = new_m
            out[f"x_conv{n}"] = x = getattr(self, f"stage{n}")(x, mask)
        x = torch.relu(self.conv5_down_bn(self.conv5_down_conv(x)))
        out["x_conv5"] = self.conv5_1(self.conv5_0(x))
        return out
