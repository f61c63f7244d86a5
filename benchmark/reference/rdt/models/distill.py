"""CMA densification hourglass and the AFD/PFD distillation losses, NHWC.

Counterpart of ``radardistill_tpu/models/distill.py``: ``ConvNeXtBlock`` (with
the stride-2 DCNv2 downsample and its frozen ``down_bias``), ``DecoderBlock``,
``AggBlock`` and ``CMAHourglass``, and the loss functions ``afd_low_loss``,
``pfd_high_loss`` and ``distill_loss``. The three downsamples are the three
DCN sites (180²->90², 90²->45², 180²->90² at the 1440² grid): K2 forward, K3
and K4 backward. In train mode each downsample leaves the share of its offsets
beyond the kernels' clamp in ``dcn_offset_sat`` (the reference's diagnostic;
the train step reports the mean over the three sites). The BNs follow
``nn.Module.training``. GELU is the exact erf form (``F.gelu``'s default), as
in the reference. The losses' batch normalizers (AFD's mask ratio, batch size
and mask mean, PFD's TP/FN and FP counts) go through
``parallel.mesh.batch_sum``: under synchronized data parallelism each rank's
loss is its share of the global batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import dcn_max_offset, modulated_deform_conv
from ..parallel.mesh import batch_sum
from .layers import (GRN, BatchNormTorch, Conv2dTorch, ConvTranspose2dTorch, Dense,
                     LayerNormTorch, clip_sigmoid)


class ConvNeXtBlock(nn.Module):
    """ConvNeXt-v2 block, optionally prefixed by the stride-2 DCNv2 downsample."""

    def __init__(self, dim: int, downsample: bool = False):
        super().__init__()
        self.downsample = downsample
        self.dcn_offset_sat = None
        if downsample:
            # offset/mask head: conv3 s2 p1 -> 27 ch = 9 * (2 + 1)
            self.conv_offset_mask1 = Conv2dTorch(dim, 27, 3, 2, 1, use_bias=True)
            self.down_weight = nn.Parameter(torch.empty(3, 3, dim, dim))  # HWIO
            # the reference's ModulatedDeformConv(bias=False) still carries a
            # fixed (never trained) bias in its checkpoints
            self.down_bias = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.dwconv = Conv2dTorch(dim, dim, 7, 1, 3, use_bias=True, groups=dim)
        self.norm = LayerNormTorch(dim)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)

    def forward(self, x):
        if self.downsample:
            om = self.conv_offset_mask1(x)
            o1, o2, m = torch.split(om, 9, dim=-1)
            offset = torch.cat([o1, o2], dim=-1)  # read as [dy_k, dx_k] pairs
            if self.training:
                with torch.no_grad():
                    self.dcn_offset_sat = (offset.float().abs() > dcn_max_offset()).float().mean()
            x = modulated_deform_conv(x, offset, torch.sigmoid(m), self.down_weight,
                                      stride=2, padding=1)
            x = x + self.down_bias.to(x.dtype)
        identity = x
        x = self.norm(self.dwconv(x))
        x = self.grn(F.gelu(self.pwconv1(x)))
        return self.pwconv2(x) + identity


class DecoderBlock(nn.Module):
    """ConvTranspose2d(4, 2, 1) + BN + GELU."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.deconv = ConvTranspose2dTorch(dim, dim, 4, 2, 1, use_bias=True)
        self.bn = BatchNormTorch(dim)

    def forward(self, x):
        return F.gelu(self.bn(self.deconv(x)))


class AggBlock(nn.Module):
    """1x1 conv (2·dim -> dim) + BN + GELU."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.conv = Conv2dTorch(2 * dim, dim, 1, 1, 0, use_bias=True)
        self.bn = BatchNormTorch(dim)

    def forward(self, x):
        return F.gelu(self.bn(self.conv(x)))


class CMAHourglass(nn.Module):
    """The 3-stage densification hourglass. Returns
    (radar_spatial_features_8x_2, radar_spatial_features_8x_1)."""

    def __init__(self, dim: int = 256):
        super().__init__()
        for i in (1, 2, 3):
            self.add_module(f"encoder_{i}_0", ConvNeXtBlock(dim, downsample=True))
            self.add_module(f"encoder_{i}_1", ConvNeXtBlock(dim))
            self.add_module(f"decoder_{i}", DecoderBlock(dim))
            self.add_module(f"agg_{i}", AggBlock(dim))

    def forward(self, spatial_features):
        en_16x = self.encoder_1_1(self.encoder_1_0(spatial_features))
        de_8x = self.agg_1(torch.cat([self.decoder_1(en_16x), spatial_features], dim=-1))
        en_32x = self.encoder_2_1(self.encoder_2_0(en_16x))
        de_16x = self.agg_2(torch.cat(
            [self.decoder_2(en_32x), self.encoder_3_1(self.encoder_3_0(de_8x))], dim=-1))
        x = self.agg_3(torch.cat([self.decoder_3(de_16x), de_8x], dim=-1))
        return x, de_8x


# ------------------------------------------------------ distillation losses


def afd_low_loss(lidar_bev: torch.Tensor, radar_bev: torch.Tensor):
    """Activation-based feature distillation: masked MSE between the densified
    radar BEV and the teacher's x_conv4, plus an L1 occupancy loss. NHWC
    inputs (B, H, W, C). Returns (feature_loss, mask_loss)."""
    lidar_act = lidar_bev.sum(dim=-1, keepdim=True)
    lidar_mask = (lidar_act > 0).float()
    radar_act = radar_bev.sum(dim=-1, keepdim=True)

    activate = (radar_act > 0).float() + lidar_mask * 0.5
    m_rl = (activate == 1.5).float()  # radar and lidar active
    m_rd = (activate == 1.0).float()  # radar active, lidar not
    # Σm_rl, Σm_rd, the batch size and the cell count of the mask mean
    n_rl, n_rd, B, cells = batch_sum(torch.stack([
        m_rl.sum(), m_rd.sum(), m_rl.new_tensor(radar_bev.shape[0]),
        m_rl.new_tensor(radar_act.numel())]))
    m_rd = m_rd * (n_rl / torch.clamp(n_rd, min=1.0))

    sq = (radar_bev.float() - lidar_bev.float()) ** 2
    loss_rl = (sq * m_rl).sum() / B
    loss_rd = (sq * m_rd).sum() / B
    feature_loss = 3e-4 * loss_rl + 5e-5 * loss_rd

    mask_loss = torch.abs(torch.sigmoid(radar_act.float()) - lidar_mask).sum() / cells
    return feature_loss, mask_loss


def pfd_high_loss(radar_bev, radar_bev_8x, lidar_bev, lidar_bev_8x, gt_heatmap_max,
                  radar_heatmap_max):
    """Proposal-based feature distillation: TP/FN/FP-weighted L1 between the
    channel-softmaxed neck features of teacher and student at both scales.
    gt_heatmap_max / radar_heatmap_max: (B, H, W, 1), the max over all classes
    of the GT heatmap / the clip-sigmoided radar hm predictions."""
    thres = gt_thres = 0.1
    fp = (gt_heatmap_max < gt_thres) & (radar_heatmap_max > thres)
    fn = (gt_heatmap_max > gt_thres) & (radar_heatmap_max < thres)
    tp = (gt_heatmap_max > gt_thres) & (radar_heatmap_max > thres)
    tp_fn = tp | fn
    n_tp_fn, n_fp = batch_sum(torch.stack([tp_fn.sum().float(), fp.sum().float()]))
    weight = (tp_fn.float() * (5.0 / torch.clamp(n_tp_fn, min=1.0))
              + fp.float() * (1.0 / torch.clamp(n_fp, min=1.0)))

    def scaled_l1(a, b):
        sa = torch.softmax(a.float(), dim=-1)
        sb = torch.softmax(b.float(), dim=-1)
        return (torch.abs(sa - sb) * weight).sum()

    return 0.5 * (scaled_l1(radar_bev, lidar_bev) + scaled_l1(radar_bev_8x, lidar_bev_8x))


def distill_loss(outputs: dict):
    """Total distillation loss 5·low + 25·high. ``outputs`` carries (NHWC) the
    teacher's 'x_conv4', the student's 'radar_spatial_features_8x_2'/'_8x_1',
    both necks' 'spatial_features_2d{,_8x}' and their radar twins, the GT
    'heatmaps' (B, H, W, ncls over all heads) and 'radar_hm_preds' (logits)."""
    feat_l, mask_l = afd_low_loss(outputs["x_conv4"], outputs["radar_spatial_features_8x_2"])
    feat_l8, mask_l8 = afd_low_loss(outputs["x_conv4"], outputs["radar_spatial_features_8x_1"])

    gt_hm_max = outputs["heatmaps"].amax(dim=-1, keepdim=True)
    radar_hm_max = clip_sigmoid(outputs["radar_hm_preds"]).amax(dim=-1, keepdim=True)
    high = pfd_high_loss(
        outputs["radar_spatial_features_2d"], outputs["radar_spatial_features_2d_8x"],
        outputs["spatial_features_2d"], outputs["spatial_features_2d_8x"],
        gt_hm_max, radar_hm_max) * 25.0
    low = (0.5 * (feat_l + feat_l8) + 0.5 * (mask_l + mask_l8)) * 5.0
    total = low + high
    tb = {
        "low_feature_loss": low,
        "high_distill_loss": high,
        "distll_loss": total,
        "low_distill_de_8x_loss": feat_l8,
        "low_distill_loss": feat_l,
        "mask_loss": mask_l,
        "mask_de_8x_loss": mask_l8,
    }
    return total, tb
