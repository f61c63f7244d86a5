"""Shared building blocks, NHWC at every interface.

Counterpart of ``radardistill_tpu/models/layers.py``. Each module's submodule
and parameter names mirror the flax scopes (``conv``, ``bn``, ``ln``, ...) so
``convert.py`` maps the JAX variables by a tree walk. Convolutions run on the
NCHW view of the NHWC tensor (``permute``, no copy): PyTorch treats it as
``channels_last`` and hands back an output that permutes to contiguous NHWC.

Parameters are kept in float32 and cast to the activation's dtype where they
are used, so one model serves the float32 reference and the bfloat16 path.
The BatchNorms follow ``nn.Module.training``: in eval mode they read their
running statistics, in train mode they normalize with the batch's statistics
and update the running ones in place (the detector keeps frozen scopes in
eval mode). Parameters are created empty; ``init_random_`` fills a model from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_block import int_conv_exact

# reference eps and momentum (torch convention: the share of the batch's
# statistic in the update): sparse backbone + neck BNs 1e-3 / 0.01, head and
# CMA BNs 1e-5 / 0.1
BN_EPS_BACKBONE, BN_MOM_BACKBONE = 1e-3, 0.01
BN_EPS_DEFAULT, BN_MOM_DEFAULT = 1e-5, 0.1


# Static-scale int8 chain of the frozen teacher: activation bounds follow
# analytically from the eval-mode BatchNorm parameters (post-BN activations
# have mean beta and std gamma under the running statistics, so
# |y| <= max_c(|beta_c| + K * |gamma_c|)), which makes every quantize a pure
# elementwise epilogue; activations flow as int8 between convs. No new state:
# the bounds are derived from the parameters.
INT8_SIGMA = 6.0  # K in the analytic bound; outliers beyond K sigma saturate


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def int8_qkernel(kernel):
    """Per-output-channel symmetric int8 quantization of an HWIO kernel.
    Returns (kq int8, sw (Co,) float32 dequant scales)."""
    kf = kernel.float()
    sw = torch.clamp(kf.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
    return torch.round(kf / sw).to(torch.int8), sw


def int8_conv_i32(xq, kq, stride, padding, pad_value=0):
    """int8 x int8 NHWC conv accumulated exactly in int32 (HWIO kernel,
    explicit ((top, bottom), (left, right)) padding filled with
    ``pad_value``). PyTorch has no int8 convolution on CUDA; this is one
    exact float32 matmul per tap (``ops.conv_block.int_conv_exact``)."""
    return int_conv_exact(xq, kq, stride, padding, pad_value)


def q8(y, bound, zero=0.0):
    """Quantize float32 y to int8 with zero point ``zero`` (0 = symmetric
    signed; 127 = unsigned-in-signed for post-relu tensors: y in [0, bound]
    maps to [-127, 127]). Dequant: (q + zero) * bound / (127 + zero)."""
    s = (127.0 + zero) / torch.clamp(bound, min=1e-8)
    return torch.clamp(torch.round(y * s) - zero, -127.0, 127.0).to(torch.int8)


def deq8(xq, bound, zero=0.0):
    return (xq.float() + zero) * (torch.clamp(bound, min=1e-8) / (127.0 + zero))


def int8_conv_affine(xc, kq, sw, bias, gt, sh, stride, padding):
    """One chain link from stock ops: the int8 conv and the whole dequant,
    bias and BN affine as one elementwise epilogue. A carry with a zero point
    is padded with ``-zero`` (a cell that dequantizes to an exact 0) and the
    constant ``zero * sum(kq)`` folds into the accumulator. xc = (xq int8
    NHWC, bound, zero). Returns pre-relu float32."""
    xq, bnd, zero = xc
    s_in = torch.clamp(bnd, min=1e-8) / (127.0 + zero)
    y = int8_conv_i32(xq, kq, stride, padding, pad_value=-int(zero)).float()
    if zero:
        y = y + zero * kq.float().sum(dim=(0, 1, 2))
    alpha = s_in * sw * gt
    beta = sh if bias is None else bias * gt + sh
    return y * alpha + beta


def bn_affine(scale, bias, mean, var, eps):
    """Eval-mode BN as (gt, shift, bound): y = gt * x + shift, and the
    analytic bound max(|bias| + INT8_SIGMA * |scale|) of its output."""
    gt = torch.rsqrt(var + eps) * scale
    return gt, bias - mean * gt, torch.max(bias.abs() + INT8_SIGMA * scale.abs())


def max_pool_mask(mask, kernel: int = 3, stride: int = 2, padding: int = 1):
    """Dilate an occupancy mask the way a strided SparseConv2d grows the
    active set: an output site is active iff any input site of its window is.
    mask (B, H, W) bool -> (B, H', W') bool."""
    y = F.max_pool2d(mask[:, None].float(), kernel, stride, padding)
    return y[:, 0] > 0


class ConvParams(nn.Module):
    """Conv weight (O, I/groups, k, k) and optional bias — the ``conv`` scope."""

    def __init__(self, in_ch, out_ch, kernel_size, groups=1, use_bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if use_bias else None


class Conv2dTorch(nn.Module):
    """NHWC conv with torch-style symmetric padding (params under ``conv``)."""

    def __init__(self, in_ch, features, kernel_size=3, stride=1, padding=0,
                 use_bias=False, groups=1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.conv = ConvParams(in_ch, features, kernel_size, groups, use_bias)

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.conv.weight.to(x.dtype),
                     _cast(self.conv.bias, x.dtype), self.stride, self.padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2dTorch(nn.Module):
    """torch ConvTranspose2d(k, s, p) on NHWC: out = (in-1)*s - 2p + k.
    Weight (I, O, k, k), the torch layout."""

    def __init__(self, in_ch, features, kernel_size, stride, padding=0, use_bias=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(in_ch, features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               _cast(self.bias, x.dtype), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """flax nn.Dense: weight (out, in), bias (out,)."""

    def __init__(self, in_features, out_features, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class BNParams(nn.Module):
    """Affine params + running statistics of one BatchNorm (the ``bn`` scope)."""

    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))


def batch_stats(x32: torch.Tensor):
    """Per-channel mean and *biased* variance over every axis but the last,
    single pass in float32: ``var = max(E[x²] - E[x]², 0)`` (flax's
    ``nn.BatchNorm``)."""
    axes = tuple(range(x32.dim() - 1))
    mean = x32.mean(dim=axes)
    var = torch.clamp((x32 * x32).mean(dim=axes) - mean * mean, min=0.0)
    return mean, var


@torch.no_grad()
def update_running_(running: torch.Tensor, value: torch.Tensor, momentum: float):
    """``running <- (1 - momentum) * running + momentum * value``, in place."""
    running.mul_(1.0 - momentum).add_(value.to(running.dtype), alpha=momentum)


class BatchNormTorch(nn.Module):
    """BatchNorm over the last axis, flax's order of operations:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in x's dtype. Eval: the
    running statistics. Train: the batch's mean and biased variance, computed
    in float32, which also update the running statistics (flax's
    ``nn.BatchNorm`` updates with the *biased* variance, unlike
    ``F.batch_norm``)."""

    def __init__(self, features, eps=BN_EPS_DEFAULT, momentum=BN_MOM_DEFAULT):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.bn = BNParams(features)

    def forward(self, x):
        bn, dt = self.bn, x.dtype
        if self.training:
            mean, var = batch_stats(x.float())
            update_running_(bn.running_mean, mean, self.momentum)
            update_running_(bn.running_var, var, self.momentum)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var.to(dt) + self.eps) * bn.weight.to(dt)
        return (x - mean.to(dt)) * mul + bn.bias.to(dt)

    def affine(self):
        """The eval BN as (gt, shift, bound) for the int8 chain (``bn_affine``)."""
        bn = self.bn
        return bn_affine(bn.weight, bn.bias, bn.running_mean, bn.running_var, self.eps)


class MaskedBatchNorm(nn.Module):
    """The reference's BN1d over active-site lists: every row is normalized and
    callers re-mask inactive rows. Computed in float32, returned in x's dtype.
    Eval: the running statistics. Train: statistics over the rows that
    ``mask`` (broadcastable to ``x[..., 0]``) marks active, single pass
    (Σx, Σx²) with ``n = max(Σmask, 1)``; the running variance is updated with
    the *unbiased* batch variance, as torch's BN1d does."""

    def __init__(self, features, eps=BN_EPS_BACKBONE, momentum=BN_MOM_BACKBONE):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, mask=None):
        x32 = x.float()
        if self.training:
            if mask is None:
                raise ValueError("MaskedBatchNorm in train mode needs the active mask")
            m = mask.to(torch.float32)
            n = torch.clamp(m.sum(), min=1.0)
            axes = tuple(range(x.dim() - 1))
            xm = x32 * m[..., None]
            mean = xm.sum(dim=axes) / n
            var = torch.clamp((xm * x32).sum(dim=axes) / n - mean * mean, min=0.0)
            update_running_(self.running_mean, mean, self.momentum)
            update_running_(self.running_var, var * n / torch.clamp(n - 1.0, min=1.0),
                            self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)

    def affine(self):
        """The eval BN as (gt, shift, bound) for the int8 chain (``bn_affine``)."""
        return bn_affine(self.weight, self.bias, self.running_mean, self.running_var, self.eps)


class LNParams(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


class LayerNormTorch(nn.Module):
    """Channels-last LayerNorm, eps 1e-6 (params under ``ln``)."""

    def __init__(self, features, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.ln = LNParams(features)

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.ln.weight.to(x.dtype),
                            self.ln.bias.to(x.dtype), self.eps)


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXt-v2), NHWC; gamma/beta (1,1,1,C)."""

    def __init__(self, features):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, features))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, features))

    def forward(self, x):
        gx = torch.sqrt(torch.sum(torch.square(x.float()), dim=(1, 2), keepdim=True))
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return (self.gamma * (x * nx.to(x.dtype)) + self.beta + x).to(x.dtype)


def clip_sigmoid(x, eps=1e-4):
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and BN statistic from ``generator``.

    Weights: uniform ±sqrt(6 / fan_in) (variance-preserving through a ReLU).
    Biases, BN affine/statistics, LayerNorm affine, GRN gamma/beta and the
    DCN's frozen bias get small values away from the 0/1 defaults, so a
    random model exercises every term. Head ``hm`` output biases keep the
    reference's -2.19 prior (center_head init_bias)."""

    def uni(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * (2 * bound) - bound)

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2 and leaf not in ("gamma", "beta"):
                if leaf in ("down_weight", "kernel"):  # HWIO
                    fan_in = p.shape[0] * p.shape[1] * p.shape[2]
                elif p.dim() == 4 and name.endswith("deconv.weight"):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:
                    fan_in = math.prod(p.shape[1:])
                uni(p, math.sqrt(6.0 / fan_in))
            elif name.endswith("hm.conv_out.bias"):
                p.fill_(-2.19)
            elif leaf == "weight":  # BN / LayerNorm scale
                uni(p, 0.25)
                p.add_(1.0)
            else:  # biases, GRN gamma/beta, DCN down_bias
                uni(p, 0.1)
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                uni(b, 0.1)
            elif name.endswith("running_var"):
                uni(b, 0.25)
                b.add_(1.0)
    return model
