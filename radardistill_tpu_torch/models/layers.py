"""Shared building blocks, eval only, NHWC at every interface.

Counterpart of ``radardistill_tpu/models/layers.py``. Each module's submodule
and parameter names mirror the flax scopes (``conv``, ``bn``, ``ln``, ...) so
``convert.py`` maps the JAX variables by a tree walk. Convolutions run on the
NCHW view of the NHWC tensor (``permute``, no copy): PyTorch treats it as
``channels_last`` and hands back an output that permutes to contiguous NHWC.

Parameters are kept in float32 and cast to the activation's dtype where they
are used, so one model serves the float32 reference and the bfloat16 path.
BatchNorm runs on its running statistics (this slice has no train mode).
Parameters are created empty; ``init_random_`` fills a model from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# reference eps: sparse backbone + neck BNs 1e-3, head / CMA BNs 1e-5
BN_EPS_BACKBONE = 1e-3
BN_EPS_DEFAULT = 1e-5


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


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


class BatchNormTorch(nn.Module):
    """Eval BatchNorm over the last axis, flax's order of operations:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in x's dtype."""

    def __init__(self, features, eps=BN_EPS_DEFAULT):
        super().__init__()
        self.eps = eps
        self.bn = BNParams(features)

    def forward(self, x):
        bn, dt = self.bn, x.dtype
        mul = torch.rsqrt(bn.running_var.to(dt) + self.eps) * bn.weight.to(dt)
        return (x - bn.running_mean.to(dt)) * mul + bn.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """The reference's BN1d over active-site lists, eval mode: the running
    statistics normalize every row; callers re-mask inactive rows. Computed
    in float32, returned in x's dtype."""

    def __init__(self, features, eps=BN_EPS_BACKBONE):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        y = ((x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
             * self.weight + self.bias)
        return y.to(x.dtype)


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
                if leaf == "down_weight":  # HWIO
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
