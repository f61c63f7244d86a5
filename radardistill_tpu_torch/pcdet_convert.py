"""Import a reference pcdet checkpoint: its ``model_state`` -> the port's
``state_dict``.

The port's own copy of ``tools/convert_torch_ckpt.py``'s ``Converter``
(SURVEY.md §7 hard part 6: load the released ``pillarnet_fullset_lidar.pth``
teacher without retraining). Each pcdet key maps straight to the port's
``state_dict`` key and layout; the result is, key for key and bit for bit,
what the JAX tool's flax tree becomes through ``convert.state_dict_from_jax``
(``tests/test_torch_pcdet_convert.py``). ``tools/torch_convert_ckpt.py`` writes
it as a port checkpoint.

This is a file transform on the host, as its JAX counterpart is: it builds no
model and touches no device. Its tensors are float32 on the CPU; a checkpoint
load moves them to wherever the model lives.

Layouts. The port's module names are the flax scope names, and its Conv2d,
depthwise, Linear and ConvTranspose2d layouts are pcdet's, so most entries are
only renamed:

- Conv2d (O, I, kH, kW), depthwise (C, 1, kH, kW), Linear (O, I),
  ConvTranspose2d (I, O, k, k): unchanged;
- spconv SubM/SparseConv2d weights arrive as (O, kH, kW, I) from spconv 2.x
  and (kH, kW, I, O) from 1.x, told apart by shape exactly as the JAX tool's
  ``t_spconv`` does (dims 1 and 2 equal, one of 1, 3, 5, 7, and dim 0 another
  number means 2.x; anything else is taken as 1.x). They go to OIHW
  ``weight``, except the stage-1 convs of either 3D backbone (``conv1_0``,
  ``conv1_1``, ``conv2_down``), which every backbone of the port keeps HWIO
  under ``kernel`` (``layers.KernelHolder``);
- the DCN's ``down_layer``: its weight to the HWIO ``down_weight``, its
  frozen-at-init bias (present in reference checkpoints despite
  ``bias=False``) to ``down_bias``;
- BatchNorm ``weight`` / ``bias`` / ``running_mean`` / ``running_var`` keep
  their names (under ``bn`` where the port's module wraps one), LayerNorm's go
  under ``ln``; ``num_batches_tracked`` is dropped;
- the 6 ``SeparateHead``s of a ``CenterHead``: each subhead's per-head
  tensors are stacked along the output channels into the merged head's dense
  ``conv_0`` + ``bn_0`` and grouped ``conv_out`` (head h in channels
  [h·O, (h+1)·O)), the ``hm`` outputs padded with zero channels to
  ``max_cls``.

Keys outside the JAX tool's tables (``roi_head.*``, a layer it does not know)
come back in ``unmapped``: the JAX tool's list, in its order. Like that tool,
this covers the merged ``CenterHead`` family only (no anchor head).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch

HWIO_BLOCKS = ("conv1_0", "conv1_1", "conv2_down")  # a 3D backbone's stage 1


def _ndim(w, n):
    """``w``, or ValueError where the JAX tool's transpose would raise."""
    if w.ndim != n:
        raise ValueError(f"expected a {n}-D tensor, got shape {w.shape}")
    return w


def _spconv_2x(w) -> bool:
    return w.shape[1] == w.shape[2] and w.shape[1] in (1, 3, 5, 7) and w.shape[0] != w.shape[1]


def spconv_hwio(w):
    """An spconv weight (2.x (O, kH, kW, I) or 1.x (kH, kW, I, O)) as HWIO."""
    if w.ndim != 4:
        return w
    return w.transpose(1, 2, 3, 0) if _spconv_2x(w) else w


def spconv_oihw(w):
    """An spconv weight (2.x or 1.x layout) as OIHW."""
    if w.ndim != 4:
        return w
    return w.transpose(0, 3, 1, 2) if _spconv_2x(w) else w.transpose(3, 2, 0, 1)


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


class PcdetConverter:
    """One conversion: ``convert(sd)`` -> (state_dict, unmapped)."""

    def __init__(self):
        self.state: Dict[str, torch.Tensor] = {}
        self.unmapped: List[str] = []
        # per-(scope, subhead) head tensors, stacked by finalize_heads
        self.head_stash = defaultdict(dict)

    def put(self, path, value):
        self.state[".".join(path)] = _tensor(value)

    # -- leaf writers --------------------------------------------------------

    def conv(self, path, leaf, val, spconv=False):
        """A conv's ``weight`` and ``bias`` under ``path``; an spconv weight is
        re-laid out, to HWIO ``kernel`` in a backbone's stage 1."""
        if leaf == "weight":
            if not spconv:
                self.put(path + ("weight",), _ndim(val, 4))
            elif path[1] in HWIO_BLOCKS:
                self.put(path + ("kernel",), spconv_hwio(val))
            else:
                self.put(path + ("weight",), spconv_oihw(val))
        elif leaf == "bias":
            self.put(path + ("bias",), val)

    def bn(self, path, leaf, val):
        if leaf in ("weight", "bias", "running_mean", "running_var"):
            self.put(path + (leaf,), val)

    def layer_norm(self, path, leaf, val):
        self.put(path + ("ln", "weight" if leaf == "weight" else "bias"), val)

    def dense(self, path, leaf, val, ndim=2):
        """A Linear's weight (a ConvTranspose2d's with ``ndim`` 4); any other
        leaf as its bias, as the JAX tool takes them."""
        if leaf == "weight":
            self.put(path + ("weight",), _ndim(val, ndim))
        else:
            self.put(path + ("bias",), val)

    # -- per-module mappers --------------------------------------------------

    def map_vfe(self, scope, parts, leaf, val):
        # parts = ['pfn_layers', K, 'linear'|'norm']
        k, sub = parts[1], parts[2]
        if sub == "linear":
            self.dense((scope, f"pfn_{k}", "linear"), leaf, val)
        elif sub == "norm":
            self.bn((scope, f"pfn_{k}", "norm"), leaf, val)
        else:
            raise KeyError(sub)

    def map_backbone(self, scope, parts, leaf, val):
        stage, idx = parts[0], int(parts[1])
        if stage in ("conv2", "conv3", "conv4") and idx == 0:
            # post_act_block down: Sequential(conv, norm, relu) -> '0'/'1'
            if parts[2] == "0":
                self.conv((scope, f"{stage}_down", "conv", "conv"), leaf, val, spconv=True)
            else:
                self.bn((scope, f"{stage}_down", "bn"), leaf, val)
            return
        if stage == "conv5":
            if idx == 0:  # dense Sequential(conv, bn, relu)
                if parts[2] == "0":
                    self.conv((scope, "conv5_down_conv", "conv"), leaf, val)
                else:
                    self.bn((scope, "conv5_down_bn", "bn"), leaf, val)
                return
            block = f"conv5_{idx - 1}"  # DenseBasicBlock
            mod = parts[2]
            if mod.startswith("conv"):
                self.conv((scope, block, mod, "conv"), leaf, val)
            else:
                self.bn((scope, block, mod, "bn"), leaf, val)
            return
        # residual SparseBasicBlocks: conv1.{0,1}, convN.{1,2}
        block = f"{stage}_{idx if stage == 'conv1' else idx - 1}"
        mod = parts[2]
        if mod.startswith("conv"):
            self.conv((scope, block, mod, "conv"), leaf, val, spconv=True)
        else:
            self.bn((scope, block, mod), leaf, val)

    def map_neck(self, scope, parts, leaf, val):
        # blocks.B.I: Sequential [ZeroPad, Conv, BN, ReLU] + n * [Conv, BN, ReLU]
        if parts[0] == "blocks":
            block, i = f"block{parts[1]}", int(parts[2])
            if i == 1:
                self.conv((scope, block, "conv_in", "conv"), leaf, val)
            elif i == 2:
                self.bn((scope, block, "bn_in", "bn"), leaf, val)
            elif (i - 4) % 3 == 0:
                self.conv((scope, block, f"conv_{(i - 4) // 3}", "conv"), leaf, val)
            elif (i - 5) % 3 == 0:
                self.bn((scope, block, f"bn_{(i - 5) // 3}", "bn"), leaf, val)
            else:
                raise KeyError(parts)
            return
        if parts[0] == "deblocks":
            # the one deblock the [1:] cut keeps: [ConvTranspose, BN, ReLU]
            i = int(parts[2])
            if i == 0:
                self.dense((scope, "deblock1_deconv"), leaf, val, ndim=4)
            elif i == 1:
                self.bn((scope, "deblock1_bn", "bn"), leaf, val)
            return
        raise KeyError(parts)

    def map_convnext(self, scope, block, parts, leaf, val):
        mod = parts[0]
        if mod == "dwconv":
            self.conv((scope, block, "dwconv", "conv"), leaf, val)
        elif mod == "norm":
            self.layer_norm((scope, block, "norm"), leaf, val)
        elif mod in ("pwconv1", "pwconv2"):
            self.dense((scope, block, mod), leaf, val)
        elif mod == "grn":
            # the reference names GRN's params gamma / beta (Basicblock_convn.py:89-90)
            self.put((scope, block, "grn", leaf), val)
        elif mod == "conv_offset_mask1":
            self.conv((scope, block, "conv_offset_mask1", "conv"), leaf, val)
        elif mod == "down_layer":
            if leaf == "weight":
                self.put((scope, block, "down_weight"), _ndim(val, 4).transpose(2, 3, 1, 0))
            elif leaf == "bias":
                self.put((scope, block, "down_bias"), val)
        else:
            raise KeyError(mod)

    def map_cma(self, parts, leaf, val):
        scope = "radar_cma"
        mod, idx = parts[0], parts[1]
        if mod.startswith("encoder"):
            self.map_convnext(scope, f"{mod}_{idx}", parts[2:], leaf, val)
        elif mod.startswith("decoder"):
            i = int(idx)
            if i == 0:
                self.dense((scope, mod, "deconv"), leaf, val, ndim=4)
            elif i == 1:
                self.bn((scope, mod, "bn", "bn"), leaf, val)
        elif mod.startswith("agg"):
            i = int(idx)
            if i == 0:
                self.conv((scope, mod, "conv", "conv"), leaf, val)
            elif i == 1:
                self.bn((scope, mod, "bn", "bn"), leaf, val)
        else:
            raise KeyError(mod)

    def map_head(self, scope, parts, leaf, val):
        if parts[0] == "shared_conv":
            i = int(parts[1])
            if i == 0:
                self.conv((scope, "shared_conv", "conv"), leaf, val)
            elif i == 1:
                self.bn((scope, "shared_bn", "bn"), leaf, val)
            return
        if parts[0] == "heads_list":
            # heads_list.H.<subhead>.I...: stashed for stacking
            h, sub = int(parts[1]), parts[2]
            rest = ".".join(parts[3:]) + "." + leaf
            self.head_stash[(scope, sub)].setdefault(h, {})[rest] = val
            return
        raise KeyError(parts)

    def finalize_heads(self, max_cls=2):
        """Stack the stashed per-head tensors of each subhead. A pcdet
        SeparateHead subhead is ``<sub>.0.0`` Conv, ``<sub>.0.1`` BN, ``<sub>.1``
        the output Conv (center_head.py:20-28); the port's merged head has
        ``conv_0`` (dense, all heads), ``bn_0`` and ``conv_out`` (grouped).
        Tensors the JAX tool does not stack (a third conv) are left out, as
        there."""
        for (scope, sub), heads in self.head_stash.items():
            n = len(heads)

            def cat(key, pad_to=None):
                vals = [heads[h][key] for h in range(n)]
                if key.endswith("weight") and key != "0.1.weight":  # a conv's
                    vals = [_ndim(v, 4) for v in vals]
                if pad_to is not None:  # hm channel padding
                    vals = [np.concatenate([v] + [np.zeros_like(v[:1])] * (pad_to - v.shape[0]), 0)
                            if v.shape[0] < pad_to else v for v in vals]
                return np.concatenate(vals, 0)

            path = (scope, sub)
            self.put(path + ("conv_0", "conv", "weight"), cat("0.0.weight"))
            if "0.0.bias" in heads[0]:
                self.put(path + ("conv_0", "conv", "bias"), cat("0.0.bias"))
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                self.put(path + ("bn_0", "bn", leaf), cat(f"0.1.{leaf}"))
            pad = max_cls if sub == "hm" else None
            self.put(path + ("conv_out", "weight"), cat("1.weight", pad))
            self.put(path + ("conv_out", "bias"), cat("1.bias", pad))

    # -- the conversion loop ------------------------------------------------

    def convert(self, sd, max_cls=2) -> Tuple[Dict[str, torch.Tensor], List[str]]:
        for key, val in sd.items():
            if key.endswith("num_batches_tracked"):
                continue
            val = np.asarray(val.detach().cpu().numpy() if hasattr(val, "detach") else val)
            parts = key.split(".")
            top, leaf, body = parts[0], parts[-1], parts[1:-1]
            try:
                if top in ("vfe", "radar_vfe"):
                    self.map_vfe(top, body, leaf, val)
                elif top in ("backbone_3d", "radar_backbone_3d"):
                    self.map_backbone(top, body, leaf, val)
                elif top == "backbone_2d":
                    self.map_neck("backbone_2d", body, leaf, val)
                elif top == "radar_backbone_2d":
                    # Radar_Distill: the inherited neck's members, or the CMA's
                    if body[0] in ("blocks", "deblocks"):
                        self.map_neck("radar_neck", body, leaf, val)
                    else:
                        self.map_cma(body, leaf, val)
                elif top in ("dense_head", "radar_dense_head"):
                    self.map_head(top, body, leaf, val)
                else:
                    self.unmapped.append(key)
            except (KeyError, IndexError, ValueError):
                self.unmapped.append(key)
        self.finalize_heads(max_cls=max_cls)
        return self.state, self.unmapped


def pcdet_convert(sd, max_cls: int = 2) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A pcdet ``model_state`` (torch tensors or numpy arrays) -> (the port's
    ``state_dict`` entries it supplies, the keys left unmapped)."""
    return PcdetConverter().convert(sd, max_cls=max_cls)
