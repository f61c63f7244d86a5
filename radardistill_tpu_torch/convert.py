"""Weight bridge: the JAX package's variables -> the port's ``state_dict``.

The port's module names are the flax scope names, so the bridge walks the
flax tree (``{"params": ..., "batch_stats": ...}`` of numpy arrays) and maps
each leaf by one rule per leaf kind:

  - conv kernel HWIO -> OIHW; the same transpose takes a depthwise kernel
    (7, 7, 1, C) to (C, 1, 7, 7) and a head ``_BlockDiagConv`` kernel
    (3, 3, cin/n, n*co) to the grouped (n*co, cin/n, 3, 3);
  - ``ConvTranspose2dTorch`` kernel (k, k, I, O) -> (I, O, k, k), the inverse of
    ``tools/convert_torch_ckpt.py::t_deconv``;
  - Dense kernel (I, O) -> (O, I);
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
    LayerNorm scale -> weight;
  - GRN gamma/beta (1, 1, 1, C), the DCN's HWIO ``down_weight`` and its
    ``down_bias`` unchanged;
  - the ``KernelHolder`` kernels of a 3D backbone's stage 1
    (``conv1_0/conv1/conv/kernel``, ``conv2_down/conv/conv/kernel``, in the
    space-to-depth teacher, the dense ``PillarRes18BackBone8x`` and the
    active-site radar backbone alike) stay HWIO under the name ``kernel``,
    because the packed kernels are assembled from that layout; the S2D
    teacher's ``PackedMaskedBatchNorm`` vectors map like any BatchNorm. So
    both teachers take one ``state_dict``, and both radar backbones another;
  - a tile-sparse stage's flat leaves (``b0_conv1_kernel`` HWIO,
    ``b0_conv1_bias``) keep their names and layout;
  - the anchor head's flax ``nn.Conv`` kernels (k, k, I, O) -> (O, I, k, k),
    as any conv's.

A reference pcdet ``.pth`` loads through ``tools/torch_convert_ckpt.py``
(``pcdet_convert.py``, the port's copy of the JAX tool's ``Converter``, which
maps it straight to this ``state_dict``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from .models.backbone_tile_sparse import TileSparseResStage
from .models.center_head import _BlockDiagConv
from .models.layers import ConvParams, ConvTranspose2dTorch, Dense, KernelHolder

LEAF_NAMES = {
    "params": {"kernel": "weight", "scale": "weight", "bias": "bias", "gamma": "gamma",
               "beta": "beta", "down_weight": "down_weight", "down_bias": "down_bias"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _walk(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _layout(module: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel" or isinstance(module, KernelHolder):
        return arr
    if isinstance(module, ConvTranspose2dTorch):
        return arr.transpose(2, 3, 0, 1)
    if isinstance(module, Dense):
        return arr.T
    if isinstance(module, (ConvParams, _BlockDiagConv)):
        return arr.transpose(3, 2, 0, 1)
    raise TypeError(f"no kernel layout rule for {type(module).__name__}")


def state_dict_from_jax(model: nn.Module, variables) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree onto ``model``'s parameter and buffer names."""
    state = {}
    for coll, names in LEAF_NAMES.items():
        for path, arr in _walk(variables.get(coll, {})):
            *scope, leaf = path
            module = model.get_submodule(".".join(scope))
            name = leaf if isinstance(module, (KernelHolder, TileSparseResStage)) else names[leaf]
            state[".".join([*scope, name])] = torch.from_numpy(
                np.array(_layout(module, leaf, arr), dtype=np.float32, order="C"))
    return state


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Load the JAX package's variables into ``model`` (every parameter and
    buffer must be covered, and nothing may be left over)."""
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model
