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

A checkpoint of the JAX package (``train/jax_ckpt.py`` reads it) maps onto a
``TrainState`` through ``optimizer_state_from_jax`` too: optax's state of
``build_optimizer``'s three rules (``adam_onecycle`` and ``adam``:
``scale_by_adam``'s ``count`` / ``mu`` / ``nu``; ``sgd``: ``trace``'s
``trace``; all under ``inject_hyperparams``, whose ``count`` the schedules
read) becomes ``ClippedOptimizer.state_dict()``. Each moment takes its
parameter's layout rule; the leaves ``optax.masked`` left out (``None``) are
the frozen parameters, which the port's optimizer does not hold.
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
    """(path, array) of every leaf but ``None``; a tensor leaf (the JAX
    checkpoint reader's) as numpy, ``bfloat16`` widened to float32."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        elif torch.is_tensor(v):
            yield path + (k,), (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        elif v is not None:
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


def state_dict_from_jax(model: nn.Module, variables, twins=None) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree onto ``model``'s parameter and buffer names.
    With ``twins`` (a scope -> scope map; a non-strict load) a leaf of a
    scope that ``model`` lacks takes the layout of the same module in the
    scope's twin, under its own name, or is left out where there is none."""
    state = {}
    for coll, names in LEAF_NAMES.items():
        for path, arr in _walk(variables.get(coll, {})):
            *scope, leaf = path
            module = _module(model, scope, twins)
            if module is None:
                continue
            name = leaf if isinstance(module, (KernelHolder, TileSparseResStage)) else names[leaf]
            state[".".join([*scope, name])] = torch.from_numpy(
                np.array(_layout(module, leaf, arr), dtype=np.float32, order="C"))
    return state


def _module(model: nn.Module, scope, twins):
    """``model``'s module at ``scope``; with ``twins``, where ``model`` lacks
    it, the same module in the twin scope, or None."""
    try:
        return model.get_submodule(".".join(scope))
    except AttributeError:
        if twins is None:
            raise
    if scope and scope[0] in twins:
        try:
            return model.get_submodule(".".join([twins[scope[0]], *scope[1:]]))
        except AttributeError:
            pass
    return None


def _find(tree, keys):
    """Every dict of ``tree`` (nested dicts and lists) that has ``keys``."""
    if isinstance(tree, dict):
        if keys <= tree.keys():
            yield tree
        for v in tree.values():
            yield from _find(v, keys)
    elif isinstance(tree, list):
        for v in tree:
            yield from _find(v, keys)


def _one(tree, keys, what):
    found = list(_find(tree, keys))
    if len(found) != 1:
        raise ValueError(f"optimizer state with {len(found)} {what} states, not one")
    return found[0]


def optimizer_state_from_jax(model: nn.Module, optimizer, opt_state) -> dict:
    """``optimizer.state_dict()`` (a ``ClippedOptimizer`` over ``model``'s
    trainable parameters) as the JAX package's optax state ``opt_state``
    holds it: the schedules' update count, and AdamW's moments and step (the
    bias correction's count) or SGD's momentum buffers. Raises ValueError
    where ``opt_state`` is another rule's or covers other parameters."""
    adam = optimizer.kind == "adamw"
    keys = ("mu", "nu") if adam else ("trace",)
    moments = _one(opt_state, {"count", *keys} if adam else set(keys), optimizer.kind)
    count = int(_one(opt_state, {"count", "hyperparams", "inner_state"},
                     "inject_hyperparams")["count"])
    name_of = {id(p): n for n, p in model.named_parameters()}
    names = [name_of[id(p)] for p in optimizer.params]
    mapped = {key: state_dict_from_jax(model, {"params": moments[key]}, twins={})
              for key in keys}
    for key, sd in mapped.items():
        if sd.keys() != set(names):
            raise ValueError(f"optimizer state of other parameters: {key} has "
                             f"{len(sd)} entries, the optimizer {len(names)} parameters")
    if adam:
        step = torch.tensor(float(moments["count"]), dtype=torch.float32)
        state = {i: {"step": step.clone(), "exp_avg": mapped["mu"][n],
                     "exp_avg_sq": mapped["nu"][n]} for i, n in enumerate(names)}
    else:
        state = {i: {"momentum_buffer": mapped["trace"][n]} for i, n in enumerate(names)}
    groups = optimizer.inner.state_dict()["param_groups"]
    return {"count": count, optimizer.kind: {"state": state, "param_groups": groups}}


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Load the JAX package's variables into ``model`` (every parameter and
    buffer must be covered, and nothing may be left over)."""
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model
