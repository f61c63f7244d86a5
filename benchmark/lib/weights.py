"""The weights of a run, drawn on the card from ``--seed``.

The benchmark makes the weights itself and hands the same values to the
program and to the reference: the names and shapes come from the model's
``state_dict``, the values from one ``torch.Generator`` on the device, in
one call for the whole model. The law is the program's ``init_random_`` (a
random model that exercises every term): kernels uniform on
±sqrt(6 / fan_in), BN scales 1 ± 0.25, biases ±0.1, running means ±0.1 and
variances 1 ± 0.25, and the heatmap output bias at the reference's -2.19
prior.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _fan_in(name: str, shape, module_kind: str) -> int:
    """fan_in of a kernel by its layout: the HWIO holders (``kernel``,
    ``down_weight``, ``*_kernel``) (k, k, I, O); a transposed conv (I, O, k,
    k); else (O, I/groups, k, k) or a dense (O, I)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("kernel", "down_weight") or leaf.endswith("_kernel"):
        return shape[0] * shape[1] * shape[2]
    if module_kind == "ConvTranspose2dTorch":
        return shape[0] * shape[2] * shape[3]
    return math.prod(shape[1:])


def _law(name: str, t: torch.Tensor, module_kind: str, is_param: bool):
    """(lo, hi) of the uniform law of one entry, or None to leave it as the
    model holds it (integer buffers)."""
    if not t.is_floating_point():
        return None
    leaf = name.rsplit(".", 1)[-1]
    if is_param and t.dim() >= 2 and leaf not in ("gamma", "beta"):
        b = math.sqrt(6.0 / _fan_in(name, tuple(t.shape), module_kind))
        return -b, b
    if name.endswith("hm.conv_out.bias"):
        return -2.19, -2.19
    if (is_param and leaf == "weight") or name.endswith("running_var"):
        return 0.75, 1.25
    if is_param or name.endswith("running_mean"):
        return -0.1, 0.1
    return None


def make_weights(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for every floating entry of ``model.state_dict()``
    that has a law, in the entry's dtype, on ``device``; the same ``seed``
    gives the same values for every model with the same entries."""
    kinds = {}
    for mname, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            kinds[f"{mname}.{leaf}" if mname else leaf] = type(mod).__name__
    params = {n for n, _ in model.named_parameters()}
    entries = []
    for name, t in model.state_dict().items():
        law = _law(name, t, kinds.get(name, ""), name in params)
        if law is not None:
            entries.append((name, t, law))
    total = sum(t.numel() for _, t, _ in entries)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    flat = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, t, (lo, hi) in entries:
        u = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        out[name] = (u * (hi - lo) + lo).to(t.dtype)
    return out


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s entries of those names."""
    state = model.state_dict()
    with torch.no_grad():
        for name, v in weights.items():
            state[name].copy_(v)
