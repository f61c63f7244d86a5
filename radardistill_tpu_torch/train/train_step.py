"""The train step: frozen teacher forward, student forward in train mode,
targets, head + distillation losses, backward, clip, AdamW with the one-cycle
schedules, BN running statistics updated.

Counterpart of ``radardistill_tpu/train/train_step.py::make_train_step`` on
one device (its ``sync_bn or mesh is None`` leg). PyTorch runs eagerly, so
the step is a closure over the model and the optimizer, which hold the state
that the reference threads through ``TrainState`` (``TrainState`` here only
names them and counts the steps). Parameters, BN statistics and optimizer
moments are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..models import compute_training_loss
from .optim import OneCycleAdamW


@dataclass
class TrainState:
    """What a train step changes: the model (parameters and BN statistics),
    the optimizer (moments, update count) and the number of steps taken."""

    model: nn.Module
    optimizer: OneCycleAdamW
    step: int = 0


def dcn_offset_sat(model: nn.Module):
    """Mean, over the DCN sites that ran in train mode, of the share of their
    offsets beyond the kernels' clamp (None when there is no such site)."""
    sats = [m.dcn_offset_sat for m in model.modules()
            if getattr(m, "dcn_offset_sat", None) is not None]
    return sum(sats) / len(sats) if sats else None


def make_train_step(model: nn.Module, optimizer: OneCycleAdamW, model_cfg, class_names,
                    voxel_size, point_cloud_range, mesh=None, sync_bn=True
                    ) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> metrics`` (``loss``, the loss terms,
    ``grad_norm``, ``dcn_offset_sat``, ``as_overflow``), every value a tensor
    on the model's device: nothing in the step waits for the device. It runs
    where ``model`` and ``batch`` live: the card unless the model was built
    with ``device="cpu"``. ``step.state`` is the ``TrainState``."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step over a mesh (the shard_map leg, sync_bn=False) is not ported")
    del sync_bn  # one device: the batch's statistics are the global ones
    state = TrainState(model, optimizer)

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        optimizer.zero_grad()
        out = model(batch)
        loss, tb = compute_training_loss(model_cfg, out, class_names, voxel_size,
                                         point_cloud_range)
        sat = dcn_offset_sat(model)
        if sat is not None:
            tb["dcn_offset_sat"] = sat
        loss.backward()
        tb["grad_norm"] = optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}

    step.state = state
    return step
