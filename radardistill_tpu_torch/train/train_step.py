"""The train step: frozen teacher forward, student forward in train mode,
targets, head + distillation losses, backward, clip, AdamW with the one-cycle
schedules, BN running statistics updated; the train state and the eval step.

Counterpart of ``radardistill_tpu/train/train_step.py`` (``create_train_state``,
``make_train_step`` on one device, its ``sync_bn or mesh is None`` leg, and
``make_eval_step``). PyTorch runs eagerly, so the step is a closure over the
model and the optimizer, which hold the state that the reference threads
through ``TrainState`` (``TrainState`` here only names them). Parameters, BN
statistics and optimizer moments are updated in place.
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
    """What a train step changes: the model (parameters and BN statistics)
    and the optimizer (moments, update count). ``step``, the number of steps
    taken, is the optimizer's update count, so a restored optimizer restores
    it too."""

    model: nn.Module
    optimizer: OneCycleAdamW

    @property
    def step(self) -> int:
        return self.optimizer.count


def create_train_state(model: nn.Module, optim_cfg, total_steps: int,
                       generator: torch.Generator | None = None):
    """Counterpart of the JAX ``create_train_state`` (``model.init`` + the
    optimizer's init): draws every parameter of ``model`` from the
    reference's initializers (``layers.init_reference_``) with ``generator``
    (seed 0 when None, as the JAX package's ``PRNGKey(0)``), so the model
    never trains from uninitialized memory, then builds the optimizer of
    ``optim_cfg`` over its trainable parameters (``model.frozen`` frozen).
    Returns (TrainState, lr_sched)."""
    from ..models.layers import init_reference_
    from .optim import build_optimizer

    init_reference_(model, generator if generator is not None
                    else torch.Generator().manual_seed(0))
    optimizer, lr_sched = build_optimizer(optim_cfg, model, total_steps, model.frozen)
    return TrainState(model, optimizer), lr_sched


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
    ``dcn_offset_sat``, ``as_overflow``: the reference's keys), every value a
    tensor on the model's device: nothing in the step waits for the device.
    The gradients' global norm is ``optimizer.grad_norm``. It runs
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
        optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}

    step.state = state
    return step


def make_eval_step(model: nn.Module) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
    """Returns ``eval_step(batch) -> outputs`` (``final_box_dicts`` among
    them): the forward in eval mode without gradients, where ``model`` and
    ``batch`` live."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]) -> Dict[str, Any]:
        if model.training:
            model.eval()
        return model(batch)

    return eval_step
