"""The train step: frozen teacher forward, student forward in train mode,
targets, head + distillation losses, backward, clip, AdamW with the one-cycle
schedules, BN running statistics updated; the train state and the eval step.

Counterpart of ``radardistill_tpu/train/train_step.py`` (``create_train_state``,
``make_train_step`` with both of its data-parallel legs, and
``make_eval_step``). PyTorch runs eagerly, so the step is a closure over the
model and the optimizer, which hold the state that the reference threads
through ``TrainState`` (``TrainState`` here only names them). Parameters, BN
statistics and optimizer moments are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models import compute_training_loss
from ..parallel.mesh import Mesh, all_reduce_mean_, sync_batch, wrap_ddp
from ..utils.profiler import span
from .optim import ClippedOptimizer


@dataclass
class TrainState:
    """What a train step changes: the model (parameters and BN statistics)
    and the optimizer (moments, update count). ``step``, the number of steps
    taken, is the optimizer's update count, so a restored optimizer restores
    it too. ``loaded``: how many of the model's entries the last
    ``CheckpointManager.load_params_from_file`` took from its file, and
    ``duplicated`` how many radar parameters its teacher surgery copied."""

    model: nn.Module
    optimizer: ClippedOptimizer
    loaded: Optional[int] = None
    duplicated: Optional[int] = None

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


def make_train_step(model: nn.Module, optimizer: ClippedOptimizer, model_cfg, class_names,
                    voxel_size, point_cloud_range, mesh: Mesh | None = None, sync_bn=True
                    ) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> metrics`` (``loss``, the loss terms,
    ``dcn_offset_sat``, ``as_overflow``: the reference's keys), every value a
    tensor on the model's device: nothing in the step waits for the device.
    The gradients' global norm is ``optimizer.grad_norm``. It runs
    where ``model`` and ``batch`` live: the card unless the model was built
    with ``device="cpu"``. ``step.state`` is the ``TrainState``.

    With a ``mesh`` of processes (``parallel.mesh.make_mesh``), each rank
    passes its share of the global batch and the model trains under
    ``DistributedDataParallel`` (``step.ddp``); ``step.state`` keeps the
    unwrapped model. The two legs of the JAX package:

      sync_bn=True (default): the BN statistics and the losses' batch
        normalizers are the global batch's (``parallel.mesh.batch_sum``, at
        a world size above 1),
        each rank's loss is its share of the global loss, and the backward
        of ``world_size`` times that share makes DDP's average the global
        gradient: the step of one process on the global batch (what GSPMD
        computes). The metrics are the global ones on every rank.
      sync_bn=False: the shard_map leg, the reference's DDP default. Local BN
        statistics and normalizers, the gradient averaged by DDP, and the
        metrics and the updated running statistics averaged over the ranks.

    Both legs clip and update after the reduction, so every rank takes the
    same update. The backward and the optimizer's update run in the spans
    ``backward`` and ``optimizer``."""
    state = TrainState(model, optimizer)
    parallel = mesh is not None and mesh.group is not None
    net = wrap_ddp(model, mesh) if parallel else model
    # one rank's batch is the global one: no reduction at world size 1
    sync_group = mesh.group if parallel and sync_bn and mesh.world_size > 1 else None
    scale = mesh.world_size if sync_group is not None else 1

    def step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        optimizer.zero_grad()
        with sync_batch(sync_group):
            out = net(batch)
            loss, tb = compute_training_loss(model_cfg, out, class_names, voxel_size,
                                             point_cloud_range)
        sat = dcn_offset_sat(model)
        if sat is not None:
            tb["dcn_offset_sat"] = sat
        with span("backward"):  # the step's thread waits on autograd's
            (loss * scale if scale != 1 else loss).backward()
        with span("optimizer"):
            optimizer.step()
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}
        if parallel:
            metrics = _reduce_metrics(metrics, mesh, shares=sync_group is not None)
            if sync_group is None:
                all_reduce_mean_([b for n, b in model.named_buffers() if "running_" in n],
                                 mesh)
        return metrics

    step.state = state
    step.ddp = net if parallel else None
    return step


def _reduce_metrics(metrics, mesh: Mesh, shares: bool):
    """The metrics over the ranks, in one collective: summed where each rank
    holds a share (the loss terms of the synchronized leg, and the count of
    dropped active sites in both legs), else averaged (the loss terms of the
    local leg, and the DCN offset saturation, a mean over equal local
    batches)."""
    keys = list(metrics)
    flat = torch.stack([metrics[k].reshape(()).to(torch.float64) for k in keys])
    dist.all_reduce(flat, group=mesh.group)
    out = {}
    for i, k in enumerate(keys):
        summed = k == "as_overflow" or (shares and k != "dcn_offset_sat")
        v = flat[i] if summed else flat[i] / mesh.world_size
        out[k] = v.to(metrics[k].dtype)
    return out


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
