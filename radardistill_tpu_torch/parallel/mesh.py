"""The data-parallel mesh: one process a device, the batch split over them.

Counterpart of ``radardistill_tpu/parallel/mesh.py`` (``make_mesh``,
``shard_batch``). Reference mechanism: DDP over NCCL (tools/train.py:176,
pcdet/utils/common_utils.py:169-211), each rank reading its slice of the
indices, the gradients all-reduced in the backward, and optionally SyncBN
(tools/train.py:144-145).

The JAX package runs the step once over a mesh of devices, and XLA reduces
the batch statistics and the loss over the global batch. The port runs one
process a device (``torchrun``): ``Mesh`` holds the process group, the rank,
the world size and the device; ``wrap_ddp`` puts the trainable model under
``DistributedDataParallel``; and ``batch_sum`` is the all-reduce through
which the BNs (``models/layers.py``, the merged head's statistics in
``models/center_head.py``) and the losses' batch normalizers
(``center_head.py``, ``distill.py``) see the global batch while a
``sync_batch`` scope is open. Outside one it is the identity, so one process
computes what it always did.

Backends: NCCL between cards, gloo on the CPU, and gloo for two ranks on one
card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..utils.remat import reduced


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel job. ``group`` is None for
    one process without ``torch.distributed``."""

    group: Optional[Any]
    rank: int
    world_size: int
    device: torch.device


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of every process of ``group`` (the default group when
    ``torch.distributed`` is initialized, else this process alone), one
    ``device`` each: the card this process uses unless the caller names
    another."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(None, 0, 1, torch.device(device))
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), torch.device(device))


def shard_batch(batch, mesh: Mesh):
    """This rank's share of a global batch: rows ``rank::world_size`` of
    every array (numpy or torch) and list, which is what the loader's
    ``idx[rank::world]`` slice gives each rank when the global batch is
    ``world_size`` times the local one. Dicts and tuples (the host tables'
    structure) are walked; everything else is kept."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor, list)) and len(batch):
        return batch[mesh.rank::mesh.world_size]
    return batch


def wrap_ddp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """``model`` under ``DistributedDataParallel`` over ``mesh``: the
    gradients of its trainable parameters are averaged in the backward. The
    buffers (BN running statistics) are not broadcast from rank 0 at each
    forward (``broadcast_buffers=False``): the train step keeps them equal
    itself, by the global statistics or by averaging them. The inputs stay
    where they are (``device_ids=None``). Checkpoints take ``model``, never
    the wrapper."""
    from torch.nn.parallel import DistributedDataParallel

    with warnings.catch_warnings():
        # newer releases deprecate the flag for one that still syncs at init
        warnings.filterwarnings("ignore", message=".*broadcast_buffers.*", category=FutureWarning)
        return DistributedDataParallel(model, device_ids=None, process_group=mesh.group,
                                       broadcast_buffers=False)


# --------------------------------------------------- the batch all-reduce

_SYNC_GROUP = None


@contextlib.contextmanager
def sync_batch(group):
    """While open, ``batch_sum`` sums over the processes of ``group`` (None:
    the identity)."""
    global _SYNC_GROUP
    prev, _SYNC_GROUP = _SYNC_GROUP, group
    try:
        yield
    finally:
        _SYNC_GROUP = prev


def sync_group():
    """The process group of the open ``sync_batch`` scope, or None."""
    return _SYNC_GROUP


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks, on every rank; the gradient of each rank's input is
    the Σ over the ranks of the output's gradients (each rank holds one
    share of the global loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes of the open ``sync_batch`` scope,
    differentiably; ``x`` itself outside one. One collective a call: callers
    concatenate what they reduce. While a checkpointed forward is
    recomputed (``utils.remat``) it returns the sum it took in the forward,
    without a collective."""
    if _SYNC_GROUP is None:
        return x
    group = _SYNC_GROUP
    return reduced(lambda t: _AllReduceSum.apply(t, group), x)


@torch.no_grad()
def all_reduce_mean_(tensors, mesh: Mesh):
    """Average same-dtype ``tensors`` over the ranks of ``mesh`` in place,
    in one collective."""
    tensors = list(tensors)
    if mesh.group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
