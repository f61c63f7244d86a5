"""Activation rematerialization (``MODEL.REMAT``): a module's forward under
``torch.utils.checkpoint`` (non-reentrant), run once in the forward and again
in the backward to rebuild what its backward needs.

The counterpart of flax's ``nn.remat``, which never commits a module's state
twice. A train-mode BatchNorm's forward does two things with effects beyond
its output: it moves the running statistics, and under synchronized data
parallelism it all-reduces the batch's sums. So while :func:`checkpointed`
recomputes, ``replaying()`` is true, ``layers.update_running_`` leaves the
running statistics as they are, and ``parallel.mesh.batch_sum`` hands back,
in order, the sums it reduced in the forward instead of reducing again. The
running statistics after a remat step are then bit-equal to those of a step
without it, and a data-parallel step makes the collectives of one without.
"""

from __future__ import annotations

import threading

import torch
from torch.utils.checkpoint import checkpoint

_ctx = threading.local()


def remat_call(on: bool, fn, *args):
    """``fn(*args)``; where ``on`` and gradients are taken, under
    :func:`checkpointed`."""
    if on and torch.is_grad_enabled():
        return checkpointed(fn, *args)
    return fn(*args)


def checkpointed(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``: its
    activations are not kept, and its backward recomputes them."""
    sums = []
    calls = [0]

    def run(*a):
        prev = getattr(_ctx, "state", None)
        _ctx.state = ("record", sums) if calls[0] == 0 else ("replay", iter(sums))
        calls[0] += 1
        try:
            return fn(*a)
        finally:
            _ctx.state = prev

    return checkpoint(run, *args, use_reentrant=False)


def replaying() -> bool:
    """True while a checkpointed forward is being recomputed."""
    state = getattr(_ctx, "state", None)
    return state is not None and state[0] == "replay"


def reduced(reduce, x: torch.Tensor) -> torch.Tensor:
    """``reduce(x)``, except while a checkpointed forward is recomputed: then
    the value this call reduced in the forward. Inside a checkpointed forward
    the result is kept for that."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return reduce(x)
    mode, store = state
    if mode == "replay":
        # the kept value, tied to x's graph as the forward's result was, so
        # that the recompute saves the same tensors for the backward
        kept = next(store)
        return kept + (x - x.detach()) if x.requires_grad else kept
    out = reduce(x)
    store.append(out.detach())
    return out
