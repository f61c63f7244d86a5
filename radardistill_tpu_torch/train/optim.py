"""Optimizer and the one-cycle learning-rate / momentum schedule.

Counterpart of ``radardistill_tpu/train/optim.py`` for ``adam_onecycle`` (the
RadarDistill recipe: AdamW with betas (b1(t), 0.99), decoupled weight decay on
every trained parameter, cosine one-cycle of the learning rate ``lr/div ->
lr_max`` over ``pct_start`` then ``lr_max -> lr/div/1e4``, and of b1
``moms[0] -> moms[1]`` and back; stepped per iteration).

The reference expresses FREEZE_PIPELINE as an optax mask that cancels the
decoupled weight decay on frozen scopes (their gradients are zero already).
Here the optimizer is simply given the trainable parameters only
(``freeze_mask``): no moments, no decay and no update for the frozen teacher
or for the DCN's ``down_bias``.

``OneCycleAdamW.step`` is the optax chain ``clip_by_global_norm -> adamw``
with the schedules read at the update count *before* the increment (the first
update uses ``sched(0)``): ``p <- p - lr·(m̂/(sqrt(v̂) + eps) + wd·p)`` with
the bias correction ``1 - b1ᵗ`` taken with the step's own b1, which is what
``torch.optim.AdamW`` computes once ``lr`` and ``betas`` of its parameter
group are rewritten before each step. The clip is optax's: the gradients are
scaled by ``max_norm / norm`` only when ``norm >= max_norm`` (no 1e-6 in the
denominator, unlike ``clip_grad_norm_``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import torch
from torch import nn

FROZEN_LEAVES = ("down_bias",)  # the DCN's bias: never trained in the reference


def annealing_cos(start: float, end: float, pct: float) -> float:
    return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)


def _one_cycle(total_steps: int, pct_start: float, up: Tuple[float, float],
               down: Tuple[float, float]):
    a1 = int(total_steps * pct_start)

    def sched(step) -> float:
        step = float(step)
        if step < a1:
            return annealing_cos(*up, min(max(step / max(a1, 1), 0.0), 1.0))
        return annealing_cos(*down, min(max((step - a1) / max(total_steps - a1, 1), 0.0), 1.0))

    return sched


def one_cycle_lr(total_steps: int, lr_max: float, div_factor: float, pct_start: float):
    """step -> learning rate."""
    low_lr = lr_max / div_factor
    return _one_cycle(total_steps, pct_start, (low_lr, lr_max), (lr_max, low_lr / 1e4))


def one_cycle_mom(total_steps: int, moms: Sequence[float], pct_start: float):
    """step -> Adam's b1."""
    return _one_cycle(total_steps, pct_start, (moms[0], moms[1]), (moms[1], moms[0]))


def freeze_mask(params: Iterable[Tuple[str, nn.Parameter]], frozen_scopes=()) -> Dict[str, bool]:
    """name -> trainable, over ``model.named_parameters()``: False for every
    parameter of a frozen top-level scope and for FROZEN_LEAVES anywhere."""
    frozen_scopes = set(frozen_scopes)
    return {name: not (name.split(".", 1)[0] in frozen_scopes
                       or name.rsplit(".", 1)[-1] in FROZEN_LEAVES)
            for name, _ in params}


class OneCycleAdamW:
    """``clip_by_global_norm(clip) -> AdamW(lr(t), b1(t), b2, wd)`` over the
    trainable parameters. ``count`` is the number of updates made."""

    def __init__(self, params, lr_sched, mom_sched, b2: float, weight_decay: float,
                 clip=None, eps: float = 1e-8):
        self.params = list(params)
        self.lr_sched, self.mom_sched, self.clip = lr_sched, mom_sched, clip
        self.count = 0
        self.adamw = torch.optim.AdamW(self.params, lr=lr_sched(0), betas=(mom_sched(0), b2),
                                       eps=eps, weight_decay=weight_decay)

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad`` (a parameter the loss did
        not reach counts as a zero gradient and still decays, as in the
        reference); returns the gradients' global norm before the clip."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)).float())
        if self.clip:
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            torch._foreach_mul_(grads, scale)
        group = self.adamw.param_groups[0]
        group["lr"] = self.lr_sched(self.count)
        group["betas"] = (self.mom_sched(self.count), group["betas"][1])
        self.adamw.step()
        self.count += 1
        return norm


def build_optimizer(optim_cfg, model: nn.Module, total_steps: int, frozen_scopes=()):
    """The optimizer of the OPTIMIZATION config over ``model``'s trainable
    parameters (it marks the others ``requires_grad = False``), and its
    learning-rate schedule. Returns (optimizer, lr_sched). The optimizer's
    state lives where the parameters live: the card, unless the model was
    built with ``device="cpu"``."""
    name = optim_cfg["OPTIMIZER"]
    if name in ("adam", "sgd"):
        raise NotImplementedError(f"OPTIMIZER: {name} is not ported (adam_onecycle is)")
    if name != "adam_onecycle":
        raise NotImplementedError(name)
    mask = freeze_mask(model.named_parameters(), frozen_scopes)
    for pname, p in model.named_parameters():
        p.requires_grad_(mask[pname])
    lr_sched = one_cycle_lr(total_steps, optim_cfg["LR"], optim_cfg["DIV_FACTOR"],
                            optim_cfg["PCT_START"])
    mom_sched = one_cycle_mom(total_steps, list(optim_cfg["MOMS"]), optim_cfg["PCT_START"])
    betas = tuple(optim_cfg.get("BETAS", (0.9, 0.99)))
    opt = OneCycleAdamW([p for n, p in model.named_parameters() if mask[n]], lr_sched, mom_sched,
                        b2=betas[1], weight_decay=optim_cfg.get("WEIGHT_DECAY", 0.0),
                        clip=optim_cfg.get("GRAD_NORM_CLIP", None))
    return opt, lr_sched
