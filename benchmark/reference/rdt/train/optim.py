"""Optimizers and the one-cycle learning-rate / momentum schedule.

Counterpart of ``radardistill_tpu/train/optim.py``: ``adam_onecycle`` (the
RadarDistill recipe: AdamW with betas (b1(t), 0.99), decoupled weight decay on
every trained parameter, cosine one-cycle of the learning rate ``lr/div ->
lr_max`` over ``pct_start`` then ``lr_max -> lr/div/1e4``, and of b1
``moms[0] -> moms[1]`` and back; stepped per iteration), and ``adam`` and
``sgd`` at a constant learning rate (``build_optimizer``).

The reference expresses FREEZE_PIPELINE as an optax mask that cancels the
decoupled weight decay on frozen scopes (their gradients are zero already).
Here the optimizer is simply given the trainable parameters only
(``freeze_mask``): no moments, no decay and no update for the frozen teacher
or for the DCN's ``down_bias``.

``ClippedOptimizer.step`` is the optax chain ``clip_by_global_norm -> adamw``
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


class ClippedOptimizer:
    """``clip_by_global_norm(clip) -> rule`` over the trainable parameters,
    ``inner`` the torch optimizer of the rule, ``kind`` its name in the
    saved state (``"adamw"`` or ``"sgd"``). Before each update the learning
    rate (and, with ``mom_sched``, Adam's b1) of its one parameter group are
    rewritten from the schedules at ``count``, the number of updates made;
    ``grad_norm`` is the gradients' global norm before the clip in the last
    one (a tensor on the parameters' device; None before the first)."""

    def __init__(self, params, inner: torch.optim.Optimizer, kind: str, lr_sched,
                 mom_sched=None, clip=None):
        self.params = list(params)
        self.inner, self.kind = inner, kind
        self.lr_sched, self.mom_sched, self.clip = lr_sched, mom_sched, clip
        self.count = 0
        self.grad_norm = None

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

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
        group = self.inner.param_groups[0]
        group["lr"] = self.lr_sched(self.count)
        if self.mom_sched is not None:
            group["betas"] = (self.mom_sched(self.count), group["betas"][1])
        self.inner.step()
        self.count += 1
        self.grad_norm = norm
        return norm

    def state_dict(self) -> dict:
        """The update count (it sets the next update's schedules) and the
        rule's state (AdamW's moments, or SGD's momentum buffers) under
        ``kind``."""
        return {"count": self.count, self.kind: self.inner.state_dict()}

    def load_state_dict(self, state: dict):
        """Raises ValueError where ``state`` was saved by another rule or over
        other parameters (another number of them, or another shape of any
        moment or buffer)."""
        if self.kind not in state:
            raise ValueError(f"optimizer state of another rule ({sorted(state)}), not "
                             f"{self.kind}")
        inner = state[self.kind]
        if len(inner["param_groups"]) != 1 or len(inner["param_groups"][0]["params"]) != len(
                self.params):
            raise ValueError("optimizer state of other parameters")
        for i, p in enumerate(self.params):
            moments = inner["state"].get(i, {})
            if any(torch.is_tensor(v) and k != "step" and v.shape != p.shape
                   for k, v in moments.items()):
                raise ValueError(f"optimizer state of parameter {i}: other shape")
        self.inner.load_state_dict(inner)
        self.count = int(state["count"])


def build_optimizer(optim_cfg, model: nn.Module, total_steps: int, frozen_scopes=()):
    """The optimizer of the OPTIMIZATION config over ``model``'s trainable
    parameters (it marks the others ``requires_grad = False``), and its
    learning-rate schedule. Returns (optimizer, lr_sched). The optimizer's
    state lives where the parameters live: the card, unless the model was
    built with ``device="cpu"``. The rules, each after the global-norm clip
    (``GRAD_NORM_CLIP``):

      adam_onecycle: AdamW at the one-cycle lr and b1 (``BETAS``' b2);
      adam: AdamW at the constant ``LR``, optax's b1 0.9, b2 0.999, eps
        1e-8, decoupled ``WEIGHT_DECAY``;
      sgd: ``WEIGHT_DECAY · p`` added to the gradient, then heavy-ball
        ``MOMENTUM`` without dampening, at the constant ``LR`` (optax's
        ``add_decayed_weights -> sgd``)."""
    name = optim_cfg["OPTIMIZER"]
    if name not in ("adam_onecycle", "adam", "sgd"):
        raise ValueError(f"unknown OPTIMIZER {name!r}: adam_onecycle, adam or sgd")
    mask = freeze_mask(model.named_parameters(), frozen_scopes)
    for pname, p in model.named_parameters():
        p.requires_grad_(mask[pname])
    params = [p for n, p in model.named_parameters() if mask[n]]
    wd = optim_cfg.get("WEIGHT_DECAY", 0.0)
    clip = optim_cfg.get("GRAD_NORM_CLIP", None)
    if name == "adam_onecycle":
        lr_sched = one_cycle_lr(total_steps, optim_cfg["LR"], optim_cfg["DIV_FACTOR"],
                                optim_cfg["PCT_START"])
        mom_sched = one_cycle_mom(total_steps, list(optim_cfg["MOMS"]), optim_cfg["PCT_START"])
        betas = tuple(optim_cfg.get("BETAS", (0.9, 0.99)))
        inner = torch.optim.AdamW(params, lr=lr_sched(0), betas=(mom_sched(0), betas[1]),
                                  eps=1e-8, weight_decay=wd)
        return ClippedOptimizer(params, inner, "adamw", lr_sched, mom_sched, clip), lr_sched
    lr = float(optim_cfg["LR"])
    lr_sched = lambda step: lr  # noqa: E731
    if name == "adam":
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled decay
        inner = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
        return ClippedOptimizer(params, inner, "adamw", lr_sched, clip=clip), lr_sched
    # decay added to the gradient, then heavy-ball momentum without dampening
    inner = torch.optim.SGD(params, lr=lr, momentum=float(optim_cfg["MOMENTUM"]),
                            weight_decay=wd)
    return ClippedOptimizer(params, inner, "sgd", lr_sched, clip=clip), lr_sched
