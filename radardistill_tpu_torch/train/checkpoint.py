"""Checkpointing + teacher->student init surgery.

Reference contract (tools/train_utils/train_utils.py:260-293 pickle .pth of
{epoch, it, model_state, optimizer_state, version}; rotation keeping
max_ckpt_save_num :209-214; auto-resume from newest loadable ckpt
tools/train.py:160-172; non-strict pretrained overlay
detector3d_template.py:442-465; teacher->student `radar_` key duplication
ckpt.py:17-22).

Counterpart of ``radardistill_tpu/train/checkpoint.py``: the file is
``torch.save`` of ``{model_state, optimizer_state, epoch, it, version}`` (the
reference's contract), under the JAX package's names
(``checkpoint_epoch_{e}``, ``checkpoint_epoch_latest``). The port's module
names are the flax scope names, so a ``state_dict`` key is the JAX tree path
joined by dots (``convert.py``), and the surgery and the overlay act on flat
``state_dict``s where the JAX package walks nested trees. A file is written
to a temporary name and renamed, so a save that dies leaves no torn file.
Under data parallelism only rank 0 writes (the reference's DDP rank-0
``torch.save``); the model in the ``TrainState`` is the unwrapped module, so
its keys carry no ``module.`` prefix and a checkpoint of N ranks loads into
one process and the reverse.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Dict, Optional

import torch

from ..parallel.multihost import process_index

VERSION = "radardistill_tpu_torch+0.1.0"

TEACHER_TO_RADAR = {
    "vfe": "radar_vfe",
    "backbone_3d": "radar_backbone_3d",
    "dense_head": "radar_dense_head",
    # backbone_2d (neck) weights seed the radar neck inside radar_backbone_2d;
    # the CMA hourglass has no teacher counterpart and keeps its fresh init.
    "backbone_2d": "radar_neck",
}


def duplicate_teacher_to_radar(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The `ckpt.py` surgery: copy every teacher entry under its radar twin
    where the twin exists with the same shape (the radar VFE's first linear
    differs in input dim, 6 raw radar features against 5 lidar ones, and
    keeps its own values)."""
    return {**state, **_teacher_twins(state, state)}


def _teacher_twins(src, dst) -> Dict[str, torch.Tensor]:
    """For each radar entry of ``dst``, the teacher twin in ``src`` of the
    same shape, where there is one."""
    out = {}
    for teacher, radar in TEACHER_TO_RADAR.items():
        for key, value in dst.items():
            if key.startswith(radar + "."):
                twin = _twin(src, teacher + key[len(radar):])
                if twin is not None and twin.shape == value.shape:
                    out[key] = twin
    return out


def _twin(state, name):
    """``state[name]``; for a conv ``weight`` (OIHW) that a teacher keeps as
    an HWIO ``kernel`` at stage 1 (``convert.py``), that kernel in OIHW."""
    if name in state:
        return state[name]
    kernel = state.get(name[:-len("weight")] + "kernel") if name.endswith(".weight") else None
    return kernel.permute(3, 2, 0, 1).contiguous() if kernel is not None else None


def _overlay(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]):
    """dst with every entry that src has under the same name and shape."""
    return {k: src[k] if k in src and src[k].shape == v.shape else v for k, v in dst.items()}


def _load_overlay(model: torch.nn.Module, src: Dict[str, torch.Tensor]) -> int:
    """Copy the matching entries of src into model's parameters and buffers
    in place (``requires_grad`` and devices kept); returns how many."""
    dst = model.state_dict()
    model.load_state_dict(_overlay(dst, src), strict=True)
    return sum(k in src and src[k].shape == v.shape for k, v in dst.items())


def init_radar_from_teacher(model: torch.nn.Module, src: Dict[str, torch.Tensor]) -> int:
    """``--init_from_teacher``: the surgery from the teacher entries of a
    checkpoint's ``model_state`` ``src`` onto ``model``'s radar parameters
    (not its BN statistics, as the JAX tool copies ``params`` only). The
    JAX tool reads the teacher off the model after its overlay, and so does
    this where the model has a teacher branch; a model without one
    (``pillarnet_radar.yaml``) takes the teacher from ``src``, where the JAX
    tool copies nothing into it. Returns the number of radar parameters
    copied from a teacher twin."""
    own = dict(model.named_parameters())
    twins = _teacher_twins({**src, **own}, {k: p for k, p in own.items()
                                            if k.startswith("radar_")})
    model.load_state_dict(twins, strict=False)
    return len(twins)


def _read(path: Path) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Rotating checkpoint manager (ckpt_%d + latest_model semantics)."""

    def __init__(self, ckpt_dir, max_ckpt_save_num: int = 30):
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_keep = max_ckpt_save_num

    def _path(self, tag) -> Path:
        return self.ckpt_dir / f"checkpoint_epoch_{tag}"

    def save(self, state, epoch: int, it: int | None = None, tag: str | None = None):
        """Write ``state`` (a ``TrainState``: model and optimizer) as the
        checkpoint of ``epoch`` (or of ``tag``); ``it`` defaults to the
        state's step count. Returns the path. Only rank 0 writes, and no
        rank waits for another here."""
        path = self._path(tag if tag is not None else epoch)
        if process_index() != 0:
            return path  # rank-0-only writes
        payload = {
            "model_state": state.model.state_dict(),
            "optimizer_state": state.optimizer.state_dict(),
            "epoch": int(epoch),
            "it": int(it if it is not None else state.step),
            "version": VERSION,
        }
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._rotate()
        return path

    def _rotate(self):
        ckpts = sorted(
            self.ckpt_dir.glob("checkpoint_epoch_[0-9]*"), key=lambda p: p.stat().st_mtime
        )
        while len(ckpts) > self.max_keep:
            ckpts.pop(0).unlink()

    def list_epochs(self):
        out = []
        for p in self.ckpt_dir.glob("checkpoint_epoch_*"):
            m = re.match(r"checkpoint_epoch_(\d+)$", p.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, state, epoch: int | None = None):
        """Load the newest (or the given epoch's) checkpoint into ``state``'s
        model and optimizer in place; returns (state, epoch, it) or None.
        Corrupt files are skipped newest-first (tools/train.py:160-172
        semantics). If the optimizer state does not fit ``state``'s
        optimizer (e.g. evaluating with a different optimizer), falls back to
        loading the model's parameters and BN statistics alone."""
        epochs = self.list_epochs() if epoch is None else [epoch]
        candidates = [self._path(e) for e in reversed(epochs)]
        if epoch is None:
            # the time-interval mid-epoch save resumes with highest priority
            # when it is the newest file (train_utils.py:143-151 latest_model)
            latest = self._path("latest")
            if latest.exists():
                newest = max(
                    (p.stat().st_mtime for p in candidates if p.exists()),
                    default=0.0,
                )
                if latest.stat().st_mtime >= newest:
                    candidates.insert(0, latest)
                else:
                    candidates.append(latest)
        log = logging.getLogger(__name__)
        for path in candidates:
            if not path.exists():
                continue
            try:
                payload = _read(path)
            except Exception as e:
                log.warning("restore of %s failed (%s: %s); skipping as corrupt",
                            path, type(e).__name__, e)
                continue
            try:
                state.model.load_state_dict(payload["model_state"], strict=True)
                state.optimizer.load_state_dict(payload["optimizer_state"])
            except Exception as e:
                log.warning("full restore of %s failed (%s: %s); loading the model's "
                            "parameters and statistics alone", path, type(e).__name__, e)
                _load_overlay(state.model, payload["model_state"])
            return state, int(payload["epoch"]), int(payload["it"])
        return None

    def load_params_from_file(self, state, path, pretrained_overlay: Optional[str] = None,
                              teacher_to_radar: bool = False):
        """Non-strict load: overlay the matching parameters and BN statistics
        (detector3d_template.py:442-465: `--pretrained_model` dict-updates
        over `--ckpt`). The optimizer and which parameters train are kept.
        ``state.loaded`` is the number of the model's entries the file at
        ``path`` supplied. ``teacher_to_radar`` (``--init_from_teacher``):
        then ``init_radar_from_teacher`` from the same read of the file, its
        count in ``state.duplicated``."""
        src = _read(Path(path))["model_state"]
        state.loaded = _load_overlay(state.model, src)
        if teacher_to_radar:
            state.duplicated = init_radar_from_teacher(state.model, src)
        if pretrained_overlay:
            _load_overlay(state.model, _read(Path(pretrained_overlay))["model_state"])
        return state
