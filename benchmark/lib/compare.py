"""The numbers that may decide ``correct``: each run reads them all, and
those that the cell's ``workloads/<cell>.json`` gives a limit are held to it
(``PERF.md`` says why the others have none).

Training (per the first three steps of the run, program against reference):

- ``loss_gap``: over the three steps, the largest gap of the loss or of any
  of its terms, over the reference's loss of that step;
- ``teacher_gap``, ``cma_gap``, ``student_gap``, ``head_gap``: the first
  forward's outputs (the teacher's BEV features, the CMA's output, the
  student's BEV features, the worst of the head's maps): the L2 norm of
  the program's output minus the reference's, over the reference's;
- ``change_gap``: the worst leaf's gap between the norms of its change over
  the three steps, over the larger of the reference's norm of that leaf and
  the median leaf's.

``grad_gap`` is the same of the first gradient as the optimizer got it
(after the clip); the ``_median`` numbers take the median leaf. Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the leaf numbers: they move
under Adam by round-off alone.

Serving (the worst over the compared calls; ``lib/serve_cell.py``):

- ``cma_gap``, ``student_gap``, ``head_gap``: as in training, of each call,
  end to end from the same frame;
- ``cma2_gap``, ``conv5_gap``: the neck's inputs (the CMA's second
  output, the backbone's ``x_conv5``) against the reference's, end to end;
- ``neck_gap``, ``maps_gap``: each layer on its own input: the program's
  neck (its outputs, the worst) and merged head (its maps, the worst map)
  against the reference's same layer run on the program's own input of
  that call, so that a layer's fault shows apart from the error it
  inherits;
- ``boxes_gap``: the program's boxes, scores and labels against the
  reference's decode and NMS of the program's own maps (decode is not
  continuous, so it is judged on the maps the program served): 0 when the
  two sets are equal, else the largest absolute gap of a box value or
  score, or 1 where a box or label has no counterpart.
"""

from __future__ import annotations

from typing import Dict, List

import torch


# what a number reads where an answer never came or has another shape
MISSING = 1e6


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: List[str],
             median: bool = False) -> float:
    """max (or the median) over ``keep`` of |prog - ref| / max(ref, median
    of ref over keep)."""
    if not keep:
        return MISSING
    med = float(torch.tensor([ref[k] for k in keep]).median())
    gaps = torch.tensor([abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep])
    return float(gaps.median() if median else gaps.max())


def moved_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(torch.tensor(list(ref_grad.values())).median())
    return [k for k, v in ref_grad.items() if v >= 1e-3 * med]


def loss_gap(prog_steps: List[Dict[str, float]], ref_steps: List[Dict[str, float]]) -> float:
    gap = 0.0
    for p, r in zip(prog_steps, ref_steps, strict=True):
        base = abs(r["loss"])
        for k, v in r.items():
            gap = max(gap, abs(p[k] - v) / base)
    return gap


def each_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """For each output of ``ref``: the L2 norm of the program's minus the
    reference's, over the reference's (MISSING where the program's is
    absent or of another shape)."""
    gaps = {}
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or p.shape != r.shape:
            gaps[k] = MISSING
            continue
        r = r.float()
        gaps[k] = float((p.float().to(r.device) - r).norm() / r.norm().clamp_min(1e-30))
    return gaps


# the forward's outputs compared, by the layer that makes them (a name
# ending in "." takes every output under it)
GROUPS = {"teacher_gap": "spatial_features_2d", "cma_gap": "radar_spatial_features_8x_1",
          "student_gap": "radar_spatial_features_2d", "head_gap": "radar_preds."}


def _of(key: str, group: str) -> bool:
    return key.startswith(group) if group.endswith(".") else key == group


def outputs(out) -> Dict[str, torch.Tensor]:
    """The compared outputs of one forward's output dict, detached, with
    the head's maps as ``radar_preds.<map>``."""
    got = {k: out[k] for k in GROUPS.values() if k in out}
    got.update({f"radar_preds.{k}": v for k, v in out.get("radar_preds", {}).items()})
    return {k: v.detach() for k, v in got.items()}


def group_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The worst :func:`each_gap` of each group of outputs that ``ref`` has."""
    gaps = each_gap(prog, ref)
    out = {}
    for name, group in GROUPS.items():
        mine = [v for k, v in gaps.items() if _of(k, group)]
        if mine:
            out[name] = max(mine)
    return out


def boxes_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """Both are one call's ``final_box_dicts`` (boxes (B, N, 9), scores,
    labels, valid)."""
    pv, rv = prog["valid"].cpu().bool(), ref["valid"].cpu().bool()
    if pv.shape != rv.shape or not torch.equal(pv, rv) or not torch.equal(
            prog["labels"].cpu()[pv], ref["labels"].cpu()[rv]):
        return 1.0
    if not bool(pv.any()):
        return 0.0
    db = (prog["boxes"].cpu().float()[pv] - ref["boxes"].cpu().float()[rv]).abs().max()
    ds = (prog["scores"].cpu().float()[pv] - ref["scores"].cpu().float()[rv]).abs().max()
    return float(max(db, ds))
