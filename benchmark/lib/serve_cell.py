"""The driver of ``kind: serve`` traffic: the program's eval entry, closed
loop with one client, over a ring of host frames.

Each call hands one host batch (``batch_size`` frames as the collate gives
them) to the program: the copy to the card (``batch_to_torch``), the eval
forward with decode and NMS (``train/train_step.py::make_eval_step``), and
the boxes, scores, labels and valid flags read back to host memory. A frame's
latency is its call's, from the hand-off of its host arrays to its boxes on
the host. Set-up warms the entry on three calls of the ring. The calls whose
answers are compared also keep the neck's and the head's inputs and outputs
(forward hooks, on those calls alone), so that each layer is judged on its
own input after the window.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import numpy as np
import torch
from torch.profiler import record_function

from . import common, compare, trace
from .traffic import host_batches
from .train_cell import work_per_unit
from .weights import load_weights, make_weights

WARM_CALLS = 3
BOX_KEYS = ("boxes", "scores", "labels", "valid")
# the layers judged each on its own input: the neck (the CMA's second output
# and the backbone's x_conv5 in, the student's BEV features out) and the
# merged head (those features in, its maps out)
LAYERS = ("radar_neck", "radar_dense_head")


@contextlib.contextmanager
def layer_io(model, into: Dict[str, Any]):
    """Keep the inputs and the output of each of ``LAYERS`` of ``model``'s
    calls inside the block in ``into`` (forward hooks, removed after)."""
    def keep(name):
        def hook(_module, args, output):
            into[name] = (tuple(a.detach() for a in args), _detached(output))
        return hook

    hooks = [getattr(model, name).register_forward_hook(keep(name)) for name in LAYERS]
    try:
        yield into
    finally:
        for h in hooks:
            h.remove()


def _detached(output):
    if isinstance(output, dict):
        return {k: v.detach() for k, v in output.items()}
    if isinstance(output, (tuple, list)):
        return tuple(v.detach() for v in output)
    return output.detach()


def _as_dict(output) -> Dict[str, torch.Tensor]:
    """A layer's output as named tensors: the head's maps by name, the
    neck's outputs by position."""
    if isinstance(output, dict):
        return dict(output)
    if isinstance(output, tuple):
        return {str(i): v for i, v in enumerate(output)}
    return {"0": output}


def _frames(traffic, config, seed):
    batches = host_batches(traffic, config, seed)
    for b in batches:
        b.pop("gt_boxes", None)  # a served frame carries no labels
    return batches


def _preds(outputs, dev=None):
    """The head's maps among a call's compared outputs, as decode takes them."""
    return {k.split(".", 1)[1]: v.to(dev) if dev is not None else v
            for k, v in outputs.items() if k.startswith("radar_preds.")}


def sample_slots(limits, seed, batches) -> list:
    """The ring slots whose first answer in the window is compared: drawn
    from the seed, with the slot of the most radar returns among them."""
    n = len(batches)
    k = min(int(limits["compared_calls"]), n)
    rng = np.random.RandomState(np.random.SeedSequence([seed, 3]).generate_state(1))
    longest = int(np.argmax([b["radar_points_mask"].sum() for b in batches]))
    rest = [i for i in rng.permutation(n) if i != longest][:k - 1]
    return sorted([longest] + [int(i) for i in rest])


def _reference_forward(cell, seed, dev, batches, slots, precision=None, count=False,
                       prog_io=None):
    """The reference, in float32 without TF32 (``precision``: the control's
    mode), over each slot's call: its compared outputs and the inputs and
    outputs of ``LAYERS``; with ``prog_io`` (a slot's layer inputs and
    outputs as the program made them) each layer again on the program's own
    inputs; the reference's decode and NMS as a function of maps; with
    ``count``, the work of one call."""
    from ..reference.rdt.config import ConfigDict
    from ..reference.rdt.models import build_network
    from ..reference.rdt.models.center_head import decode_and_nms
    from ..reference.rdt.models.detector import batch_to_torch
    from ..reference.rdt.utils.profiler import cost_analysis

    cfg, info = common.model_cfg(cell.config, ConfigDict), common.dataset_info(cell.config)
    maps, io, on_prog, work = {}, {}, {}, None
    with common.full_float32(), torch.no_grad():
        model = build_network(cfg, info, compute_dtype=torch.float32, device=dev)
        load_weights(model, make_weights(model, seed, dev))
        model.eval()
        for s in slots:
            fwd = (lambda b: model(batch_to_torch(b, dev)))
            io[s] = {}
            with layer_io(model, io[s]):
                if precision is not None:
                    with precision():
                        out = fwd(batches[s])
                elif count and work is None:
                    work = cost_analysis(fwd, batches[s])
                    out = work.pop("out")
                else:
                    out = fwd(batches[s])
            maps[s] = compare.outputs(out)
            del out
            if prog_io is not None and s in prog_io:
                on_prog[s] = {name: getattr(model, name)(*(a.float() for a in prog_io[s][name][0]))
                              for name in LAYERS if name in prog_io[s]}
        spec = model.radar_head_spec
        head = cfg["RADAR_DENSE_HEAD"]
        del model
    common.free(dev)
    pp, ta = head["POST_PROCESSING"], head["TARGET_ASSIGNER_CONFIG"]
    heads = head["SEPARATE_HEAD_CFG"]["HEAD_DICT"]

    def decode(preds):
        hw = tuple(preds["hm"].shape[1:3])
        with common.full_float32(), torch.no_grad():
            return decode_and_nms(
                preds, spec, hw, ta["FEATURE_MAP_STRIDE"], info["voxel_size"],
                info["point_cloud_range"], pp["POST_CENTER_LIMIT_RANGE"],
                k_per_head=pp["MAX_OBJ_PER_SAMPLE"], score_thresh=pp["SCORE_THRESH"],
                rectifier=head.get("RECTIFIER", 0.0), nms_thresh=pp["NMS_CONFIG"]["NMS_THRESH"],
                nms_pre=pp["NMS_CONFIG"]["NMS_PRE_MAXSIZE"],
                nms_post=pp["NMS_CONFIG"]["NMS_POST_MAXSIZE"],
                with_iou="iou" in heads, with_vel="vel" in heads)

    return maps, io, on_prog, decode, work


SERVE_NUMBERS = ("cma_gap", "cma2_gap", "conv5_gap", "neck_gap", "maps_gap", "student_gap",
                 "head_gap", "boxes_gap")


def _layer_gaps(prog_io, ref_io, on_prog, detail) -> Dict[str, float]:
    """The neck's two inputs as the program made them against the
    reference's own, end to end: ``cma2_gap`` (the CMA's second output) and
    ``conv5_gap`` (the backbone's ``x_conv5``); ``neck_gap`` and
    ``maps_gap``: the program's neck and head against the reference's same
    layer run on the program's own input (the neck's outputs, the worst of
    them; the head's maps, the worst map). ``detail`` keeps each output's
    worst gap over the calls."""
    prog_in, ref_in = _inputs(prog_io), _inputs(ref_io)
    got = {}
    for number, prog, ref in (
            ("cma2_gap", _pick(prog_in, "0"), _pick(ref_in, "0")),
            ("conv5_gap", _pick(prog_in, "1"), _pick(ref_in, "1")),
            ("neck_gap", _output(prog_io, "radar_neck"), _as_dict(on_prog.get("radar_neck", ()))),
            ("maps_gap", _output(prog_io, "radar_dense_head"),
             _as_dict(on_prog.get("radar_dense_head", {})))):
        gaps = compare.each_gap(prog, ref) if ref else {}
        got[number] = max(gaps.values()) if gaps else compare.MISSING
        mine = detail.setdefault(number, {})
        for k, v in gaps.items():
            mine[k] = max(mine.get(k, 0.0), v)
    return got


def _pick(tensors: Dict[str, torch.Tensor], key: str) -> Dict[str, torch.Tensor]:
    return {key: tensors[key]} if key in tensors else {}


def _inputs(io) -> Dict[str, torch.Tensor]:
    args = io.get("radar_neck", ((),))[0]
    return {str(i): a for i, a in enumerate(args)}


def _output(io, name) -> Dict[str, torch.Tensor]:
    return _as_dict(io[name][1]) if name in io else {}


def run(cell, seed: int, seconds: float, traced: bool, dev, clock, control=None):
    """One run of a serving cell (see ``train_cell.run`` for what it returns)."""
    from radardistill_tpu_torch.config import ConfigDict
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.train_step import make_eval_step

    clock.mark("imports and CUDA initialisation")
    traffic = cell.traffic
    batches = _frames(traffic, cell.config, seed)
    slots = sample_slots(cell.limits, seed, batches)
    bs, n_ring = traffic["batch_size"], len(batches)
    clock.mark("traffic")
    out: Dict[str, Any] = {}
    kept: Dict[int, Any] = {}
    if control is None:
        cfg, info = common.model_cfg(cell.config, ConfigDict), common.dataset_info(cell.config)
        model = build_network(cfg, info, compute_dtype=common.activations(cell.config),
                              device=dev)
        load_weights(model, make_weights(model, seed, dev))
        eval_step = make_eval_step(model)
        clock.mark("model and weights")

        def call(i):
            o = eval_step(batch_to_torch(batches[i % n_ring], dev))
            boxes = {k: o["final_box_dicts"][k].cpu() for k in BOX_KEYS}
            return o, boxes

        for i in range(WARM_CALLS):
            call(i)
        common.sync(dev)
        clock.mark("warm-up")
        out["setup_s"] = clock.now()

        lat, n = [], 0
        host = common.HostReading()
        t_start = time.perf_counter()
        while True:
            slot = n % n_ring
            io = {} if slot in slots and slot not in kept else None
            t0 = time.perf_counter()
            with layer_io(model, io) if io is not None else contextlib.nullcontext():
                o, boxes = call(n)
            lat.append(time.perf_counter() - t0)
            host.call_done()
            if io is not None:
                kept[slot] = (compare.outputs(o), boxes, io)
            del o
            n += 1
            if time.perf_counter() - t_start >= seconds:
                break
        window = time.perf_counter() - t_start
        frames_lat = [t for t in lat for _ in range(bs)]
        out.update(attempted=n * bs, failed=0,
                   end_to_end={"frames_per_s": n * bs / window,
                               "frame_latency_p95_ms": common.p95(frames_lat) * 1e3},
                   sec_per_unit=window / (n * bs), host=host.summary(bs))
        if traced:
            from torch.profiler import ProfilerActivity, profile

            k = int(traffic["trace_calls"])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(k):
                    with record_function(trace.CALL_SPAN):
                        call(n + i)
                traced_us = (time.perf_counter() - t0) * 1e6
            out["trace"] = (prof, k, k * bs, traced_us)
        out["peak"] = common.peak_bytes(dev)
        del model, eval_step
        common.free(dev)
    else:
        out.update(attempted=0, failed=0, end_to_end={}, setup_s=clock.now(),
                   peak=common.peak_bytes(dev))
        maps, io, _, decode, _ = _reference_forward(cell, seed, dev, batches, slots,
                                                    precision=control)
        kept = {s: (m, {k: v.cpu() for k, v in decode(_preds(m)).items()}, io[s])
                for s, m in maps.items()}

    ref_maps, ref_io, on_prog, decode, work = _reference_forward(
        cell, seed, dev, batches, slots, count=traced and control is None,
        prog_io={s: k[2] for s, k in kept.items()})
    numbers: Dict[str, float] = {}
    layer_detail: Dict[str, Dict[str, float]] = {}
    for s in slots:
        if s in kept:
            prog_out, prog_boxes, prog_io = kept[s]
            got = dict(compare.group_gaps(prog_out, ref_maps[s]),
                       boxes_gap=compare.boxes_gap(prog_boxes, decode(_preds(prog_out, dev))))
            got.update(_layer_gaps(prog_io, ref_io[s], on_prog[s], layer_detail))
        else:  # an answer that never came
            got = {k: compare.MISSING for k in SERVE_NUMBERS}
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    out["numbers"] = numbers
    out["detail"] = {"compared_slots": slots, "layers": layer_detail,
                     "boxes_served": [int(kept[s][1]["valid"].sum()) for s in slots if s in kept]}
    if work is not None:
        out["work"] = work_per_unit(work, bs)
    return out
