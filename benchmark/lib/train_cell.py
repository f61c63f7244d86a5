"""The driver of ``kind: train`` traffic: the program's distillation train
step, closed loop, over a ring of batches staged on the card.

Set-up builds one train step (``train/train_step.py::make_train_step``: the
model in the configuration's precision, its weights from the seed, the
configuration's optimizer) and drives it through its first three steps on
ring batches 0, 1, 2: those steps are the warm-up and what the reference
follows. The same step object then runs the window, from ring batch 3 on.
A step's metrics stay on the card; the window ends when the host clock has
passed ``--seconds`` and the card has finished every step launched.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import torch
from torch.profiler import record_function

from . import common, compare, trace
from .traffic import host_batches
from .weights import load_weights, make_weights

FIRST_STEPS = 3


def _trainable(model) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()
            if k not in ("dcn_offset_sat", "as_overflow")}


def _capture(out: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The compared outputs of a forward (the teacher's BEV features, from
    its int8 chain, K5 and K1; the CMA's output, K2; the student's BEV
    features; the head's maps), on the host."""
    return {k: v.float().cpu() for k, v in compare.outputs(out).items()}


def _first_steps(step_fn, model, batches: List[Any], dev, first=None):
    """Run the first three steps (the first through ``first(step_fn,
    batch)`` where given); return (per-step loss terms, per-leaf norm of the
    first gradient, per-leaf norm of the change after the three, the first
    forward's compared outputs)."""
    before = {n: p.detach().clone() for n, p in _trainable(model).items()}
    losses, grad, feats = [], None, {}
    hook = model.register_forward_hook(lambda _m, _a, out: feats.update(_capture(out)))
    for i in range(FIRST_STEPS):
        losses.append(first(step_fn, batches[i]) if i == 0 and first else step_fn(batches[i]))
        if i == 0:
            hook.remove()
            grad = {n: p.grad.float().norm() for n, p in _trainable(model).items()
                    if p.grad is not None}
    change = {n: (p.detach() - before[n]).float().norm() for n, p in _trainable(model).items()}
    common.sync(dev)
    return ([_floats(m) for m in losses], {n: float(v) for n, v in grad.items()},
            {n: float(v) for n, v in change.items()}, feats)


def _reference_steps(cell, seed, dev, batches, precision=None, count=False):
    """The reference's first three steps on the same host batches and
    weights, in float32 without TF32 (``precision``: a mode to compute
    them in, the control's); with ``count``, also the work of its first
    step, counted by the frozen rules."""
    from ..reference.rdt.config import ConfigDict
    from ..reference.rdt.models import build_network, compute_training_loss
    from ..reference.rdt.models.detector import batch_to_torch
    from ..reference.rdt.train.optim import build_optimizer
    from ..reference.rdt.utils.profiler import cost_analysis

    cfg, info = common.model_cfg(cell.config, ConfigDict), common.dataset_info(cell.config)
    with common.full_float32():
        model = build_network(cfg, info, compute_dtype=torch.float32, device=dev)
        load_weights(model, make_weights(model, seed, dev))
        opt, _ = build_optimizer(ConfigDict(cell.config["OPTIMIZATION"]), model,
                                 cell.config["assumed"]["total_steps"], model.frozen)
        geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])

        def step(batch):
            model.train()
            opt.zero_grad()
            out = model(batch_to_torch(batch, dev))
            loss, tb = compute_training_loss(cfg, out, *geo)
            loss.backward()
            opt.step()
            return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}

        work = {}

        def counted_step(fn, batch):
            work.update(cost_analysis(fn, batch))
            return work.pop("out")

        with precision() if precision is not None else contextlib.nullcontext():
            result = _first_steps(step, model, batches, dev, counted_step if count else None)
    del model, opt
    common.free(dev)
    return result, work or None


def run(cell, seed: int, seconds: float, traced: bool, dev, clock, control=None):
    """One run of a training cell (``control``: a precision mode, the
    reference in it takes the program's place). Returns ``attempted``,
    ``failed``, ``end_to_end``, ``setup_s``, ``sec_per_unit``, ``peak``,
    ``numbers`` and ``detail`` (what ``lib/compare.py`` read), and with
    ``traced`` the profiler's run (``trace``) and the counted work (``work``)."""
    from radardistill_tpu_torch.config import ConfigDict
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step

    clock.mark("imports and CUDA initialisation")
    traffic = cell.traffic
    batches = host_batches(traffic, cell.config, seed)
    clock.mark("traffic")
    out: Dict[str, Any] = {}
    if control is None:
        cfg, info = common.model_cfg(cell.config, ConfigDict), common.dataset_info(cell.config)
        model = build_network(cfg, info, compute_dtype=common.activations(cell.config),
                              device=dev)
        load_weights(model, make_weights(model, seed, dev))
        opt, _ = build_optimizer(ConfigDict(cell.config["OPTIMIZATION"]), model,
                                 cell.config["assumed"]["total_steps"], model.frozen)
        step = make_train_step(model, opt, cfg, info["class_names"], info["voxel_size"],
                               info["point_cloud_range"])
        clock.mark("model and weights")
        ring = [batch_to_torch(b, dev) for b in batches]
        common.sync(dev)
        clock.mark("traffic")
        prog = _first_steps(step, model, ring, dev)
        clock.mark("warm-up")
        out["setup_s"] = clock.now()

        bs, n_ring = traffic["batch_size"], len(ring)
        losses = []
        host = common.HostReading()
        t_start = time.perf_counter()
        n = 0
        while True:
            losses.append(step(ring[(FIRST_STEPS + n) % n_ring])["loss"])
            host.call_done()
            n += 1
            if time.perf_counter() - t_start >= seconds:
                break
        common.sync(dev)
        window = time.perf_counter() - t_start
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        out.update(attempted=n * bs, failed=failed * bs,
                   end_to_end={"train_samples_per_s": (n - failed) * bs / window},
                   sec_per_unit=window / (n * bs), host=host.summary(bs))
        if traced:
            from torch.profiler import ProfilerActivity, profile

            k = int(traffic["trace_calls"])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(k):
                    with record_function(trace.CALL_SPAN):
                        step(ring[(FIRST_STEPS + n + i) % n_ring])
                common.sync(dev)
                traced_us = (time.perf_counter() - t0) * 1e6
            out["trace"] = (prof, k, k * bs, traced_us)
        out["peak"] = common.peak_bytes(dev)
        del model, opt, step, ring, losses
        common.free(dev)
    else:
        out.update(attempted=0, failed=0, end_to_end={}, setup_s=clock.now(),
                   peak=common.peak_bytes(dev))
        prog, _ = _reference_steps(cell, seed, dev, batches, precision=control)

    (ref, work) = _reference_steps(cell, seed, dev, batches, count=traced and control is None)
    keep = compare.moved_leaves(ref[1])
    out["numbers"] = {"loss_gap": compare.loss_gap(prog[0], ref[0]),
                      **compare.group_gaps(prog[3], ref[3]),
                      "change_gap": compare.leaf_gap(prog[2], ref[2], keep),
                      "grad_gap": compare.leaf_gap(prog[1], ref[1], keep),
                      "grad_gap_median": compare.leaf_gap(prog[1], ref[1], keep, median=True),
                      "change_gap_median": compare.leaf_gap(prog[2], ref[2], keep, median=True)}
    out["detail"] = {"outputs": compare.each_gap(prog[3], ref[3]),
                     "leaves": len(ref[1]), "leaves_compared": len(keep),
                     "loss_prog": [s["loss"] for s in prog[0]],
                     "loss_ref": [s["loss"] for s in ref[0]]}
    if work is not None:
        out["work"] = work_per_unit(work, traffic["batch_size"])
    return out


INT8_KERNELS = ("conv_block", "chain_conv")  # K1, K7: int8 operations


def work_per_unit(counted: Dict[str, Any], units: int) -> Dict[str, float]:
    """The counted work of one call, per step's sample or per frame: the
    float operations of convolutions, products and the float kernels, the
    int8 kernels' operations, and K1's operations and bytes (elementwise
    work is not counted toward a share of the tensor peak)."""
    kf = counted["kernel_flops"]
    int8 = sum(v for k, v in kf.items() if k in INT8_KERNELS)
    flt = (counted["split"]["conv"] + counted["split"]["matmul"]
           + sum(v for k, v in kf.items() if k not in INT8_KERNELS))
    return {"float_flops": flt / units, "int8_ops": int8 / units,
            "k1_ops": kf.get("conv_block", 0.0) / units,
            "k1_bytes": counted["kernel_bytes"].get("conv_block", 0.0) / units}
