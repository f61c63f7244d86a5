"""Data-parallel training of the port on one card, held against one process:
``python3 tools/torch_ddp_check.py`` where the card is (``chip_smoke.py``
runs the same functions).

1. World size 1 on NCCL: the train step under ``DistributedDataParallel`` with
   synchronized BN (``make_train_step(mesh=make_mesh(), sync_bn=True)``)
   against the unwrapped step of the same weights on the same batch
   (``radar_distill_train.yaml`` at 1440², bs2, bf16): loss rel <= 1e-6, every
   parameter after one step within 1e-6 rel-L2 but the leaves whose true
   gradient is zero (their rounding noise may flip between two runs of one
   step on the card: within 2.1·lr, as ``tests/torch_train_case.py`` holds
   them); then the p50 of each, which
   is the cost of the wrapper (DDP's bucket all-reduce and the metrics' one;
   one rank's batch is the global one, so the BNs reduce nothing), and the
   host time of one BN's all-reduce on the NCCL group, which every train-mode
   BN pays twice a step at world sizes above 1.
2. Two ranks on the one card over gloo (NCCL refuses two ranks on one
   device), bs1 each, against one process on the global bs2 batch, float32
   with TF32 off: ``sync_bn=True`` loss rel <= 1e-4 and the parameters after
   one step by the rule of ``tests/torch_train_case.py`` (every element within
   2.1·lr; rel-L2 <= 2e-3 and the updates' cosine >= 0.9 but for the leaves
   whose true gradient is zero); ``sync_bn=False``: the running statistics
   equal the mean of the two ranks' local updates (each rank's batch through
   the unwrapped step), rel-L2 <= 1e-5, the same on both ranks.

The weights are random and away from zero (``layers.init_random_``, seed
0, as ``chip_smoke.py``'s train phases draw them): after one Adam step a
leaf that starts at zero, as the reference initializer's biases do, holds
about ``lr`` times the signs of its gradient, and its relative difference
would compare signs. The ranks of part 2 are this script again,
``--worker RANK PORT DIR``.
``--profile``: one profiled step of each leg of part 1 instead (the ops with
the most host time, the device's self time).
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# leaves of the student whose true gradient is zero (tests/torch_train_case.py)
ZERO_GRAD = re.compile(
    r"radar_backbone_3d\.conv\d_\d\.conv[12]\.conv\.bias"
    r"|radar_cma\.(decoder_\d\.deconv|agg_\d\.conv\.conv)\.bias"
    r"|radar_cma\.encoder_3_1\.(pwconv2\.bias|grn\.beta)"
    r"|radar_dense_head\.(shared_conv|\w+\.conv_0)\.conv\.bias")


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def trainer(torch, cfg, info, dtype, device, mesh=None, sync_bn=True, state=None):
    """A model with seeded random weights (or ``state``), its optimizer and
    its train step."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.layers import init_random_
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg

    full, _ = production_cfg(TRAIN_YAML, grid=info["grid_size"][0])
    model = init_random_(build_network(cfg, info, compute_dtype=dtype, device=device),
                         torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state)
    opt, lr_sched = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    step = make_train_step(model, opt, cfg, info["class_names"], info["voxel_size"],
                           info["point_cloud_range"], mesh=mesh, sync_bn=sync_bn)
    return model, step, lr_sched


def rel_l2(torch, got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def p50(times):
    times = sorted(times)
    return (times[(len(times) - 1) // 2] + times[len(times) // 2]) / 2 * 1e3


def allreduce_us(torch, dev, calls=200, numel=2 * 256 + 1):
    """Host microseconds a call of ``batch_sum`` (the differentiable
    all-reduce of one BN's Σx, Σx², n: 2C + 1 floats, C = 256) takes on the
    default group with its result waited for, forward only, over ``calls``
    calls after 20 warm ones."""
    from radardistill_tpu_torch.parallel.mesh import batch_sum, sync_batch
    import torch.distributed as dist

    x = torch.ones(numel, device=dev)
    with sync_batch(dist.group.WORLD):
        for _ in range(20):
            batch_sum(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            y = batch_sum(x)
        torch.cuda.synchronize()
    if float(y[0]) != dist.get_world_size():
        raise RuntimeError(f"batch_sum: {float(y[0])} over {dist.get_world_size()} ranks")
    return (time.perf_counter() - t0) / calls * 1e6


def world1_nccl(torch, dev, cfg, info, batch, runs=10, on_step=None):
    """Part 1. ``on_step(fn)`` wraps the DDP leg's steps (the caller's launch
    counting). Returns the figures; ``allreduce_us``: one BN's all-reduce
    on the NCCL group, which the step makes at world sizes above 1 only."""
    import torch.distributed as dist

    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        bdev = batch_to_torch(batch, dev)
        plain_model, plain_step, lr_sched = trainer(torch, cfg, info, torch.bfloat16, dev)
        ddp_model, ddp_step, _ = trainer(torch, cfg, info, torch.bfloat16, dev,
                                         mesh=make_mesh(dev), sync_bn=True)
        if ddp_step.ddp is None:
            raise RuntimeError("DDP step: no DistributedDataParallel wrapper at world size 1")
        want = float(plain_step(bdev)["loss"])
        run = on_step or (lambda fn: fn())
        got = float(run(lambda: ddp_step(bdev))["loss"])
        a, b = ddp_model.state_dict(), plain_model.state_dict()
        trained = [n for n, p in plain_model.named_parameters() if p.requires_grad]
        # the leaves whose true gradient is zero carry rounding noise, which
        # the card's unordered float sums may flip between two runs of the
        # same step: Adam moves them by up to lr either way
        worst = max((rel_l2(torch, a[n], b[n]), n) for n in trained if not ZERO_GRAD.fullmatch(n))
        noise = max(float((a[n] - b[n]).abs().max()) for n in trained if ZERO_GRAD.fullmatch(n))
        loss_rel = abs(got - want) / abs(want)
        if not loss_rel <= 1e-6 or not worst[0] <= 1e-6 or not noise <= 2.1 * lr_sched(0):
            raise RuntimeError(f"DDP step at world size 1: loss {got} against {want} (rel "
                               f"{loss_rel:.3e}), worst parameter {worst}, the zero-gradient "
                               f"leaves within {noise:.3e}")
        times = {"plain": [], "ddp": []}
        for _ in range(runs):  # in turns
            for name, fn in (("plain", plain_step), ("ddp", ddp_step)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(lambda: fn(bdev)) if name == "ddp" else fn(bdev)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        return {"loss": got, "loss_rel": loss_rel, "worst_param_rel_l2": worst[0],
                "zero_grad_max_abs": noise, "lr": lr_sched(0),
                "plain_p50_ms": p50(times["plain"]), "ddp_p50_ms": p50(times["ddp"]),
                "params": len(trained), "allreduce_us": allreduce_us(torch, dev)}
    finally:
        dist.destroy_process_group()


def profile_world1(torch, dev, cfg, info, batch, rows=25):
    """One profiled step of each leg of part 1 (after 2 warm ones): the ops
    with the most host time, and the device's busy time, side by side."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        bdev = batch_to_torch(batch, dev)
        legs = {"unwrapped": trainer(torch, cfg, info, torch.bfloat16, dev)[1],
                "ddp": trainer(torch, cfg, info, torch.bfloat16, dev, mesh=make_mesh(dev))[1]}
        for name, step in legs.items():
            for _ in range(2):
                step(bdev)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step(bdev)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = prof.key_averages()
            device = sum(e.self_device_time_total for e in events) / 1e3
            print(f"--- {name}: {wall:.3f} ms profiled, device self time {device:.3f} ms")
            print(events.table(sort_by="self_cpu_time_total", row_limit=rows))
    finally:
        dist.destroy_process_group()


def _launches():
    """The launch counts of the kernels of the train step."""
    from radardistill_tpu_torch.ops.conv_block import conv_block
    from radardistill_tpu_torch.ops.dcn_grad import dcn_input_grad, dcn_offset_grad
    from radardistill_tpu_torch.ops.dcn_sample import dcn_sample
    from radardistill_tpu_torch.ops.expand import expand_rows

    return {"expand_rows": expand_rows.launches, "dcn_sample": dcn_sample.launches,
            "conv_block": conv_block.launches, "dcn_offset_grad": dcn_offset_grad.launches,
            "dcn_input_grad": dcn_input_grad.launches}


def worker(rank, port, work):
    """One rank of part 2: the synchronized step, then the local one, each
    from the saved weights on this rank's half of the batch."""
    import torch

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK=str(rank))
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from radardistill_tpu_torch.utils.common import maybe_init_distributed

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    maybe_init_distributed("cuda")  # 2 ranks, 1 card: gloo
    inputs = torch.load(Path(work) / "inputs.pt", weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(dev)
    local = batch_to_torch(shard_batch(inputs["batch"], mesh), dev)
    out = {}
    for leg, sync in (("sync", True), ("local", False)):
        model, step, _ = trainer(torch, inputs["cfg"], inputs["info"], torch.float32, dev,
                                 mesh=mesh, sync_bn=sync, state=inputs["state"])
        before = _launches()
        metrics = step(local)
        torch.cuda.synchronize()
        out[leg] = {"loss": float(metrics["loss"]),
                    "launches": {k: v - before[k] for k, v in _launches().items()},
                    "state": {k: v.cpu() for k, v in model.state_dict().items()}}
        del model, step
    torch.save(out, Path(work) / f"rank{rank}.pt")
    import torch.distributed as dist

    dist.destroy_process_group()


def two_ranks(torch, dev, cfg, info, batch, work, step_launches):
    """Part 2. ``step_launches``: the kernels' launches of one step, which
    each rank's steps must show. Returns the figures."""
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.parallel.mesh import Mesh, shard_batch

    work = Path(work)
    work.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        model, step, lr_sched = trainer(torch, cfg, info, torch.float32, dev)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        torch.save({"cfg": cfg, "info": info, "batch": batch,
                    "state": {k: v.cpu() for k, v in state.items()}}, work / "inputs.pt")
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--worker",
                                   str(r), str(port), str(work)], cwd=ROOT,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        try:
            # while the ranks start: one process on the global batch, and
            # each rank's half through the unwrapped step (the local updates)
            want = float(step(batch_to_torch(batch, dev))["loss"])
            glob = model.state_dict()
            local_stats = []
            for r in (0, 1):
                m, s, _ = trainer(torch, cfg, info, torch.float32, dev, state=state)
                s(batch_to_torch(shard_batch(batch, Mesh(None, r, 2, dev)), dev))
                local_stats.append({k: v.clone() for k, v in m.state_dict().items()
                                    if "running_" in k})
                del m, s
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} failed:\n{outs[r][-4000:]}")
        t_ranks = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    for r in ranks:
        for leg in ("sync", "local"):
            if {k: v for k, v in r[leg]["launches"].items()} != step_launches:
                raise RuntimeError(f"rank step launches {r[leg]['launches']}, expected "
                                   f"{step_launches}")

    # sync_bn=True against one process on the global batch
    got = ranks[0]["sync"]["loss"]
    loss_rel = abs(got - want) / abs(want)
    reach = 2.1 * lr_sched(0)
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    bad, worst_rel, least_cos = [], 0.0, 1.0
    for n in trained:
        a, b, b0 = ranks[0]["sync"]["state"][n].to(dev), glob[n], state[n]
        if not torch.equal(a.cpu(), ranks[1]["sync"]["state"][n]):
            bad.append(f"{n}: the ranks differ")
        if float((a - b).abs().max()) > reach:
            bad.append(f"{n}: beyond 2.1 lr")
        if ZERO_GRAD.fullmatch(n):
            continue
        rel = rel_l2(torch, a, b)
        da, db = (a - b0).flatten().double(), (b - b0).flatten().double()
        cos = float(da @ db / (da.norm() * db.norm()).clamp_min(1e-30))
        worst_rel, least_cos = max(worst_rel, rel), min(least_cos, cos)
        if rel > 2e-3 or cos < 0.9:
            bad.append(f"{n}: rel-L2 {rel:.3e}, cosine {cos:.4f}")
    if not loss_rel <= 1e-4 or bad:
        raise RuntimeError(f"2 ranks, sync_bn=True: loss {got} against {want} (rel "
                           f"{loss_rel:.3e}); {bad[:5]}")

    # sync_bn=False: the running statistics are the mean of the local updates
    stats_rel = 0.0
    for n, v0 in local_stats[0].items():
        mean = (v0 + local_stats[1][n]) / 2
        a = ranks[0]["local"]["state"][n]
        if not torch.equal(a, ranks[1]["local"]["state"][n]):
            raise RuntimeError(f"2 ranks, sync_bn=False: the ranks' {n} differ")
        stats_rel = max(stats_rel, rel_l2(torch, a.to(dev), mean))
    if not stats_rel <= 1e-5:
        raise RuntimeError(f"2 ranks, sync_bn=False: running statistics {stats_rel:.3e} from "
                           "the mean of the local updates")
    return {"loss": got, "loss_one_process": want, "loss_rel": loss_rel,
            "worst_param_rel_l2": worst_rel, "least_update_cos": least_cos,
            "local_loss": ranks[0]["local"]["loss"], "stats_rel_l2": stats_rel,
            "stats": len(local_stats[0]), "ranks_s": t_ranks}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"))
    parser.add_argument("--profile", action="store_true",
                        help="profile one step of each leg of part 1 instead")
    args = parser.parse_args()
    if args.worker:
        worker(int(args.worker[0]), int(args.worker[1]), args.worker[2])
        return 0
    import tempfile

    import torch

    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg, info, batch = make_batch(TRAIN_YAML)
    if args.profile:
        profile_world1(torch, dev, cfg, info, batch)
        return 0
    one = world1_nccl(torch, dev, cfg, info, batch)
    print(f"world size 1, NCCL, bf16, 1440², bs2 on {smi}: {one}")
    step = {"expand_rows": 2, "dcn_sample": 3, "conv_block": 4, "dcn_offset_grad": 3,
            "dcn_input_grad": 3}
    two = two_ranks(torch, dev, cfg, info, batch, tempfile.mkdtemp(), step)
    print(f"2 ranks on one card, gloo, f32, bs1 each against bs2 on {smi}: {two}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
