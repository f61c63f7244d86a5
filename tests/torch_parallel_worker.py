"""One rank of the 2-process gloo job of ``tests/test_torch_parallel.py``.

Run: ``python -m tests.torch_parallel_worker <rank> <port> <workdir>`` from
the repository root, twice (ranks 0 and 1). The rank joins the job through
``maybe_init_distributed`` (torchrun's variables, gloo on the CPU), reads
``<workdir>/inputs.pt`` (the model configuration, the JAX variables as
numpy, the host-precomputed global batches), runs every distributed case
once and writes what the tests read to ``<workdir>/rank<rank>.pt``:

- the synchronized leg on its share of the global batch: metrics, the
  reduced gradients, the state after the step, and a checkpoint written
  through the checkpoint manager (rank 0 only);
- the local leg (``sync_bn=False``) and the synchronized leg on the
  heterogeneous batch;
- the train-mode ``MaskedBatchNorm`` on each rank's share of a batch,
  its statistics' gradient summed over the group in its backward;
- the cases of ``tests/_multihost_worker.py`` through the port's
  ``parallel/multihost.py``;
- ``tools/torch_train.py --sync_bn 0`` on two ranks, its post-train
  evaluation gathering the detections of both.
"""

import os
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GRID128 = str(REPO / "tools" / "cfgs" / "synthetic" / "production_cert_grid128.yaml")


def _step(inputs, batch, mesh, sync_bn):
    from radardistill_tpu_torch.convert import load_jax_variables
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.parallel.mesh import shard_batch
    from radardistill_tpu_torch.train.optim import build_optimizer
    from radardistill_tpu_torch.train.train_step import make_train_step

    cfg, info = inputs["cfg"], inputs["info"]
    model = load_jax_variables(build_network(cfg, info, device="cpu"), inputs["variables"])
    opt, _ = build_optimizer(inputs["optim"], model, 1000, model.frozen)
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])
    step = make_train_step(model, opt, cfg, *geo, mesh=mesh, sync_bn=sync_bn)
    metrics = {k: v.clone() for k, v in step(shard_batch(batch, mesh)).items()}
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return step, metrics, grads, state


def masked_bn_inputs(case, shape=(2, 6, 5, 8), seed=0):
    """(x, mask, cotangent, weight, bias) of a ``MaskedBatchNorm`` case as
    numpy float32, seeded (``tests/test_torch_masked_bn.py``'s cases)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    mask = rng.rand(*shape[:-1]) < 0.66
    if case == "all_inactive":
        mask[:] = False
    if case == "constant_channel":
        x[..., 2] = np.where(mask, 0.5, x[..., 2])
    gy = rng.randn(*shape).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, shape[-1]).astype(np.float32)
    return x, mask, gy, weight, bias


MASKED_BN_SHAPE = (4, 6, 5, 8)


def _masked_bn(rank, mesh):
    """The train-mode ``MaskedBatchNorm`` on this rank's share (rows
    ``rank::2``) of a global batch, its forward inside a ``sync_batch``
    scope: dx of the share, dweight and dbias summed over the ranks (each
    rank's loss is its share of the global one), per case."""
    import torch.distributed as dist

    from radardistill_tpu_torch.models.layers import MaskedBatchNorm
    from radardistill_tpu_torch.parallel.mesh import sync_batch

    out = {}
    for case in ("float32", "constant_channel"):
        x, mask, gy, weight, bias = (a[rank::2] if a.ndim > 1 else a
                                     for a in masked_bn_inputs(case, MASKED_BN_SHAPE))
        bn = MaskedBatchNorm(x.shape[-1]).train()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
        xt = torch.from_numpy(np.ascontiguousarray(x)).requires_grad_()
        with sync_batch(mesh.group):
            y = bn(xt, torch.from_numpy(np.ascontiguousarray(mask)))
        y.backward(torch.from_numpy(np.ascontiguousarray(gy)))
        dwb = torch.cat([bn.weight.grad, bn.bias.grad])
        dist.all_reduce(dwb, group=mesh.group)
        out[case] = (xt.grad, dwb)
    return out


def _multihost(rank):
    """The cases of tests/_multihost_worker.py."""
    from radardistill_tpu_torch.parallel.multihost import (all_gather_object,
                                                           gather_detections, pmean_scalar,
                                                           psum_scalar)

    annos = []
    for i in range(2 + rank):  # lists of different lengths
        n_box = 600 * rank + i + 1  # more than 512 boxes on rank 1
        annos.append({
            "pred_boxes": np.full((n_box, 9), rank, np.float32),
            "pred_scores": np.linspace(0, 1, n_box).astype(np.float32),
            "pred_labels": np.ones(n_box, np.int64),
            "name": np.array(["car"] * n_box),
            "frame_id": f"p{rank}_s{i}",
            "metadata": {"token": f"tok_p{rank}_s{i}"},
        })
    return {"merged": gather_detections(annos),
            "objs": all_gather_object({"rank": rank}),
            "psum": psum_scalar(1.5), "pmean": pmean_scalar(float(rank))}


def _train_cli(work):
    """tools/torch_train.py on two ranks with --sync_bn 0: two steps a rank
    (4 samples, batch 1), then the post-train evaluation."""
    from tools import torch_train

    os.chdir(work)
    state = torch_train.main([
        "--cfg_file", GRID128, "--device", "cpu", "--epochs", "1", "--batch_size", "1",
        "--workers", "0", "--sync_bn", "0", "--log_interval", "1",
        "--set", "DATA_CONFIG.NUM_SAMPLES", "4",
        "MODEL.RADAR_DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE", "50"])
    out = Path(work) / "output" / "production_cert_grid128" / "default"
    pkls = sorted(out.rglob("result.pkl"))
    return {"step": state.step,
            "params": {k: v.clone() for k, v in state.model.state_dict().items()},
            "result_pkl": [str(p.relative_to(out)) for p in pkls],
            "frames": [d["frame_id"] for d in pickle.loads(pkls[0].read_bytes())]}


def main(rank, port, work):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK=str(rank))
    import torch.distributed as dist

    from radardistill_tpu_torch.parallel.mesh import make_mesh
    from radardistill_tpu_torch.parallel.multihost import barrier
    from radardistill_tpu_torch.train.checkpoint import CheckpointManager
    from radardistill_tpu_torch.utils.common import maybe_init_distributed

    assert maybe_init_distributed("cpu") is True
    inputs = torch.load(Path(work) / "inputs.pt", weights_only=False)
    mesh = make_mesh("cpu")
    res = {"mesh": (mesh.rank, mesh.world_size)}

    step, res["sync_metrics"], res["sync_grads"], res["sync_state"] = _step(
        inputs, inputs["batch"], mesh, True)
    assert step.ddp is not None and step.state.model is not step.ddp
    CheckpointManager(Path(work) / f"ckpt{rank}").save(step.state, 1)
    barrier()
    _, res["local_metrics"], _, res["local_state"] = _step(inputs, inputs["hetero"], mesh, False)
    res["sync_hetero_metrics"] = _step(inputs, inputs["hetero"], mesh, True)[1]
    res["masked_bn"] = _masked_bn(rank, mesh)
    res["multihost"] = _multihost(rank)
    res["cli"] = _train_cli(Path(work) / "cli")
    torch.save(res, Path(work) / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
