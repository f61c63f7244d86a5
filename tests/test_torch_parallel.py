"""Data parallelism of the port (``parallel/``, ``make_train_step(mesh=...)``)
on the CPU: a real 2-process ``torch.distributed`` job over gloo
(``tests/torch_parallel_worker.py``), started once for the module, against
the port's one-process step on the global batch and against the JAX
package's step over a 2-device mesh.

The model is ``radar_distill_train.yaml`` at grid 128 in float32 (teacher
``INT8: false``), batch 2 (one sample a rank), as ``tests/torch_train_case.py``
runs it; its JAX variables come from ``jax.eval_shape`` of ``model.init``
with numpy values (``tests/test_torch_device_tables.py``), and the running
statistics of the trained (student) BNs start at zero, so that after one step
they are ``momentum`` times the step's batch statistics and can be compared
as such. The heterogeneous batch scales the lidar and radar features of
sample i by (i + 1) / 4, as ``tests/test_parallel.py`` does the lidar ones,
so that local BN statistics differ between the ranks.

Tolerances. Synchronized leg against one process: loss rel 1e-5, every BN's
batch statistics rel-L2 1e-5, gradients rel-L2 2e-2 per scope (the repo's
float32 summation-order bound, ROADMAP §3), every parameter element within
2.1·lr after the step. Against JAX's GSPMD step: loss rtol 1e-4 and the
parameter rule of ``tests/torch_train_case.py`` after one step. Local leg
against JAX's ``shard_map`` leg: loss rtol 1e-4, running statistics rel-L2
1e-4, and its loss differs from the synchronized leg's by more than 1e-6.
"""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from radardistill_tpu.data.host_precompute import HostPrecompute as JaxHostPrecompute
from radardistill_tpu.models import build_network as jax_build_network
from radardistill_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radardistill_tpu.train import optim as joptim
from radardistill_tpu.train import train_step as jstep
from radardistill_tpu.utils.production import production_cfg as j_production_cfg
from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.parallel import multihost
from radardistill_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import make_train_step
from radardistill_tpu_torch.utils.production import TRAIN_YAML
from tests.test_torch_device_tables import _collated, _numpy_variables
from tests.test_torch_masked_bn import assert_close, bn_grads
from tests.test_torch_slice import _rel_l2
from tests.torch_parallel_worker import MASKED_BN_SHAPE, masked_bn_inputs
from tests.torch_train_case import FROZEN, SCOPES, STEP_TOL, ZERO_GRAD

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _hetero(batch):
    out = copy.deepcopy(batch)
    for key in ("points", "radar_points"):
        for i in range(out[key].shape[0]):
            out[key][i, :, 3:] *= (i + 1) / 4.0
    return out


def _zero_student_stats(variables):
    flat = flax.traverse_util.flatten_dict(variables)
    for k in flat:
        if k[0] == "batch_stats" and k[1].startswith("radar_"):
            flat[k] = np.zeros_like(flat[k])
    return flax.traverse_util.unflatten_dict(flat)


def _start_job(work, inputs):
    """Start the two ranks of the gloo job on ``inputs``; returns the
    processes."""
    (work / "cli").mkdir()
    torch.save(inputs, work / "inputs.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(r),
                              str(port), str(work)], cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]


def _wait(procs, work):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{outs[r][-6000:]}"
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in (0, 1)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The 2-process gloo job (each rank's results under ``ranks``), started
    once, and while it runs the port's one-process step on the global batch
    and the JAX package's mesh steps (synchronized on the batch, local on the
    heterogeneous one)."""
    full, info, batch = _collated(TRAIN_YAML, 128, 4000, 300, 512)
    jfull, _ = j_production_cfg(TRAIN_YAML, grid=128)
    cfg = full.MODEL
    cfg.BACKBONE_3D.INT8 = False
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    batches = {"batch": batch, "hetero": _hetero(batch)}
    jb = {k: jax.tree.map(jnp.asarray, JaxHostPrecompute(cfg, *geo)(copy.deepcopy(b)))
          for k, b in batches.items()}
    tb = {k: batch_to_torch(HostPrecompute(cfg, *geo)(copy.deepcopy(b)), "cpu")
          for k, b in batches.items()}
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    variables = _zero_student_stats(_numpy_variables(jmodel, jb["batch"]))
    work = tmp_path_factory.mktemp("dp_job")
    procs = _start_job(work, {"cfg": cfg, "info": info, "optim": full.OPTIMIZATION,
                              "variables": variables, **tb})

    # the port, one process, the global batch
    model = load_jax_variables(build_network(cfg, info, device="cpu"), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    lgeo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])
    one = {k: float(v) for k, v in make_train_step(model, opt, cfg, *lgeo)(tb["batch"]).items()}
    one_grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    # the JAX package over a 2-device mesh
    tx, _ = joptim.build_optimizer(jfull.OPTIMIZATION, variables["params"], 1000, sorted(FROZEN))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             opt_state=tx.init(params))
    mesh = jax_make_mesh(jax.devices()[:2])
    repl, dp = NamedSharding(mesh, P()), NamedSharding(mesh, P("dp"))
    state = jax.device_put(state, repl)
    shard = {k: jax.tree.map(lambda x: jax.device_put(x, dp), b) for k, b in jb.items()}
    jsync = jstep.make_train_step(jmodel, tx, cfg, *lgeo, mesh=mesh, sync_bn=True)
    jlocal = jstep.make_train_step(jmodel, tx, cfg, *lgeo, mesh=mesh, sync_bn=False)
    js, jm = jax.jit(jsync, in_shardings=(repl, dp), out_shardings=(repl, repl))(
        state, shard["batch"])
    jl, jlm = jax.jit(jlocal)(state, shard["hetero"])
    tree = lambda s: jax.tree.map(np.asarray, {"params": s.params, "batch_stats": s.batch_stats})
    return dict(cfg=cfg, info=info, optim=full.OPTIMIZATION, work=work,
                before=before, one=one, one_grads=one_grads, one_state=model.state_dict(),
                lr=opt.lr_sched(0), model=model,
                jsync=(float(jm["loss"]), state_dict_from_jax(model, tree(js))),
                jlocal=(float(jlm["loss"]), state_dict_from_jax(model, tree(jl))),
                ranks=_wait(procs, work))


@pytest.fixture(scope="module")
def job(case):
    """Each rank's results and the job's directory."""
    return case["ranks"], case["work"]


def _student_stats(state):
    return [n for n in state if "running_" in n and n.split(".", 1)[0] in SCOPES]


# ------------------------------------------------ synchronized leg (default)

def test_sync_leg_loss_and_metrics_match_one_process(case, job):
    (r0, r1), _ = job
    assert r0["mesh"] == (0, 2) and r1["mesh"] == (1, 2)
    for k, want in case["one"].items():
        got = float(r0["sync_metrics"][k])
        assert float(r1["sync_metrics"][k]) == got, k  # the same metrics on every rank
        if k == "loss":
            assert abs(got - want) <= 1e-5 * abs(want)
        else:  # the IoU targets come out of the float32 polygon clipping
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=k)


def test_sync_leg_batch_statistics_match_one_process(case, job):
    (r0, r1), _ = job
    names = _student_stats(case["one_state"])
    assert len(names) > 40
    for n in names:
        want = case["one_state"][n]
        assert want.abs().max() > 0, n  # momentum times the step's statistics
        assert torch.equal(r0["sync_state"][n], r1["sync_state"][n]), n
        assert _rel_l2(r0["sync_state"][n].numpy(), want.numpy()) <= 1e-5, n


@pytest.mark.parametrize("scope", SCOPES)
def test_sync_leg_gradients_match_one_process(case, job, scope):
    (r0, r1), _ = job
    names = [n for n in case["one_grads"] if n.split(".", 1)[0] == scope]
    assert names and set(r0["sync_grads"]) == set(case["one_grads"])
    got = torch.cat([r0["sync_grads"][n].flatten() for n in names])
    want = torch.cat([case["one_grads"][n].flatten() for n in names])
    assert torch.equal(got, torch.cat([r1["sync_grads"][n].flatten() for n in names]))
    assert _rel_l2(got.numpy(), want.numpy()) <= 2e-2


def test_sync_leg_parameters_match_one_process(case, job):
    (r0, r1), _ = job
    reach = 2.1 * case["lr"]
    trained = [n for n, p in case["model"].named_parameters() if p.requires_grad]
    for n in trained:
        assert torch.equal(r0["sync_state"][n], r1["sync_state"][n]), n
        assert (r0["sync_state"][n] - case["one_state"][n]).abs().max() <= reach, n
        assert not torch.equal(r0["sync_state"][n], case["before"][n]), n
    frozen = [n for n in case["before"] if n.split(".", 1)[0] in FROZEN]
    assert frozen and all(torch.equal(r0["sync_state"][n], case["before"][n]) for n in frozen)


@pytest.mark.parametrize("scope", SCOPES)
def test_sync_leg_matches_jax_mesh_step(case, job, scope):
    """Against the JAX package's step jitted over ``make_mesh(jax.devices()[:2])``
    with the batch sharded: loss, and the parameter rule of
    tests/torch_train_case.py after one step."""
    (r0, _), _ = job
    jloss, want = case["jsync"]
    np.testing.assert_allclose(float(r0["sync_metrics"]["loss"]), jloss, rtol=1e-4)
    after, before = r0["sync_state"], case["before"]
    rel_tol, cos_tol, _ = STEP_TOL[1]
    names = [n for n, p in case["model"].named_parameters()
             if p.requires_grad and n.split(".", 1)[0] == scope]
    assert names
    for n in names:
        assert (after[n] - want[n]).abs().max() <= 2.1 * case["lr"], n
        if ZERO_GRAD.fullmatch(n):
            continue
        assert _rel_l2(after[n].numpy(), want[n].numpy()) <= rel_tol, n
        dt, dj = ((x[n] - before[n]).flatten().double() for x in (after, want))
        assert dt @ dj >= cos_tol * dt.norm() * dj.norm(), n


def test_sync_masked_bn_backward_matches_one_process(job):
    """The group branch of the train-mode ``MaskedBatchNorm``'s hand-written
    backward: on each rank's share of the batch, dx equals the one-process
    dx of those rows and the summed dweight / dbias equal the one-process
    ones (``tests/test_torch_masked_bn.py``'s tolerance)."""
    (r0, r1), _ = job
    for case in ("float32", "constant_channel"):
        x, mask, gy, weight, bias = masked_bn_inputs(case, MASKED_BN_SHAPE)
        dx, dw, db = bn_grads(*(torch.from_numpy(a) for a in (x, mask, gy)), weight, bias)
        for rank, res in enumerate((r0, r1)):
            got_dx, got_dwb = res["masked_bn"][case]
            assert_close(got_dx.numpy(), dx[rank::2].numpy(), f"{case} dx rank {rank}")
            assert_close(got_dwb.numpy(), torch.cat([dw, db]).numpy(), f"{case} dw, db")


# ------------------------------------------------ local leg (sync_bn=False)

def test_local_leg_matches_jax_shard_map(case, job):
    (r0, r1), _ = job
    jloss, want = case["jlocal"]
    np.testing.assert_allclose(float(r0["local_metrics"]["loss"]), jloss, rtol=1e-4)
    names = _student_stats(case["one_state"])
    for n in names:
        # the running statistics are the mean of the two ranks' local updates
        assert torch.equal(r0["local_state"][n], r1["local_state"][n]), n
        assert _rel_l2(r0["local_state"][n].numpy(), want[n].numpy()) <= 1e-4, n


def test_local_leg_differs_from_sync_leg(job):
    (r0, _), _ = job
    local, sync = float(r0["local_metrics"]["loss"]), float(r0["sync_hetero_metrics"]["loss"])
    assert np.isfinite(local) and abs(local - sync) > 1e-6


# -------------------------------------------------------------- multihost

def test_gather_detections_keeps_rank_order_lengths_and_metadata(job):
    (r0, r1), _ = job
    for r in (r0, r1):
        merged = r["multihost"]["merged"]
        assert [d["frame_id"] for d in merged] == ["p0_s0", "p0_s1", "p1_s0", "p1_s1", "p1_s2"]
        assert merged[0]["metadata"]["token"] == "tok_p0_s0" and merged[2]["name"][0] == "car"
        np.testing.assert_allclose(merged[3]["pred_scores"],
                                   np.linspace(0, 1, 602).astype(np.float32))


def test_gather_detections_has_no_box_cap(job):
    (r0, _), _ = job
    assert r0["multihost"]["merged"][-1]["pred_boxes"].shape == (603, 9)


def test_all_gather_object_and_scalars(job):
    for r in job[0]:
        assert [o["rank"] for o in r["multihost"]["objs"]] == [0, 1]
        assert r["multihost"]["psum"] == 3.0 and r["multihost"]["pmean"] == 0.5


def test_single_process_identity():
    annos = [{"pred_boxes": np.zeros((3, 9)), "frame_id": "a", "metadata": {"token": "t"}}]
    assert multihost.gather_detections(annos) is annos
    assert multihost.all_gather_object({"x": 1}) == [{"x": 1}]
    assert multihost.psum_scalar(2.5) == 2.5 and multihost.pmean_scalar(2.5) == 2.5
    assert make_mesh("cpu") == Mesh(None, 0, 1, torch.device("cpu"))


def test_shard_batch_is_the_loaders_rank_slice():
    """A rank's share of the global batch b·W is its loader's batch of b
    (``idx[rank::world]``), host tables included."""
    from radardistill_tpu_torch.data.dataset import SyntheticDataset
    from radardistill_tpu_torch.data.loader import DataLoader

    cfg = ConfigDict(POINT_CLOUD_RANGE=[-4.8, -4.8, -5.0, 4.8, 4.8, 3.0], NUM_SAMPLES=8,
                     SYN_NUM_LIDAR=50, SYN_NUM_RADAR=20, SYN_NUM_BOXES=2,
                     CAPACITIES={"MAX_LIDAR_POINTS": 64, "MAX_RADAR_POINTS": 32,
                                 "NUM_MAX_OBJS": 4})
    ds = SyntheticDataset(cfg, ["car", "truck"], training=False)
    (glob,) = [b for b, _ in DataLoader(ds, 8, shuffle=False)]
    for rank in (0, 1):
        (local,) = [b for b, _ in DataLoader(ds, 4, shuffle=False, process_index=rank,
                                             process_count=2)]
        got = shard_batch(glob, Mesh(None, rank, 2, torch.device("cpu")))
        assert set(got) == set(local)
        for k in local:
            np.testing.assert_array_equal(got[k], local[k], err_msg=k)


# ------------------------------------------------- checkpoint and the CLI

def test_two_rank_checkpoint_loads_into_one_process(case, job):
    (r0, _), work = job
    assert not any((work / "ckpt1").iterdir())  # rank 0 alone writes
    payload = torch.load(work / "ckpt0" / "checkpoint_epoch_1", weights_only=True)
    assert not any(k.startswith("module.") for k in payload["model_state"])
    model = build_network(case["cfg"], case["info"], device="cpu")
    opt, _ = build_optimizer(case["optim"], model, 1000, model.frozen)
    from radardistill_tpu_torch.train.train_step import TrainState

    state, epoch, it = CheckpointManager(work / "ckpt0").restore(TrainState(model, opt))
    assert (epoch, it) == (1, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, r0["sync_state"][k]), k


def test_train_cli_two_ranks_sync_bn_0(job):
    """tools/torch_train.py --sync_bn 0 under WORLD_SIZE=2: two steps a rank,
    the replicas equal after them, rank 0's checkpoint and the gathered
    evaluation's detections."""
    (r0, r1), _ = job
    assert r0["cli"]["step"] == r1["cli"]["step"] == 2
    for k, v in r0["cli"]["params"].items():
        assert torch.equal(v, r1["cli"]["params"][k]), k
    assert r0["cli"]["result_pkl"] == ["eval/eval_with_train/eval_epoch_1/result.pkl"]
    # rank 0's slice (samples 0, 2), then rank 1's (1, 3)
    assert r0["cli"]["frames"] == [f"synthetic_{i}" for i in (0, 2, 1, 3)]
