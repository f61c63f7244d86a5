"""The runtime around the port's train step, on the CPU: the checkpoint
manager, the trainer, the eval loop, the train state and the common
utilities, each against the JAX module of the same name where one can run
the same inputs, and as ``tests/test_checkpoint.py`` and
``tests/test_trainer.py`` hold the JAX ones otherwise.

The resume test is the one at the model's size: ``production_cert_grid128.yaml``
in float32, batches from the loader. Three steps in a row must equal one step,
a save, a load into a fresh model and optimizer, and two more steps, bit for
bit: every parameter, BN statistic and Adam moment, the update count, and the
losses.
"""

import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import TrainState

# Six xdist workers share the machine's cores: one intra-op thread per worker.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GRID128 = REPO / "tools" / "cfgs" / "synthetic" / "production_cert_grid128.yaml"
OPTIM = ConfigDict(OPTIMIZER="adam_onecycle", LR=1e-3, DIV_FACTOR=10, PCT_START=0.4,
                   MOMS=[0.95, 0.85], WEIGHT_DECAY=0.01, GRAD_NORM_CLIP=10)


class Tiny(nn.Module):
    """A teacher scope and its radar twin, with BN statistics."""

    def __init__(self, seed, radar_in=3):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.vfe = nn.Sequential(nn.Linear(2, 4), nn.BatchNorm1d(4))
        self.radar_vfe = nn.Sequential(nn.Linear(radar_in, 4), nn.BatchNorm1d(4))
        with torch.no_grad():
            for t in list(self.parameters()) + list(self.buffers()):
                if t.is_floating_point():
                    t.copy_(torch.randn(t.shape, generator=g))

    def forward(self, x):
        return self.vfe(x[:, :2]).sum() + self.radar_vfe(x[:, :self.radar_vfe[0].in_features]).sum()


def tiny_state(seed, steps=0, **kwargs):
    model = Tiny(seed, **kwargs)
    opt, _ = build_optimizer(OPTIM, model, 100, frozen_scopes=("vfe",))
    for i in range(steps):
        opt.zero_grad()
        model(torch.randn(8, 5, generator=torch.Generator().manual_seed(i))).backward()
        opt.step()
    return TrainState(model, opt)


def assert_state_equal(got, want):
    a, b = got.model.state_dict(), want.model.state_dict()
    assert sorted(a) == sorted(b)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    assert got.step == want.step
    sa, sb = got.optimizer.inner.state_dict(), want.optimizer.inner.state_dict()
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sb["state"]:
        for k in sb["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)


# --------------------------------------------------------------- checkpoint

def test_save_restore_roundtrip_and_rotation(tmp_path):
    mgr = CheckpointManager(tmp_path, max_ckpt_save_num=2)
    for e in (1, 2, 3):
        mgr.save(tiny_state(e, steps=e), epoch=e)
        time.sleep(0.01)
    assert mgr.list_epochs() == [2, 3]  # rotation: the 2 newest kept
    assert (tmp_path / "checkpoint_epoch_3").is_file()
    target = tiny_state(0)
    state, epoch, it = mgr.restore(target)
    assert (epoch, it) == (3, 3) and state is target
    assert_state_equal(state, tiny_state(3, steps=3))
    assert not state.model.vfe[0].weight.requires_grad  # the frozen mask is kept


def test_restore_specific_epoch(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(tiny_state(1, steps=1), epoch=1)
    mgr.save(tiny_state(2, steps=2), epoch=2)
    state, epoch, it = mgr.restore(tiny_state(0), epoch=1)
    assert (epoch, it) == (1, 1)
    assert_state_equal(state, tiny_state(1, steps=1))


def test_restore_prefers_newer_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, max_ckpt_save_num=5)
    mgr.save(tiny_state(3, steps=3), epoch=2, it=20)
    time.sleep(0.05)
    mgr.save(tiny_state(7, steps=4), epoch=2, it=27, tag="latest")
    assert (tmp_path / "checkpoint_epoch_latest").is_file()
    st, epoch, it = mgr.restore(tiny_state(0))
    assert (epoch, it) == (2, 27)
    assert_state_equal(st, tiny_state(7, steps=4))
    time.sleep(0.05)
    mgr.save(tiny_state(9, steps=5), epoch=3, it=30)  # a newer numbered one wins
    assert mgr.restore(tiny_state(0))[1:] == (3, 30)


def test_restore_skips_corrupt_newest(tmp_path, caplog):
    mgr = CheckpointManager(tmp_path)
    mgr.save(tiny_state(1, steps=1), epoch=1)
    path = mgr.save(tiny_state(2, steps=2), epoch=2)
    path.write_bytes(path.read_bytes()[:200])  # a torn file
    with caplog.at_level(logging.WARNING):
        st, epoch, _ = mgr.restore(tiny_state(0))
    assert epoch == 1 and "corrupt" in caplog.text
    assert_state_equal(st, tiny_state(1, steps=1))
    path.write_bytes(b"")
    assert mgr.restore(tiny_state(0), epoch=2) is None


def test_restore_falls_back_to_params_when_the_optimizer_differs(tmp_path, caplog):
    mgr = CheckpointManager(tmp_path)
    saved = tiny_state(1, steps=2)
    mgr.save(saved, epoch=1)
    target = tiny_state(0)
    target.optimizer, _ = build_optimizer(OPTIM, target.model, 10)  # nothing frozen
    with caplog.at_level(logging.WARNING):
        st, epoch, it = mgr.restore(target)
    assert (epoch, it) == (1, 2) and "alone" in caplog.text
    for k, v in saved.model.state_dict().items():
        assert torch.equal(st.model.state_dict()[k], v), k
    assert st.optimizer.count == 0 and not st.optimizer.inner.state


def test_load_params_from_file_overlays_matching_entries(tmp_path):
    mgr = CheckpointManager(tmp_path)
    src = mgr.save(tiny_state(1, steps=1, radar_in=5), epoch=1)  # radar linear differs
    over = mgr.save(tiny_state(2, steps=1), epoch=2)
    target = tiny_state(0)
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    mgr.load_params_from_file(target, src)
    got, want = target.model.state_dict(), tiny_state(1, steps=1, radar_in=5).model.state_dict()
    for k in got:
        assert torch.equal(got[k], before[k] if k == "radar_vfe.0.weight" else want[k]), k
    mgr.load_params_from_file(target, src, pretrained_overlay=over)
    assert torch.equal(target.model.radar_vfe[0].weight,
                       tiny_state(2, steps=1).model.radar_vfe[0].weight)
    assert target.optimizer.count == 0 and not target.model.vfe[0].weight.requires_grad


def test_duplicate_teacher_to_radar_copies_matching_shapes_only():
    from radardistill_tpu_torch.train.checkpoint import duplicate_teacher_to_radar

    sd = Tiny(1).state_dict()
    out = duplicate_teacher_to_radar(sd)
    for k in sd:
        twin = k.replace("radar_vfe", "vfe")
        same = k.startswith("radar_vfe") and k != "radar_vfe.0.weight"
        assert torch.equal(out[k], sd[twin] if same else sd[k]), k


def test_ckpt_surgery_tool(tmp_path):
    from tools.torch_ckpt_surgery import main

    src = CheckpointManager(tmp_path).save(tiny_state(1, steps=1), epoch=1)
    main(["--src", str(src), "--dst", str(tmp_path / "init")])
    got = torch.load(tmp_path / "init", weights_only=True)["model_state"]
    assert torch.equal(got["radar_vfe.1.running_mean"], got["vfe.1.running_mean"])
    assert torch.equal(got["radar_vfe.0.bias"], got["vfe.0.bias"])
    assert got["radar_vfe.0.weight"].shape == (4, 3)


# ------------------------------------------------------------------ trainer

class FakeLoader:
    class _Aug:
        def __init__(self):
            self.disabled = None

        def disable_augmentation(self, cfgs):
            self.disabled = cfgs["DISABLE_AUG_LIST"]

    class _DS:
        def __init__(self):
            self.data_augmentor = FakeLoader._Aug()

    def __init__(self, n_batches=3):
        self.n = n_batches
        self.dataset = self._DS()
        self.epochs_seen, self.start_iters = [], []
        self._skip = 0

    def set_epoch(self, e):
        self.epochs_seen.append(e)

    def set_start_iter(self, n):
        self.start_iters.append(n)
        self._skip = n

    def __len__(self):
        return self.n

    def __iter__(self):
        skip, self._skip = self._skip, 0
        for i in range(skip, self.n):
            yield {"x": np.full(2, i, np.float32)}, None


HOOK_CFG = ConfigDict(
    DATA_CONFIG=ConfigDict(DATA_AUGMENTOR=ConfigDict(
        DISABLE_AUG_LIST=["placeholder"],
        AUG_CONFIG_LIST=[{"NAME": "random_world_flip_distill", "ALONG_AXIS_LIST": ["x"]}],
    )),
    HOOK=ConfigDict(DisableAugmentationHook=ConfigDict(
        DISABLE_AUG_LIST=["random_world_flip_distill"], NUM_LAST_EPOCHS=1,
    )),
)


def stub_step(state, seen):
    def step(batch):
        seen.append(batch["x"])
        state.optimizer.count += 1
        return {"loss": torch.tensor(1.5), "as_overflow": torch.tensor(0, dtype=torch.int32)}

    return step


def test_train_model_hook_and_ckpts(tmp_path):
    from radardistill_tpu_torch.train.trainer import train_model

    state, seen, loader = tiny_state(0), [], FakeLoader()
    logger = logging.getLogger("test_train_model_hook_and_ckpts")
    out = train_model(stub_step(state, seen), state, loader, lr_sched=None, cfg=HOOK_CFG,
                      total_epochs=2, ckpt_dir=tmp_path, ckpt_save_interval=1,
                      max_ckpt_save_num=5, device="cpu", log_interval=1, logger=logger)
    assert len(seen) == 6 and out.step == 6  # 2 epochs x 3 batches
    assert all(isinstance(x, torch.Tensor) for x in seen)  # the prefetcher made tensors
    assert loader.epochs_seen == [0, 1]
    # hook fired on the last epoch only (2 - NUM_LAST_EPOCHS = 1)
    assert loader.dataset.data_augmentor.disabled == ["random_world_flip_distill"]
    assert (tmp_path / "checkpoint_epoch_1").exists()
    assert (tmp_path / "checkpoint_epoch_2").exists()
    assert not (tmp_path / "checkpoint_epoch_latest").exists()


def test_train_model_resumes_mid_epoch_and_saves_latest(tmp_path, caplog):
    """``start_it`` skips batches of the first epoch only; with a zero time
    interval ``latest`` is written after every step; the metrics of each
    logged step are read back and logged one step late, all of them."""
    from radardistill_tpu_torch.train.trainer import train_model

    state, seen, loader = tiny_state(0), [], FakeLoader()
    logger = logging.getLogger("test_train_model_resumes")
    logger.propagate = True
    with caplog.at_level(logging.INFO, logger="test_train_model_resumes"):
        train_model(stub_step(state, seen), state, loader, lr_sched=lambda s: 1e-3 * s,
                    cfg=ConfigDict(), total_epochs=2, ckpt_dir=tmp_path, start_epoch=0,
                    start_it=2, ckpt_save_time_interval=0.0, log_interval=1, logger=logger)
    assert loader.start_iters == [2]
    assert [float(x[0]) for x in seen] == [2.0, 0.0, 1.0, 2.0]
    payload = torch.load(tmp_path / "checkpoint_epoch_latest", weights_only=True)
    assert (payload["epoch"], payload["it"]) == (1, 4)
    lines = [r.getMessage() for r in caplog.records if "loss" in r.getMessage()]
    assert [ln.split(" lr")[0] for ln in lines] == [
        "epoch 0/2 it 0/3 loss 1.5000", "epoch 1/2 it 0/3 loss 1.5000",
        "epoch 1/2 it 1/3 loss 1.5000", "epoch 1/2 it 2/3 loss 1.5000"]
    assert "lr 3.000e-03" in lines[0]  # the global step after skipping 2


def test_train_model_matches_jax_trainer(tmp_path):
    """The same stub run through both trainers: the same steps, epochs, hook
    and per-epoch checkpoints."""
    import jax.numpy as jnp

    from radardistill_tpu.train.train_step import TrainState as JState
    from radardistill_tpu.train.trainer import train_model as j_train_model
    from radardistill_tpu_torch.train.trainer import train_model

    runs = {}
    for name in ("jax", "port"):
        loader, seen, out = FakeLoader(), [], tmp_path / name
        if name == "jax":
            def step(s, batch):
                seen.append(float(batch["x"][0]))
                return s.replace(step=s.step + 1), {"loss": jnp.asarray(1.0)}

            state = JState(step=jnp.asarray(0), params={"w": jnp.zeros(3)}, batch_stats={},
                           opt_state={})
            final = int(j_train_model(step, state, loader, None, HOOK_CFG, 3, out,
                                      ckpt_save_interval=2, start_it=1).step)
        else:
            state = tiny_state(0)
            step = stub_step(state, seen)
            final = train_model(lambda b: step(b), state, loader, None, HOOK_CFG, 3, out,
                                ckpt_save_interval=2, start_it=1).step
            seen[:] = [float(x[0]) for x in seen]
        runs[name] = (final, seen, loader.epochs_seen, loader.start_iters,
                      loader.dataset.data_augmentor.disabled,
                      sorted(p.name for p in out.iterdir()))
    assert runs["port"] == runs["jax"]
    assert runs["jax"][0] == 8 and runs["jax"][-1] == ["checkpoint_epoch_2", "checkpoint_epoch_3"]


# ---------------------------------------------------------------- eval loop

def test_eval_one_epoch_matches_jax():
    """Fixed-shape eval batches wrap the tail; both eval loops count each
    frame once in det_annos and in the recall counters
    (tests/test_trainer.py::test_eval_dedups_wrapped_samples), and feed the
    same outputs to their BEV similarity engines."""
    from radardistill_tpu.data.dataset import DatasetTemplate as JTemplate
    from radardistill_tpu.train.eval_utils import eval_one_epoch as j_eval_one_epoch
    from radardistill_tpu_torch.data.dataset import DatasetTemplate
    from radardistill_tpu_torch.train.eval_utils import eval_one_epoch

    rng = np.random.RandomState(0)

    def fake_batch(frame_ids):
        b = len(frame_ids)
        gt = np.zeros((b, 3, 10), np.float32)
        gt[:, :2, :3] = rng.uniform(-5, 5, (b, 2, 3))
        gt[:, :2, 3:6] = 2.0
        gt[:, :2, 9] = 1.0  # two valid GT per sample
        return {"gt_boxes": gt}, {"frame_id": list(frame_ids)}

    def outputs(batch):
        gt = np.asarray(batch["gt_boxes"])
        b = gt.shape[0]
        boxes = np.zeros((b, 4, 9), np.float32)
        boxes[:, :2, :7] = gt[:, :2, :7] + np.array([0.3, 0, 0, 0, 0, 0, 0], np.float32)
        valid = np.zeros((b, 4), bool)
        valid[:, :3] = True
        return {"boxes": boxes, "scores": np.full((b, 4), 0.9, np.float32),
                "labels": np.tile(np.array([1, 2, 1, 1]), (b, 1)), "valid": valid}

    batches = [fake_batch(["a", "b"]), fake_batch(["c", "d"]), fake_batch(["e", "a"])]

    class JDS:
        class_names = ["car", "truck"]
        generate_prediction_dicts = JTemplate.generate_prediction_dicts

    class DS(JDS):
        generate_prediction_dicts = DatasetTemplate.generate_prediction_dicts

    want = j_eval_one_epoch(lambda p, s, b: {"final_box_dicts": outputs(b)}, {}, {}, batches,
                            JDS(), thresh_list=(0.3, 0.5))
    tbatches = [({k: torch.from_numpy(v) for k, v in b.items()}, h) for b, h in batches]
    got = eval_one_epoch(
        lambda b: {"final_box_dicts": {k: torch.from_numpy(v) for k, v in outputs(b).items()}},
        tbatches, DS(), thresh_list=(0.3, 0.5), infer_time=True)
    assert [d["frame_id"] for d in got[0]] == ["a", "b", "c", "d", "e"]
    for g, w in zip(got[0], want[0]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    assert got[1] == want[1] and want[1]["gt"] == 10 and want[1]["recall_rcnn_0.3"] > 0
    assert got[2]["samples"] == want[2]["samples"] == 5 and got[2]["p50_ms"] > 0
    # BEV similarity engines see every batch's outputs in both loops and
    # accumulate the same class x class sums
    from radardistill_tpu.utils.similarity import BEVSimilarityEngine as JEngine
    from radardistill_tpu_torch.utils.similarity import BEVSimilarityEngine

    bev = {b["gt_boxes"].tobytes(): rng.randn(2, 16, 16, 4).astype(np.float32)
           for b, _ in batches}
    pcr = [-8.0, -8.0, -5.0, 8.0, 8.0, 3.0]
    engines = [JEngine("f", "f", ["car", "truck"], pcr), BEVSimilarityEngine(
        "f", "f", ["car", "truck"], pcr)]
    j_eval_one_epoch(lambda p, s, b: {"final_box_dicts": outputs(b),
                                      "f": bev[np.asarray(b["gt_boxes"]).tobytes()]},
                     {}, {}, batches, JDS(), similarity_engines=engines[:1])
    eval_one_epoch(
        lambda b: {"final_box_dicts": {k: torch.from_numpy(v) for k, v in outputs(b).items()},
                   "f": torch.from_numpy(bev[b["gt_boxes"].numpy().tobytes()])},
        tbatches, DS(), similarity_engines=engines[1:])
    want, got = engines[0].summary(), engines[1].summary()
    assert want["counts"].sum() == 6 * 2  # two GT a sample: 2 ordered pairs, 6 samples
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)


@pytest.mark.parametrize("tool", ["test", "torch_test"])
def test_eval_all_watcher(tmp_path, tool):
    """The port's ``repeat_eval_ckpt`` and the JAX tool's on one scenario: a
    recorded epoch skipped, an unloadable one retried, a late one evaluated,
    exit after the wait."""
    import importlib

    repeat_eval_ckpt = importlib.import_module(f"tools.{tool}").repeat_eval_ckpt
    (tmp_path / "rec.txt").write_text("1\n")
    epochs, clock, calls, tries = [1, 2, 4], [0.0], [], {}

    class Mgr:
        def list_epochs(self):
            return sorted(epochs)

    def sleep(dt):
        clock[0] += dt
        if clock[0] == 60.0:
            epochs.append(3)

    def restore(e):
        tries[e] = tries.get(e, 0) + 1
        return None if e == 4 and tries[e] == 1 else f"s{e}"

    done = repeat_eval_ckpt(Mgr(), tmp_path / "rec.txt", 2, restore,
                            lambda e, s: calls.append((e, s)), logging.getLogger("w"),
                            sleep=sleep, clock=lambda: clock[0])
    assert calls == [(2, "s2"), (4, "s4"), (3, "s3")]
    assert done == {1, 2, 3, 4} and (tmp_path / "rec.txt").read_text().split() == [
        "1", "2", "4", "3"]


# ------------------------------------------------------------------- common

def test_common_utilities_match_jax(monkeypatch):
    import random

    from radardistill_tpu.utils import common as jcommon
    from radardistill_tpu_torch.utils import common

    draws = []
    for mod in (jcommon, common):
        mod.set_random_seed(5)
        draws.append((random.random(), np.random.rand()))
        m = mod.AverageMeter()
        for v, n in ((1.0, 2), (4.0, 1)):
            m.update(v, n)
        draws.append((m.val, m.avg, m.sum, m.count))
    assert draws[0] == draws[2] and draws[1] == draws[3] == (4.0, 2.0, 6.0, 3)
    common.set_random_seed(5)
    a = torch.rand(3)
    torch.manual_seed(5)
    assert torch.equal(a, torch.rand(3))
    assert common.create_logger(rank=0).name == "radardistill_tpu_torch.rank0"
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert common.maybe_init_distributed() is False
    # torchrun's variables; the 2-process job of tests/test_torch_parallel.py
    # initializes through them
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert common.dist_env() == (2, 1, 1, 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert common.dist_env() == (2, 1, 1, 1)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no card"):
            common.maybe_init_distributed()


# ------------------------------------------------- train state and resume

def test_create_train_state_initializes_the_model():
    """From uninitialized memory to the reference's law: the same generator
    seed gives the same weights, BN statistics at 0 / 1, the frozen teacher
    without gradients and out of the optimizer."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.train_step import create_train_state
    from radardistill_tpu_torch.utils.production import TRAIN_YAML, production_cfg

    full, info = production_cfg(TRAIN_YAML, grid=64)
    states = []
    for _ in range(2):
        model = build_network(full.MODEL, info, device="cpu")
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(float("nan"))
        states.append(create_train_state(model, full.OPTIMIZATION, 10,
                                         torch.Generator().manual_seed(3))[0])
    a, b = (s.model.state_dict() for s in states)
    assert all(torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all() for k in a)
    assert all(torch.all(v == 0) for k, v in a.items() if k.endswith("running_mean"))
    trainable = {id(p) for p in states[0].optimizer.params}
    for name, p in states[0].model.named_parameters():
        assert p.requires_grad == (id(p) in trainable), name
        if name.split(".")[0] in states[0].model.frozen:
            assert not p.requires_grad, name
    assert states[0].step == 0


def test_resume_equals_three_steps_in_a_row(tmp_path):
    from radardistill_tpu_torch.data.loader import build_dataloader
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.models.detector import batch_to_torch
    from radardistill_tpu_torch.train.train_step import create_train_state, make_train_step

    cfg = ConfigDict()
    cfg_from_yaml_file(str(GRID128), cfg)
    train_set, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, 2, seed=1,
                                         model_cfg=cfg.MODEL)
    batches = []
    for e in (0, 1):
        loader.set_epoch(e)
        batches += [batch_to_torch(b, "cpu") for b, _ in loader]
    info = {"grid_size": (128, 128),
            "voxel_size": tuple(float(x) for x in train_set.voxel_size),
            "point_cloud_range": tuple(float(x) for x in train_set.point_cloud_range),
            "class_names": tuple(cfg.CLASS_NAMES)}

    def fresh(seed):
        model = build_network(cfg.MODEL, info, device="cpu")
        state, _ = create_train_state(model, cfg.OPTIMIZATION, 100,
                                      torch.Generator().manual_seed(seed))
        step = make_train_step(model, state.optimizer, cfg.MODEL, info["class_names"],
                               info["voxel_size"], info["point_cloud_range"])
        return state, step

    straight, step = fresh(7)
    losses = [step(b)["loss"] for b in batches[:3]]

    first, step = fresh(7)
    assert torch.equal(step(batches[0])["loss"], losses[0])
    mgr = CheckpointManager(tmp_path)
    mgr.save(first, epoch=0)
    resumed, step = fresh(8)  # other weights: the load must overwrite all of them
    assert mgr.restore(resumed) == (resumed, 0, 1) and resumed.step == 1
    resumed_losses = [step(b)["loss"] for b in batches[1:3]]
    assert all(torch.equal(a, b) for a, b in zip(resumed_losses, losses[1:]))
    assert_state_equal(resumed, straight)
    assert straight.step == 3 and torch.isfinite(losses[-1])
