"""The port's CLIs end to end on the CPU: ``tools/torch_train.py --device
cpu`` on ``production_cert_grid128.yaml`` (the shipped model and optimizer
at grid 128, ``SyntheticDataset``), one epoch of two steps at batch 2, then
``tools/torch_test.py --device cpu`` on its checkpoint, then
``--init_from_teacher`` from it; ``--sync_bn 0`` on one process;
``--profile_dir``, ``--bev_similarity`` and ``tools/torch_demo.py`` on
``pointpillar_smoke.yaml`` (the anchor family). All run in this
process from a temporary working directory, as a user runs them from the
repository root. The decode keeps 50 candidates a head instead of 500
(``--set``): its rotated-box NMS costs about 14 s a batch on one CPU thread
at 500 and is not what this test is about.
"""

from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG = str(REPO / "tools" / "cfgs" / "synthetic" / "production_cert_grid128.yaml")
FEWER = ["--set", "MODEL.RADAR_DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE", "50"]


def test_train_then_test_cli(tmp_path, monkeypatch):
    from radardistill_tpu_torch.train.trainer import read_log
    from tools import torch_test, torch_train

    monkeypatch.chdir(tmp_path)
    state = torch_train.main(["--cfg_file", CFG, "--device", "cpu", "--epochs", "1",
                              "--batch_size", "2", "--workers", "0", "--log_interval", "1",
                              "--num_epochs_to_eval", "0"] + FEWER)
    out = tmp_path / "output" / "production_cert_grid128" / "default"
    assert sorted(p.name for p in (out / "ckpt").iterdir()) == ["checkpoint_epoch_1"]
    assert state.step == 2 and next(state.model.parameters()).device.type == "cpu"
    (log,) = out.glob("log_train_*.txt")
    text = log.read_text()
    for line in ("device: cpu", "Start training", "epoch 0/1 it 0/2 loss",
                 "epoch 0/1 it 1/2 loss", "saved checkpoint_epoch_1", "Training done"):
        assert line in text, line
    rows = read_log(log)  # (epoch, epochs, it, steps an epoch, loss, t_iter, t_data)
    assert [r[:4] for r in rows] == [(0, 1, 0, 2), (0, 1, 1, 2)]
    assert all(abs(r[4]) < float("inf") and r[5] > 0 and r[6] >= 0 for r in rows)

    result = torch_test.main(["--cfg_file", CFG, "--device", "cpu", "--batch_size", "2",
                              "--infer_time"] + FEWER)
    assert set(result) == {"mAP"} and 0 <= result["mAP"] <= 1
    assert (out / "eval" / "eval_epoch_1" / "result.pkl").is_file()
    (log,) = (out / "eval").glob("log_eval_*.txt")
    text = log.read_text()
    for line in ("recall_rcnn_0.3", "inference p50", "Synthetic internal AP", "mAP:"):
        assert line in text, line

    # --init_from_teacher on that checkpoint: the radar twins take the teacher's
    # weights where the shapes match, the frozen teacher stays out of the optimizer
    ckpt = out / "ckpt" / "checkpoint_epoch_1"
    init = torch_train.main(["--cfg_file", CFG, "--device", "cpu", "--epochs", "1",
                             "--batch_size", "2", "--workers", "0", "--extra_tag", "init",
                             "--init_from_teacher", str(ckpt), "--num_epochs_to_eval", "0",
                             "--set", "DATA_CONFIG.NUM_SAMPLES", "2"])
    (log,) = (out.parent / "init").glob("log_train_*.txt")
    assert "duplicated teacher weights into radar branch" in log.read_text()
    trained = {id(p) for p in init.optimizer.params}
    assert all((id(p) in trained) == p.requires_grad for p in init.model.parameters())
    assert not any(p.requires_grad for p in init.model.dense_head.parameters())
    assert init.step == 1


def test_train_cli_sync_bn_0_trains_on_one_process(tmp_path, monkeypatch):
    """``--sync_bn 0`` (per-rank BN statistics) no longer raises: on one process
    it is the step of one process; tests/test_torch_parallel.py runs it on two."""
    from tools import torch_train

    monkeypatch.chdir(tmp_path)
    state = torch_train.main(["--cfg_file", CFG, "--device", "cpu", "--epochs", "1",
                              "--batch_size", "2", "--workers", "0", "--sync_bn", "0",
                              "--num_epochs_to_eval", "0", "--set", "DATA_CONFIG.NUM_SAMPLES",
                              "2"])
    assert state.step == 1
    assert (tmp_path / "output" / "production_cert_grid128" / "default" / "ckpt"
            / "checkpoint_epoch_1").exists()


def _pointpillar_yaml(tmp_path):
    """``tools/cfgs/synthetic/pointpillar_smoke.yaml`` (the anchor family)
    with two samples a split, under its own name."""
    text = (REPO / "tools" / "cfgs" / "synthetic" / "pointpillar_smoke.yaml").read_text()
    text = text.replace("    DATA_PATH: '.'\n", "    DATA_PATH: '.'\n    NUM_SAMPLES: 2\n")
    path = tmp_path / "cfg" / "pointpillar_smoke.yaml"
    path.parent.mkdir()
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("tool, flags", [
    ("torch_train", ["--profile_dir", "prof"]),
    ("torch_test", ["--bev_similarity", "spatial_features_2d", "--sim_pooling", "avg"])])
def test_unported_flags_raise(tool, flags, tmp_path, monkeypatch):
    """The two flags that once raised, on ``pointpillar_smoke.yaml``:
    ``tools/torch_train.py --profile_dir`` writes a trace of its steps before
    one epoch; ``tools/torch_test.py --bev_similarity`` on that checkpoint
    writes the class x class similarity CSVs beside the evaluation, and
    ``tools/torch_demo.py`` draws it."""
    from tools import torch_demo, torch_test, torch_train

    monkeypatch.chdir(tmp_path)
    cfg = _pointpillar_yaml(tmp_path)
    args = ["--cfg_file", cfg, "--device", "cpu"]
    state = torch_train.main(args + ["--epochs", "1", "--batch_size", "2", "--workers", "0",
                                     "--num_epochs_to_eval", "0"]
                             + (flags if tool == "torch_train" else []))
    out = tmp_path / "output" / "pointpillar_smoke" / "default"
    assert (out / "ckpt" / "checkpoint_epoch_1").is_file()
    (log,) = out.glob("log_train_*.txt")
    if tool == "torch_train":
        (trace,) = (tmp_path / "prof").iterdir()
        assert trace.suffix == ".json" and trace.stat().st_size > 1000
        assert "profiler trace of 3 steps written to prof" in log.read_text()
        assert state.step == 1 + 3 + 1  # the warm step, the traced ones, the epoch's
        return
    result = torch_test.main(args + ["--batch_size", "2"] + flags)
    assert set(result) == {"mAP"}
    sim = out / "eval" / "similarity" / "spatial_features_2d"
    assert sorted(p.name for p in sim.iterdir()) == [
        "cka_linear.csv", "cka_rbf.csv", "cosine.csv", "counts.csv"]
    assert (sim / "cosine.csv").read_text().startswith(",car,pedestrian\n")
    assert torch_demo.main(args + ["--ckpt_dir", str(out / "ckpt"), "--out", "demo.png"]) \
        == "demo.png" and (tmp_path / "demo.png").stat().st_size > 1000


def _dense_yaml(tmp_path, name):
    """``tools/cfgs/nuscenes_models/{name}.yaml``'s model and optimizer over
    the grid-128 synthetic data of ``production_cert_grid128.yaml``."""
    import json

    import yaml

    from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file

    data, model = ConfigDict(), ConfigDict()
    cfg_from_yaml_file(CFG, data)
    base = data.DATA_CONFIG.get("_BASE_CONFIG_")  # a base's base, left to the next load
    if base:
        data.DATA_CONFIG["_BASE_CONFIG_"] = str(REPO / "tools" / base)
    cfg_from_yaml_file(str(REPO / "tools" / "cfgs" / "nuscenes_models" / f"{name}.yaml"), model)
    cfg = {"CLASS_NAMES": model.CLASS_NAMES, "DATA_CONFIG": data.DATA_CONFIG,
           "MODEL": model.MODEL, "OPTIMIZATION": model.OPTIMIZATION}
    path = tmp_path / f"{name}_grid128.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return str(path)


def test_teacher_pretraining_then_test_teacher_and_radar_init_clis(tmp_path, monkeypatch):
    """Stage 1 of the recipe on the CPU: ``tools/torch_train.py`` trains the
    dense LiDAR teacher of ``pillarnet.yaml`` (2 steps; every backbone kernel
    moves), ``tools/torch_test_teacher.py`` evaluates its checkpoint, and
    ``pillarnet_radar.yaml`` takes it with ``--init_from_teacher``: every
    radar parameter with a teacher twin of its shape is copied (the backbone,
    neck and head; the radar VFE but its first linear)."""
    from radardistill_tpu_torch.models import build_network
    from radardistill_tpu_torch.train.checkpoint import init_radar_from_teacher
    from radardistill_tpu_torch.train.train_step import create_train_state
    from tools import torch_test_teacher, torch_train

    monkeypatch.chdir(tmp_path)
    teacher_yaml, radar_yaml = (_dense_yaml(tmp_path, n) for n in ("pillarnet", "pillarnet_radar"))
    fewer = ["--set", "MODEL.DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE", "50"]
    tcfg, rcfg = (torch_train.parse_config(["--cfg_file", y])[1] for y in (teacher_yaml,
                                                                           radar_yaml))
    info = {"grid_size": (128, 128), "voxel_size": (0.075, 0.075, 0.2),
            "point_cloud_range": (-4.8, -4.8, -5.0, 4.8, 4.8, 3.0),
            "class_names": tuple(tcfg.CLASS_NAMES)}
    init = build_network(tcfg.MODEL, info, device="cpu")
    state = torch_train.main(["--cfg_file", teacher_yaml, "--device", "cpu", "--epochs", "1",
                              "--batch_size", "2", "--workers", "0", "--num_epochs_to_eval", "0"]
                             + fewer)
    assert state.step == 2 and not state.model.frozen
    # the CLI's initial draw (--seed 666)
    create_train_state(init, tcfg.OPTIMIZATION, 1, torch.Generator().manual_seed(666))
    before = dict(init.named_parameters())
    kernels = [n for n, p in state.model.named_parameters()
               if n.startswith("backbone_3d.") and p.dim() >= 2]
    assert len(kernels) > 20
    assert not any(torch.equal(state.model.get_parameter(n), before[n]) for n in kernels)

    ckpt = tmp_path / "output" / "pillarnet_grid128" / "default" / "ckpt" / "checkpoint_epoch_1"
    result = torch_test_teacher.main(["--cfg_file", teacher_yaml, "--teacher_ckpt", str(ckpt),
                                      "--device", "cpu", "--batch_size", "2"] + fewer)
    assert 0 <= result["mAP"] <= 1
    out = tmp_path / "output" / "pillarnet_grid128" / "teacher" / "eval"
    assert (out / "eval_checkpoint_epoch_1" / "result.pkl").is_file()

    radar = build_network(rcfg.MODEL, info, device="cpu")
    n = init_radar_from_teacher(radar, torch.load(ckpt, weights_only=True)["model_state"])
    # the CMA has no twin, the VFE's first linear another width
    names = [k for k, _ in radar.named_parameters() if not k.startswith("radar_cma.")
             and k != "radar_vfe.pfn_0.linear.weight"]
    assert n == len(names) > 150 and not hasattr(radar, "backbone_3d")
    teacher = torch.load(ckpt, weights_only=True)["model_state"]
    twin = {"radar_neck": "backbone_2d"}
    for k in names:
        scope, rest = k.split(".", 1)
        assert torch.equal(radar.get_parameter(k),
                           teacher[f"{twin.get(scope, scope[len('radar_'):])}.{rest}"]), k
    state = torch_train.main(["--cfg_file", radar_yaml, "--device", "cpu", "--epochs", "1",
                              "--batch_size", "2", "--workers", "0", "--num_epochs_to_eval", "0",
                              "--init_from_teacher", str(ckpt), "--set",
                              "DATA_CONFIG.NUM_SAMPLES", "2"])
    (log,) = (tmp_path / "output" / "pillarnet_radar_grid128" / "default").glob("log_train_*")
    assert f"duplicated teacher weights into radar branch ({n} parameters)" in log.read_text()
    assert state.step == 1
