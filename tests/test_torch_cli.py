"""The port's CLIs end to end on the CPU: ``tools/torch_train.py --device
cpu`` on ``production_cert_grid128.yaml`` (the shipped model and optimizer
at grid 128, ``SyntheticDataset``), one epoch of two steps at batch 2, then
``tools/torch_test.py --device cpu`` on its checkpoint, then
``--init_from_teacher`` from it; ``--sync_bn 0`` on one process; the flags
that are not ported raise. All run in this
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


@pytest.mark.parametrize("tool, flags", [
    ("torch_train", ["--profile_dir", "prof"]),
    ("torch_test", ["--bev_similarity", "spatial_features_2d"])])
def test_unported_flags_raise(tool, flags, tmp_path, monkeypatch):
    import importlib

    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 1[34]"):
        importlib.import_module(f"tools.{tool}").main(["--cfg_file", CFG, "--device", "cpu"]
                                                      + flags)
    assert not (tmp_path / "output").exists()
