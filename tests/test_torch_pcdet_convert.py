"""The port's reference-checkpoint import against the JAX package, CPU.

``radardistill_tpu_torch.pcdet_convert`` maps a pcdet ``model_state`` straight
to the port's ``state_dict``; the JAX side reaches the same place by
composition: ``tools/convert_torch_ckpt.py``'s ``Converter`` makes the flax
tree, ``convert.state_dict_from_jax`` the ``state_dict``. On the synthetic
full-width pcdet state dict (``utils/testing.py::reference_state_dict``, held
equal to ``tests/test_convert.py``'s) the two agree key for key and bit for bit,
unmapped keys included, and spconv 1.x weights convert as 2.x ones do.
``tools/torch_convert_ckpt.py`` is driven through ``main(argv)``: its file
loads through ``CheckpointManager.load_params_from_file`` and the train and
eval CLIs, and supplies every entry of the ``make_model_cfg`` model and of the
four shipped yamls' models. The slice: the JAX model's eval forward on the
Converter's tree against the port model loaded from the tool's file, with
fan-in-scaled values, float32; features and predictions rel-L2 <= 1e-4
(float32 summation order over ~60 layers), detections by the near-tie rule of
``tests/test_torch_slice.py``.
"""

import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from radardistill_tpu_torch.convert import state_dict_from_jax
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.pcdet_convert import pcdet_convert
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.train_step import TrainState
from radardistill_tpu_torch.utils.production import production_cfg
from radardistill_tpu_torch.utils.testing import make_model_cfg, reference_state_dict
from tests.test_convert import reference_state_dict as jax_reference_state_dict
from tests.test_torch_slice import _rel_l2, assert_same_detections
from tools import convert_torch_ckpt, torch_convert_ckpt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GRID = 96  # tests/test_e2e.py's
SHIPPED = ("radar_distill/radar_distill_train.yaml", "radar_distill/radar_distill_val.yaml",
           "nuscenes_models/pillarnet.yaml", "nuscenes_models/pillarnet_radar.yaml")
FEATURES = ("x_conv4", "x_conv5", "spatial_features_2d", "radar_x_conv4",
            "radar_spatial_features_2d")
PREDS = ("center", "center_z", "dim", "rot", "vel", "iou", "hm")


def _model_cfg():
    return make_model_cfg(grid=GRID, num_max_objs=32, k_per_head=64, nms_post=16)


def _with_foreign_keys(sd):
    """Keys outside the JAX tool's tables: another module, a third conv in one
    subhead (stashed, never stacked), a ReLU's index in a neck block."""
    rng = np.random.RandomState(5)
    return {**sd, "roi_head.shared_fc_layer.0.weight": rng.randn(8, 4).astype(np.float32),
            "dense_head.heads_list.0.hm.2.weight": rng.randn(2, 64, 3, 3).astype(np.float32),
            "radar_backbone_2d.blocks.0.3.weight": rng.randn(4).astype(np.float32)}


def _composition(sd, model):
    params, stats, unmapped = convert_torch_ckpt.Converter().convert(sd)
    return state_dict_from_jax(model, {"params": params, "batch_stats": stats}), unmapped


def _assert_bit_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, (k, got[k].shape, v.shape)
        assert got[k].is_contiguous() and torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def port_model():
    cfg, info = _model_cfg()
    return build_network(cfg, info, device="cpu")


@pytest.fixture(scope="module")
def reference():
    return reference_state_dict(np.random.RandomState(0))


def test_reference_state_dict_is_the_jax_tests(reference):
    got = reference
    want = jax_reference_state_dict(np.random.RandomState(0))
    assert list(got) == list(want) and len(got) == 1380
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and np.array_equal(got[k], v), k
    fan = reference_state_dict(np.random.RandomState(0), scale="fan_in")
    assert list(fan) == list(want)
    assert all(fan[k].dtype == v.dtype and fan[k].shape == v.shape for k, v in want.items())
    w = fan["backbone_3d.conv5.1.conv1.weight"]  # (256, 256, 3, 3), fan in 2304
    assert abs(float(w.std()) * np.sqrt(2304) - 1) < 0.01
    assert 0.9 <= fan["backbone_3d.conv5.1.bn1.running_var"].min()
    assert fan["backbone_3d.conv5.1.bn1.running_var"].max() < 1.1
    with pytest.raises(ValueError):
        reference_state_dict(np.random.RandomState(0), scale="unit")


@pytest.mark.parametrize("foreign", [False, True], ids=["reference", "foreign-keys"])
def test_pcdet_convert_is_the_jax_composition(port_model, reference, foreign):
    sd = _with_foreign_keys(reference) if foreign else reference
    got, unmapped = pcdet_convert(sd)
    want, want_unmapped = _composition(sd, port_model)
    _assert_bit_equal(got, want)
    assert unmapped == want_unmapped
    assert unmapped == (["roi_head.shared_fc_layer.0.weight",
                         "radar_backbone_2d.blocks.0.3.weight"] if foreign else [])
    assert set(got) == set(port_model.state_dict())
    # the layouts the module docstring names
    assert tuple(got["radar_backbone_3d.conv1_0.conv1.conv.kernel"].shape) == (3, 3, 32, 32)
    assert tuple(got["backbone_3d.conv3_0.conv1.conv.weight"].shape) == (128, 128, 3, 3)
    assert tuple(got["radar_cma.encoder_1_0.down_weight"].shape) == (3, 3, 256, 256)
    hm = got["dense_head.hm.conv_out.weight"]  # 6 heads x max_cls 2, head 0 padded
    assert tuple(hm.shape) == (12, 64, 3, 3) and not hm[1].any()
    np.testing.assert_array_equal(hm[0].numpy(), sd["dense_head.heads_list.0.hm.1.weight"][0])
    np.testing.assert_array_equal(got["backbone_3d.conv2_1.conv2.conv.weight"].numpy(),
                                  sd["backbone_3d.conv2.2.conv2.weight"].transpose(0, 3, 1, 2))


def test_spconv_1x_converts_like_2x(reference):
    sd = reference
    spconv = [k for k in sd if k.split(".")[0].endswith("backbone_3d")
              and k.split(".")[1] in ("conv1", "conv2", "conv3", "conv4") and sd[k].ndim == 4]
    assert len(spconv) == 2 * (4 + 3 * 5)
    v1 = {k: v.transpose(1, 2, 3, 0) if k in spconv else v for k, v in sd.items()}  # (kH, kW, I, O)
    got, unmapped = pcdet_convert(v1)
    want, _ = pcdet_convert(sd)
    assert unmapped == []
    _assert_bit_equal(got, want)
    # torch tensors in, as torch.load gives them, convert as numpy arrays do
    as_torch, _ = pcdet_convert({k: torch.from_numpy(np.asarray(v)) for k, v in v1.items()})
    _assert_bit_equal(as_torch, want)


def _write_pcdet(path, sd, bare=False, epoch=7):
    """``sd`` as the reference's train_utils.save_checkpoint writes it, or as a
    bare state dict."""
    model_state = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save(model_state if bare else {"model_state": model_state, "optimizer_state": None,
                                         "epoch": epoch, "it": 1234, "version": "pcdet+0.6.0"},
               path)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The fan-in-scaled reference state dict as a pcdet-format file, the
    tool's conversion of it, and that state dict. Each file is 160 MB, so the
    module removes them when it is done."""
    tmp = tmp_path_factory.mktemp("pcdet")
    sd = reference_state_dict(np.random.RandomState(0), scale="fan_in")
    _write_pcdet(tmp / "ref.pth", sd)
    torch_convert_ckpt.main(["--src", str(tmp / "ref.pth"), "--dst", str(tmp / "converted.pth")])
    yield tmp / "converted.pth", sd
    shutil.rmtree(tmp)


@pytest.mark.parametrize("bare", [False, True], ids=["pcdet-format", "bare-state-dict"])
def test_tool_writes_the_ports_checkpoint(tmp_path, capsys, bare, port_model, converted):
    path, sd = converted
    src, out = path.parent / "ref.pth", tmp_path / "out.pth"
    if bare:
        src = tmp_path / "bare.pth"
        _write_pcdet(src, sd, bare=True)
    try:
        torch_convert_ckpt.main(["--src", str(src), "--dst", str(out)])
        assert capsys.readouterr().out.splitlines() == [
            "mapped 1380/1380 tensors", f"wrote {out}"]
        # no temporary file left beside the output
        assert sorted(os.listdir(tmp_path)) == ["bare.pth", "out.pth"] if bare else ["out.pth"]
        payload = torch.load(out, map_location="cpu", weights_only=True)
        assert {k: v for k, v in payload.items() if k != "model_state"} == {
            "optimizer_state": {}, "epoch": 0 if bare else 7, "it": 0, "version": "converted"}
        _assert_bit_equal(payload["model_state"], pcdet_convert(sd)[0])

        state = CheckpointManager(tmp_path / "ckpt").load_params_from_file(
            TrainState(port_model, None), out)
        assert state.loaded == len(port_model.state_dict()) == 652
        assert all(torch.equal(v, payload["model_state"][k])
                   for k, v in port_model.state_dict().items())
    finally:
        shutil.rmtree(tmp_path)


def test_report_only_writes_nothing_and_prints_the_jax_tools_lines(tmp_path, capsys,
                                                                   monkeypatch, reference):
    """On the LiDAR VFE, the first task head and the foreign keys (a small
    file)."""
    sd = _with_foreign_keys({k: v for k, v in reference.items()
                             if k.startswith(("vfe.", "dense_head.heads_list.0."))})
    _write_pcdet(tmp_path / "ref.pth", sd)
    argv = ["--src", str(tmp_path / "ref.pth"), "--dst", str(tmp_path / "out"), "--report_only"]
    torch_convert_ckpt.main(argv)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["convert_torch_ckpt.py"] + argv)
    convert_torch_ckpt.main()
    assert got == capsys.readouterr().out
    assert got.splitlines() == ["mapped 70/72 tensors",
                                "  unmapped: roi_head.shared_fc_layer.0.weight",
                                "  unmapped: radar_backbone_2d.blocks.0.3.weight"]
    assert os.listdir(tmp_path) == ["ref.pth"]


@pytest.mark.parametrize("yaml", SHIPPED)
def test_converted_file_covers_the_shipped_models(converted, yaml):
    """Every parameter and buffer of each shipped yaml's model comes from the
    file (the JAX tool covers them all too: their flax trees hold no path the
    ``make_model_cfg`` model lacks)."""
    path, _ = converted
    full, info = production_cfg(os.path.join("..", yaml))  # relative to radar_distill/
    model = build_network(full.MODEL, info, device="cpu")
    state = CheckpointManager(path.parent / "ckpt").load_params_from_file(
        TrainState(model, None), path)
    want = {"radar_distill/radar_distill_train.yaml": 652,
            "radar_distill/radar_distill_val.yaml": 380,
            "nuscenes_models/pillarnet.yaml": 272, "nuscenes_models/pillarnet_radar.yaml": 380}
    assert state.loaded == len(model.state_dict()) == want[yaml]


@pytest.fixture(scope="module")
def slice_run(converted):
    import jax.numpy as jnp

    from radardistill_tpu.models import build_network as jax_build_network
    from tests.test_e2e import make_batch

    path, sd = converted
    cfg, info = _model_cfg()
    params, stats, unmapped = convert_torch_ckpt.Converter().convert(sd)
    assert unmapped == []
    jbatch = make_batch()
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    jout = jax.tree.map(np.asarray, jax.jit(lambda v, b: jmodel.apply(v, b, False))(
        {"params": params, "batch_stats": stats}, jbatch))

    model = build_network(cfg, info, device="cpu")
    state = CheckpointManager(path.parent / "ckpt").load_params_from_file(
        TrainState(model, None), path)
    assert state.loaded == len(model.state_dict())
    with torch.no_grad():
        tout = model(batch_to_torch({k: np.array(v) for k, v in jbatch.items()}, "cpu"))
    return jout, tout


def test_converted_slice_matches_jax(slice_run):
    jout, tout = slice_run
    errs = {k: _rel_l2(tout[k].numpy(), jout[k]) for k in FEATURES}
    for branch in ("lidar_preds", "radar_preds"):
        for k in PREDS:
            assert tout[branch][k].shape == jout[branch][k].shape
            errs[f"{branch}.{k}"] = _rel_l2(tout[branch][k].numpy(), jout[branch][k])
    assert all(np.isfinite(v) and v <= 1e-4 for v in errs.values()), errs
    assert all(np.abs(jout[k]).max() > 0 for k in FEATURES)
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    want = jout["final_box_dicts"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    scored = lambda d: dict(d, valid=d["valid"] & (d["scores"] > 1e-6))  # noqa: E731
    assert scored(want)["valid"].sum() > 0
    assert_same_detections(scored(got), scored(want), tol=1e-4)


def test_train_and_eval_clis_load_the_converted_file(converted, tmp_path, monkeypatch):
    """``tools/torch_train.py --pretrained_model`` and ``tools/torch_test.py
    --ckpt`` on the shipped train yaml at grid 128 (synthetic set, one step,
    one batch; the decode keeps 50 candidates a head, as tests/test_torch_cli.py
    says why): each loads every entry of its model from the converted file."""
    from tools import torch_test, torch_train

    path, _ = converted
    monkeypatch.chdir(tmp_path)
    cfg = str(REPO / "tools" / "cfgs" / "synthetic" / "production_cert_grid128.yaml")
    common = ["--cfg_file", cfg, "--device", "cpu", "--batch_size", "2"]
    few = ["--set", "DATA_CONFIG.NUM_SAMPLES", "2",
           "MODEL.RADAR_DENSE_HEAD.POST_PROCESSING.MAX_OBJ_PER_SAMPLE", "50"]
    try:
        state = torch_train.main(common + ["--epochs", "1", "--workers", "0",
                                           "--num_epochs_to_eval", "0", "--pretrained_model",
                                           str(path)] + few)
        assert state.step == 1 and state.loaded == len(state.model.state_dict()) == 652
        result = torch_test.main(common + ["--ckpt", str(path)] + few)
        assert 0 <= result["mAP"] <= 1
        (log,) = (tmp_path / "output" / "production_cert_grid128" / "default" / "eval").glob(
            "log_eval_*.txt")
        assert f"loaded 652 of 652 model entries from {path}" in log.read_text()
    finally:
        shutil.rmtree(tmp_path / "output", ignore_errors=True)  # a 350 MB checkpoint
