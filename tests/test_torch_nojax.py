"""The port runs without the JAX package: a fresh interpreter imports
``radardistill_tpu_torch``, builds the synthetic batches and drives both
forwards (radar-only val at grid 256, the distillation forward at grid 128,
and at grid 64 under each deep-chain configuration of the teacher: ``INT8_STAGES: 5``,
``FP_STAGES: 5``, ``INT8: true``, and the wide conv once)
and one distillation train step, two train steps through ``tools/torch_train.py``
on the grid-128 yaml and ``tools/torch_ckpt_surgery.py`` on its checkpoint,
a synthetic reference pcdet checkpoint through ``tools/torch_convert_ckpt.py``
into the distillation model,
a val forward without host tables under
``DENSE_FROM: 3``, the dense-input route of ``synthetic/smoke.yaml`` at grid
64 and the plain versions of the three probe kernels on the CPU
with random weights from a seeded generator, and the JAX checkpoint fixture
(``tests/fixtures/jax_run``) restored into the distillation model and its
optimizer; afterwards neither ``jax`` nor ``flax`` nor ``orbax``,
``tensorstore``, ``zstandard``, ``optax`` nor any module of
``radardistill_tpu`` may be in ``sys.modules``. An AST walk over every file of the port and over the card
scripts finds no import of them either (the nuScenes and data-parallel modules
among them), also after a nuScenes item and a detection gather; neither the
port nor its card scripts import a JAX tool (``tools.convert_torch_ckpt``, any
``tools`` module without ``torch_`` in its name). Also: the port's data layer
loads none of its model layer, and ``chip_smoke.py`` copied out of the repo
fails without printing a result."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the port, its card scripts and its tools may not import: JAX, the JAX
# package, and what reads or writes the JAX package's checkpoints
FOREIGN = {"jax", "jaxlib", "flax", "radardistill_tpu", "orbax", "tensorstore", "zstandard",
           "optax"}

SCRIPT = r"""
import json, sys
import torch
torch.set_num_threads(1)  # beside the other test workers, as they run
from radardistill_tpu_torch.data.synthetic import make_batch
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.models.layers import init_random_
from radardistill_tpu_torch.utils.production import TRAIN_YAML

cfg, info, batch = make_batch(grid=256)
model = init_random_(build_network(cfg, info, device="cpu"), torch.Generator().manual_seed(0))
out = model(batch_to_torch(batch, "cpu"))
fin = out["final_box_dicts"]
cfg2, info2, batch2 = make_batch(TRAIN_YAML, grid=128, num_lidar=4000, num_radar=300, num_boxes=10)
model2 = init_random_(build_network(cfg2, info2, device="cpu"), torch.Generator().manual_seed(0))
out2 = model2(batch_to_torch(batch2, "cpu"))
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import make_train_step
from radardistill_tpu_torch.utils.production import production_cfg
full2, _ = production_cfg(TRAIN_YAML, grid=128)
opt, _ = build_optimizer(full2.OPTIMIZATION, model2, 100, model2.frozen)
metrics = make_train_step(model2, opt, cfg2, info2["class_names"], info2["voxel_size"],
                          info2["point_cloud_range"])(batch_to_torch(batch2, "cpu"))
chains = {}
for over in ({"INT8_STAGES": 5}, {"INT8_STAGES": 1, "FP_STAGES": 5}, {"INT8": True}):
    cfg3, info3, batch3 = make_batch(TRAIN_YAML, grid=64, num_lidar=1500, num_radar=100,
                                     num_boxes=5, backbone_3d=over)
    model3 = init_random_(build_network(cfg3, info3, device="cpu"), torch.Generator().manual_seed(0))
    out3 = model3(batch_to_torch(batch3, "cpu"))
    chains[json.dumps(over)] = bool(torch.isfinite(out3["x_conv5"]).all()
                                    and torch.isfinite(out3["lidar_preds"]["hm"]).all()
                                    and out3["x_conv5"].abs().max() > 0)
from radardistill_tpu_torch.ops.wide_conv import conv3x3_wide
wide = conv3x3_wide(torch.ones(1, 4, 4, 8), torch.ones(3, 3, 8, 8))
# no host tables: the device builds them; DENSE_FROM 3 runs stages 3-4 masked-dense
cfg4, info4, batch4 = make_batch(grid=128, num_radar=600, host_precompute=False,
                                 radar_backbone_3d={"DENSE_FROM": 3})
model4 = init_random_(build_network(cfg4, info4, device="cpu"), torch.Generator().manual_seed(0))
out4 = model4(batch_to_torch(batch4, "cpu"))
from radardistill_tpu_torch.ops.expand import gather_rows_windowed
from radardistill_tpu_torch.ops.probes import conv_probe, mma_rate
rows, over = gather_rows_windowed(torch.ones(600, 4), torch.arange(512, dtype=torch.int32), 1)
dots = conv_probe(torch.ones(1, 4, 4, 8), torch.ones(9, 8, 8), "dots")
rate = mma_rate(torch.ones(4, 8), torch.ones(8, 4), reps=2)
# the CLIs: two train steps on the grid-128 yaml, a checkpoint, the surgery
import os, tempfile
os.chdir(tempfile.mkdtemp())
from tools import torch_ckpt_surgery, torch_train
cli_state = torch_train.main([
    "--cfg_file", os.path.join(sys.argv[1], "tools/cfgs/synthetic/production_cert_grid128.yaml"),
    "--device", "cpu", "--epochs", "1", "--batch_size", "2", "--workers", "0",
    "--num_epochs_to_eval", "0"])
torch_ckpt_surgery.main(["--src", "output/production_cert_grid128/default/ckpt/checkpoint_epoch_1",
                         "--dst", "init"])
# a reference pcdet checkpoint through tools/torch_convert_ckpt.py, loaded
import numpy as np
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.train_step import TrainState
from radardistill_tpu_torch.utils.testing import reference_state_dict
from tools import torch_convert_ckpt
torch.save({"model_state": {k: torch.from_numpy(np.asarray(v)) for k, v in reference_state_dict(
    np.random.RandomState(0), scale="fan_in").items()}, "epoch": 3}, "ref.pth")
torch_convert_ckpt.main(["--src", "ref.pth", "--dst", "converted.pth"])
pcdet = CheckpointManager("ckpt").load_params_from_file(TrainState(model2, None), "converted.pth")
for f in ("ref.pth", "converted.pth"):  # 160 MB each
    os.remove(f)
# the JAX package's checkpoint fixture: the newest epoch, model and optimizer
jax_opt, _ = build_optimizer(full2.OPTIMIZATION, model2, 100, model2.frozen)
jax_run = CheckpointManager(os.path.join(sys.argv[1], "tests/fixtures/jax_run")).restore(
    TrainState(model2, jax_opt))
# a nuScenes item (a key frame without sweeps, one radar channel in binary
# .pcd) and a detection gather (one process: the identity)
import pickle
from pathlib import Path
import numpy as np
from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.data.loader import DATASETS
from radardistill_tpu_torch.parallel.multihost import gather_detections
root = Path(tempfile.mkdtemp())
(root / "samples").mkdir()
np.random.RandomState(0).uniform(-5, 5, (64, 5)).astype(np.float32).tofile(root / "samples/l.bin")
fields = ("x y z dyn_prop id rcs vx vy vx_comp vy_comp is_quality_valid ambig_state "
          "x_rms y_rms invalid_state pdh0 vx_rms vy_rms").split()
header = "\n".join(["VERSION 0.7", "FIELDS " + " ".join(fields), "SIZE " + " ".join(["4"] * 18),
                    "TYPE " + " ".join(["F"] * 18), "COUNT " + " ".join(["1"] * 18),
                    "WIDTH 7", "HEIGHT 1", "POINTS 7", "DATA binary", ""])
(root / "samples/r.pcd").write_bytes(header.encode() + np.ones((7, 18), np.float32).tobytes())
pickle.dump([{"lidar_path": "samples/l.bin", "token": "t0", "sweeps": [], "radars": {
    "RADAR_FRONT": [{"data_path": "samples/r.pcd", "timestamp": 0,
                     "sensor2lidar_rotation": np.eye(3), "sensor2lidar_translation": np.zeros(3)}]},
    "gt_boxes": np.zeros((1, 9), np.float32), "gt_names": np.array(["car"]),
    "num_lidar_pts": np.array([5]), "num_radar_pts": np.array([1])}], open(root / "val.pkl", "wb"))
nds = DATASETS["NuScenesDataset_Distill"](
    ConfigDict(DATA_PATH=str(root), INFO_PATH={"test": ["val.pkl"]},
               POINT_CLOUD_RANGE=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]), ["car"], training=False)
nitem = nds[0]
merged = gather_detections([{"frame_id": "f0"}])
# the dense-input route: smoke.yaml's dense teacher and dense radar branch
from radardistill_tpu_torch.config import cfg_from_yaml_file
from radardistill_tpu_torch.data.collate import collate_batch
from radardistill_tpu_torch.data.synthetic import make_scene
smoke = ConfigDict()
cfg_from_yaml_file(os.path.join(sys.argv[1], "tools/cfgs/synthetic/smoke.yaml"), smoke)
info5 = {"grid_size": (64, 64), "voxel_size": (0.075, 0.075, 0.2),
         "point_cloud_range": (-2.4, -2.4, -5.0, 2.4, 2.4, 3.0),
         "class_names": tuple(smoke.CLASS_NAMES)}
model5 = init_random_(build_network(smoke.MODEL, info5, device="cpu"),
                      torch.Generator().manual_seed(0))
batch5 = collate_batch([make_scene(0, num_lidar=500, num_radar=50, num_boxes=3,
                                   pc_range=info5["point_cloud_range"])],
                       {"MAX_LIDAR_POINTS": 512, "MAX_RADAR_POINTS": 64, "NUM_MAX_OBJS": 8})
batch5.pop("_host", None)
out5 = model5(batch_to_torch(batch5, "cpu"))
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "radardistill_tpu", "orbax",
                                        "tensorstore", "zstandard", "optax"))
print(json.dumps({
    "foreign": foreign,
    "finite": bool(all(torch.isfinite(v).all() for v in out["radar_preds"].values())),
    "hm_shape": list(out["radar_preds"]["hm"].shape),
    "boxes_shape": list(fin["boxes"].shape),
    "n_valid": int(fin["valid"].sum()),
    "as_overflow": int(out["as_overflow"]),
    "teacher_finite": bool(all(torch.isfinite(v).all() for v in out2["lidar_preds"].values())
                           and torch.isfinite(out2["x_conv4"]).all()),
    "teacher_hm_shape": list(out2["lidar_preds"]["hm"].shape),
    "int8_mode": cfg2["BACKBONE_3D"]["INT8"],
    "as_overflow2": int(out2["as_overflow"]),
    "chains": chains,
    "wide_corner": float(wide[0, 0, 0, 0]),
    "raw_batch_keys": sorted(k for k in batch4 if k.startswith("hp_")),
    "raw_finite": bool(all(torch.isfinite(v).all() for v in out4["radar_preds"].values())),
    "raw_overflow": int(out4["as_overflow"]),
    "probes": [float(rows.sum()), int(over), float(dots[0, 0, 0, 0]), float(rate[0, 0])],
    "train_loss_finite": bool(torch.isfinite(metrics["loss"])),
    "train_updates": opt.count,
    "cli_steps": cli_state.step,
    "cli_files": sorted(os.listdir("output/production_cert_grid128/default/ckpt")) + [
        f for f in os.listdir(".") if f == "init"],
    "pcdet_loaded": [pcdet.loaded, len(model2.state_dict())],
    "jax_run": [jax_run[1], jax_run[2], jax_opt.count, len(jax_opt.inner.state)],
    "nusc": [list(nitem["points"].shape), list(nitem["radar_points"].shape), nitem["frame_id"]],
    "merged": merged,
    "dense": [bool(torch.isfinite(out5["x_conv5"]).all()
                   and torch.isfinite(out5["radar_preds"]["hm"]).all()),
              type(model5.backbone_3d).__name__, "as_overflow" in out5],
}))
"""


def test_port_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT, REPO], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["foreign"] == []
    assert rec["finite"]
    assert rec["hm_shape"] == [1, 32, 32, 6, 2]
    assert rec["boxes_shape"] == [1, 6 * 83, 9]
    assert rec["n_valid"] > 0
    assert rec["as_overflow"] == 0
    assert rec["teacher_finite"] and rec["teacher_hm_shape"] == [2, 16, 16, 6, 2]
    assert rec["int8_mode"] == "static" and rec["as_overflow2"] == 0
    assert rec["train_loss_finite"] and rec["train_updates"] == 1
    assert rec["cli_steps"] == 2 and rec["cli_files"] == ["checkpoint_epoch_1", "init"]
    assert rec["pcdet_loaded"] == [652, 652]
    assert rec["jax_run"] == [2, 104, 104, 273]  # epoch, it, step, parameters with moments
    assert len(rec["chains"]) == 3 and all(rec["chains"].values()), rec["chains"]
    assert rec["wide_corner"] == 4 * 8.0
    assert rec["raw_batch_keys"] == [] and rec["raw_finite"] and rec["raw_overflow"] == 0
    # 512 rows of 4 ones, no overflow; 9 taps x 8 channels; (1 + 2) x 8
    assert rec["probes"] == [2048.0, 0, 72.0, 24.0]
    # 64 lidar points (x, y, z, intensity, time lag); 7 radar returns, 6 features
    assert rec["nusc"][0][1] == 5 and 0 < rec["nusc"][0][0] <= 64
    assert rec["nusc"][1:] == [[7, 6], "l"] and rec["merged"] == [{"frame_id": "f0"}]
    assert rec["dense"] == [True, "PillarRes18BackBone8x", False]


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "radardistill_tpu_torch", "**", "*.py"), recursive=True))


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/torch_profile_slice.py",
                                    "tools/torch_mma_rate.py", "tools/torch_conv_probe.py",
                                    "tools/torch_conv_block_ab.py",
                                    "tools/torch_fp_teacher_rel.py",
                                    "tools/torch_gather_ab.py", "tools/torch_train.py",
                                    "tools/torch_test.py", "tools/torch_ckpt_surgery.py",
                                    "tools/torch_train_pace.py", "tools/torch_ddp_check.py",
                                    "tools/torch_overfit_check.py",
                                    "tools/torch_quality_gate.py", "tools/torch_demo.py",
                                    "tools/torch_calc_caps.py", "tools/torch_convert_ckpt.py",
                                    "tools/torch_jax_ckpt_read.py"])
def test_card_scripts_import_only_torch_and_the_port(script):
    names = _imported_modules(os.path.join(REPO, script))
    roots = {n.split(".")[0] for n in names}
    assert {"torch", "radardistill_tpu_torch"} & roots
    assert not roots & (FOREIGN | {"chip_smoke"}), names


def test_teacher_eval_tool_imports_only_the_ports_eval_cli():
    """``tools/torch_test_teacher.py`` is ``tools/torch_test.py`` with the
    teacher's yaml and checkpoint; it imports nothing else of note."""
    path = os.path.join(REPO, "tools/torch_test_teacher.py")
    froms = {(node.module, a.name) for node in ast.walk(ast.parse(open(path).read()))
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert ("tools", "torch_test") in froms, froms
    names = _imported_modules(path)
    assert not {n.split(".")[0] for n in names} & FOREIGN


def test_the_walk_covers_the_nuscenes_and_parallel_modules():
    """And the modules of the anchor family, the tile-sparse backbone and the
    tools' utilities."""
    for mod in ("data/nuscenes/pcd", "data/nuscenes/dataset", "data/nuscenes/info_gen",
                "data/nuscenes/eval_bridge", "parallel/mesh", "parallel/multihost",
                "utils/testing", "models/anchor_head", "models/anchor_detector",
                "models/map_to_bev", "models/backbone_tile_sparse", "ops/tile_sparse",
                "utils/similarity", "utils/profiler", "utils/remat", "pcdet_convert",
                "train/jax_ckpt"):
        assert f"radardistill_tpu_torch/{mod}.py" in PORT_FILES, mod


def _tools_imported(path):
    """The ``tools`` modules ``path`` imports, as ``import tools.x``, ``from
    tools.x import ...`` or ``from tools import x``."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names if a.name.startswith("tools."))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module == "tools":
                out.update(f"tools.{a.name}" for a in node.names)
            elif node.module.startswith("tools."):
                out.add(node.module)
    return out


def test_the_port_imports_no_jax_tool():
    """No file of the port, no ``tools/torch_*.py`` and not ``chip_smoke.py``
    imports ``tools.convert_torch_ckpt`` or any other ``tools`` module whose
    name lacks ``torch_`` (those are the JAX package's tools)."""
    scripts = PORT_FILES + sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tools", "torch_*.py"))) + ["chip_smoke.py"]
    assert "tools/torch_convert_ckpt.py" in scripts
    seen = set()
    for rel in scripts:
        names = _tools_imported(os.path.join(REPO, rel))
        seen |= names
        assert not [n for n in names if not n.split(".")[1].startswith("torch_")], (rel, names)
    assert "tools.torch_convert_ckpt" in seen and "tools.torch_train" in seen


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    """Every ``.py`` of the port: no import of jax, flax, radardistill_tpu,
    orbax, tensorstore, zstandard or optax, absolute or spelled through
    ``importlib``/``__import__`` with a literal."""
    assert len(PORT_FILES) > 25
    for rel in PORT_FILES:
        path = os.path.join(REPO, rel)
        roots = {n.split(".")[0] for n in _imported_modules(path)}
        assert not roots & FOREIGN, (rel, roots)
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", "")) in ("import_module", "__import__"):
                lits = [a.value for a in node.args if isinstance(a, ast.Constant)]
                assert not any(str(v).split(".")[0] in FOREIGN for v in lits), (rel, lits)


def test_port_builds_no_library_inside_the_jax_package():
    """The port's host_ops builds under build/, beside the CUDA kernels."""
    from radardistill_tpu_torch.data import host_ops
    from radardistill_tpu_torch.ops import cuda_lib

    assert host_ops._SO.parent == cuda_lib.BUILD_DIR
    assert "radardistill_tpu/" not in str(host_ops._SRC).replace("radardistill_tpu_torch/", "")


def test_host_precompute_does_not_load_the_model_layer():
    code = ("import sys, radardistill_tpu_torch.data.host_precompute; "
            "print([m for m in sys.modules if m.startswith('radardistill_tpu_torch.models')])")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """Copied into a directory with nothing else of the repo, the smoke script
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
