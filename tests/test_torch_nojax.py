"""The port runs without the JAX package: a fresh interpreter imports
``radardistill_tpu_torch``, builds the synthetic batches and drives both
forwards (radar-only val at grid 256, the distillation forward at grid 128)
and one distillation train step on the CPU with random weights from a seeded generator; afterwards neither
``jax`` nor ``flax`` nor any module of ``radardistill_tpu`` may be in
``sys.modules``. An AST walk over every file of the port and over the card
scripts finds no import of them either. Also: the port's data layer loads none
of its model layer, and ``chip_smoke.py`` copied out of the repo fails without
printing a result."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import json, sys
import torch
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
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "radardistill_tpu"))
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
    "train_loss_finite": bool(torch.isfinite(metrics["loss"])),
    "train_updates": opt.count,
}))
"""


def test_port_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
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


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/torch_profile_slice.py"])
def test_card_scripts_import_only_torch_and_the_port(script):
    names = _imported_modules(os.path.join(REPO, script))
    roots = {n.split(".")[0] for n in names}
    assert {"torch", "radardistill_tpu_torch"} & roots
    assert not roots & {"jax", "jaxlib", "flax", "radardistill_tpu", "chip_smoke"}, names


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    """Every ``.py`` of the port: no import of jax, flax or radardistill_tpu,
    absolute or spelled through ``importlib``/``__import__`` with a literal."""
    assert len(PORT_FILES) > 25
    for rel in PORT_FILES:
        path = os.path.join(REPO, rel)
        roots = {n.split(".")[0] for n in _imported_modules(path)}
        assert not roots & {"jax", "jaxlib", "flax", "radardistill_tpu"}, (rel, roots)
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                    node.func, "id", "")) in ("import_module", "__import__"):
                lits = [a.value for a in node.args if isinstance(a, ast.Constant)]
                assert not any(str(v).split(".")[0] in ("jax", "flax", "radardistill_tpu")
                               for v in lits), (rel, lits)


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
