"""The port runs its slice without JAX: a fresh interpreter imports
``radardistill_tpu_torch``, builds the synthetic serving batch and drives the
radar-only forward at grid 256 on the CPU with random weights from a seeded
generator, and neither ``jax`` nor ``flax`` may appear in ``sys.modules``.
Also: the card scripts import only ``torch`` and the port, the port's data
layer loads none of its model layer, and ``chip_smoke.py`` copied out of the
repo fails without printing a result."""

import ast
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

cfg, info, batch = make_batch(grid=256)
model = init_random_(build_network(cfg, info), torch.Generator().manual_seed(0))
out = model(batch_to_torch(batch, "cpu"))
fin = out["final_box_dicts"]
print(json.dumps({
    "jax": "jax" in sys.modules, "flax": "flax" in sys.modules,
    "finite": bool(all(torch.isfinite(v).all() for v in out["radar_preds"].values())),
    "hm_shape": list(out["radar_preds"]["hm"].shape),
    "boxes_shape": list(fin["boxes"].shape),
    "n_valid": int(fin["valid"].sum()),
    "as_overflow": int(out["as_overflow"]),
}))
"""


def test_port_slice_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["jax"] is False and rec["flax"] is False
    assert rec["finite"]
    assert rec["hm_shape"] == [1, 32, 32, 6, 2]
    assert rec["boxes_shape"] == [1, 6 * 83, 9]
    assert rec["n_valid"] > 0
    assert rec["as_overflow"] == 0


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/torch_profile_slice.py"])
def test_card_scripts_import_only_torch_and_the_port(script):
    """The card scripts reach the JAX package's jax-free helpers only through
    the port (``radardistill_tpu_torch.data``), never directly."""
    names = _imported_modules(os.path.join(REPO, script))
    roots = {n.split(".")[0] for n in names}
    assert {"torch", "radardistill_tpu_torch"} & roots
    assert not roots & {"jax", "flax", "radardistill_tpu", "chip_smoke"}, names


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
