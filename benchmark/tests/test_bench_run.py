"""Whole runs of the harness at a CPU size (``small.py``): the result line's
schema, and ``correct`` coming out false where the timed path is broken
underneath (each fault a cell can have) and for the control. The harness's
look for a chip is skipped: ``run.run_cell`` is what ``run.main`` calls
once it has found the cards. On a card (``-m gpu``): the control at the
cells' own sizes."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.lib import spec
from small import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 101
ROOT = Path(__file__).resolve().parents[2]
# a CPU serving call takes seconds (decode and NMS over 1000 candidates a
# head): long enough a window for the ring's two calls to be answered
SERVE_SECONDS = 12.0


def _run(name, traced=False, control=False, seconds=0.5, **small):
    torch.manual_seed(0)
    cell = small_cell(spec.load_cell(name), **small)
    return run.run_cell(cell, SEED, seconds, traced, CPU, control=control)


def _schema(result, cell, traced):
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(result["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(result["metrics"]) == names
    json.dumps(result)


@pytest.mark.parametrize("name", ["distill_train.bs8", "radar_serve.bs1"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema_and_sound_runs_are_correct(name, traced):
    seconds = 0.5 if name.startswith("distill") else SERVE_SECONDS
    result, lines = _run(name, traced=traced, seconds=seconds, batch_size=1 + (
        name.startswith("distill")))
    _schema(result, spec.load_cell(name), traced)
    assert result["correct"], result["checks"]
    assert len(lines) == len(result["checks"])


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from radardistill_tpu_torch.train import optim

    monkeypatch.setattr(optim.ClippedOptimizer, "step", lambda self: None)
    result, _ = _run("distill_train.bs8")
    assert not result["correct"], result["checks"]


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from radardistill_tpu_torch.train import train_step

    make = train_step.make_train_step

    def halved(*args, **kwargs):
        step = make(*args, **kwargs)

        def half(batch):
            return step({k: v[: v.shape[0] // 2] if torch.is_tensor(v) else v
                         for k, v in batch.items()})
        return half

    monkeypatch.setattr(train_step, "make_train_step", halved)
    result, _ = _run("distill_train.bs8", batch_size=4)
    assert not result["correct"], result["checks"]


def test_boxes_altered_where_they_are_produced_are_not_correct(monkeypatch):
    from radardistill_tpu_torch.models import detector

    decode = detector.decode_and_nms

    def shifted(*args, **kwargs):
        out = decode(*args, **kwargs)
        out["boxes"] = out["boxes"] + torch.tensor([0.5] + [0.0] * 8, device=out["boxes"].device)
        return out

    monkeypatch.setattr(detector, "decode_and_nms", shifted)
    result, _ = _run("radar_serve.bs1", seconds=SERVE_SECONDS, batch_size=1)
    assert not result["correct"], result["checks"]


def _scaled(forward, pick):
    """``forward`` with the output that ``pick`` names scaled by 1.5."""
    def altered(self, *args, **kwargs):
        return pick(forward(self, *args, **kwargs))
    return altered


@pytest.mark.parametrize("layer", ["neck", "head"])
def test_a_neck_or_head_altered_where_it_is_produced_is_not_correct(monkeypatch, layer):
    """The boxes follow the maps they are decoded from, so only the layer's
    own comparison on its own input catches these."""
    from radardistill_tpu_torch.models import bev_backbone, center_head

    if layer == "neck":
        cls = bev_backbone.BaseBEVBackboneV2
        pick = lambda out: (out[0] * 1.5, out[1])  # noqa: E731
    else:
        cls = center_head.CenterHead
        pick = lambda out: dict(out, hm=out["hm"] * 1.5)  # noqa: E731
    monkeypatch.setattr(cls, "forward", _scaled(cls.forward, pick))
    result, _ = _run("radar_serve.bs1", seconds=SERVE_SECONDS, batch_size=1)
    assert not result["correct"], result["checks"]
    number = "neck_gap" if layer == "neck" else "maps_gap"
    assert result["checks"][number]["value"] > result["checks"][number]["limit"]


@pytest.mark.parametrize("name", ["distill_train.bs8", "radar_serve.bs1"])
def test_the_control_is_not_correct(name):
    result, _ = _run(name, control=True, batch_size=1 + name.startswith("distill"))
    assert not result["correct"], result["checks"]


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "radar_serve.bs1",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in spec.bench_spec()["workloads"]])
def test_the_control_at_the_cells_size_is_not_correct(card, name):
    """The control at the cell's own size on the card (about a minute)."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                           str(SEED), "--seconds", "5", "--trace", "0", "--control"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]
