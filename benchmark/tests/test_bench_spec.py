"""Cells, configurations, traffic mixes and metric readers are found by the
names in ``BENCHMARK.json``, and a new cell or metric is made by adding
files alone; ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.lib import spec
from benchmark.lib.trace import TraceView

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_loads_from_its_files(cell):
    c = spec.load_cell(cell)
    assert c.traffic["kind"] in ("train", "serve")
    assert c.limits["limits"] and "MODEL" in c.config
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_reader_finds_nothing_in_an_empty_window(metric):
    view = TraceView([], {}, 1, 1, 1, 1e6, {})
    assert spec.metric_reader(metric)(view) is None


def test_a_cell_and_a_metric_are_added_by_new_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "serve", "batch_size": 2, "ring_batches": 8, "radar_returns": [7000, 8000],
         "boxes": [20, 60], "caps": {"MAX_RADAR_POINTS": 8192, "NUM_MAX_OBJS": 500},
         "trace_calls": 4}))
    (tmp_path / "benchmark" / "workloads" / "dummy.cell.json").write_text(json.dumps(
        {"compared_calls": 2, "limits": {"cma_gap": 0.1, "boxes_gap": 0.1}}))
    (tmp_path / "benchmark" / "metrics" / "dummy_ms.py").write_text(
        "def read(view):\n    return 1.5\n")
    bench["workloads"].append({"name": "dummy.cell", "config": "radardistill_val",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(
        "dummy.cell")
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "frames_per_s", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.load_cell("dummy.cell", root=tmp_path, bench_dir=tmp_path / "benchmark")
    assert c.traffic["radar_returns"] == [7000, 8000]
    assert c.config["MODEL"]["NAME"] == "PillarNet"
    assert [m["name"] for m in c.per_layer][-1] == "dummy_ms"
    assert spec.metric_reader("dummy_ms", tmp_path / "benchmark")(None) == 1.5
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s", "setup_s"}
    for p, data in before.items():  # nothing that was there was edited
        assert p.read_bytes() == data


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = {w["name"]: w for w in SPEC["workloads"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
        assert all(w in cells for w in m.get("workloads", []))
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert all(m["moves"] in {e["name"] for e in spec.load_cell(w).end_to_end}
                   for w in m["workloads"])
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]]
    assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
