"""Where the benchmark finds a cell and everything it is made of, by name.

``BENCHMARK.json`` at the checkout's root names each cell (``workloads``),
the configuration and the traffic mix it runs, and the metrics each cell
reports. Everything else sits in a file of its own under ``benchmark/``:

- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<traffic>.json``: the parameters the one traffic generator
  (``lib/traffic.py``) and the one driver of its ``kind`` read;
- ``workloads/<cell>.json``: the cell's limits of the comparison that
  decides ``correct``, and how many answers it compares;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

So a later change adds a cell, a configuration, a traffic mix or a metric by
adding files (and its entry in ``BENCHMARK.json``), never by editing one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def bench_spec(root: Path = ROOT) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def _reports(metric: Dict[str, Any], cell: str, e2e_of_cell: set) -> bool:
    """A metric is reported in the cells its ``workloads`` lists; without the
    key, an end-to-end metric in every cell and a per-layer one in every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    spec = bench_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{[w['name'] for w in spec['workloads']]}")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, e2e_names)]
    config = _json(bench_dir / "configs" / f"{entry['config']}.json")
    traffic = _json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = _json(bench_dir / "workloads" / f"{name}.json")
    return Cell(name, int(entry["chips"]), config, traffic, limits, e2e, per_layer)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(view)`` function of ``metrics/<name>.py``."""
    return metric_module(name, bench_dir).read


def metric_module(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``, loaded."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + name.replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module
