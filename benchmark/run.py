"""Run one cell of the benchmark once, on this machine's cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell named in ``BENCHMARK.json`` from its files under
``benchmark/`` (``lib/spec.py``), makes its traffic and weights from
``--seed``, warms up, measures for ``--seconds`` with tracing off, and
checks what the timed path produced against the plain reference
(``reference/``). With ``--trace 1`` it also profiles a few more timed calls
and reports the cell's per-layer metrics instead of its end-to-end ones.
The last line of standard output is the result as one JSON object; the
numbers compared, each with its limit, are the last lines of standard
error and the last key of the result.

``--control`` (for the control's test, never in a measured run) puts the
reference computed with fp8 products in the program's place.

Exits 2, printing no result, without CUDA or with fewer cards than the cell
asks for; 3 if JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "radardistill_tpu")


def _environment():
    """Caches inside the checkout, at fixed paths (the program's kernels
    build into ``build/radardistill_tpu_torch/`` there by themselves), and
    no library loading JAX on its own."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def launch_counts():
    """The program's launch counters (per kernel, per route), where its
    modules are loaded."""
    counts = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("radardistill_tpu_torch.ops.") or mod is None:
            continue
        for attr, fn in vars(mod).items():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int) and n:
                routes = getattr(fn, "route_launches", None)
                counts[attr] = {"launches": n, **({"routes": dict(routes)} if routes else {})}
    return counts


def power_limit():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed, seconds, traced, dev, control=None):
    """The result dict of one run of ``cell`` on ``dev``, and the lines of
    the numbers compared."""
    from benchmark.lib import common, serve_cell, spec, trace, train_cell
    from benchmark.lib.precision import Fp8Products

    clock = common.Clock(T0)
    driver = {"train": train_cell, "serve": serve_cell}[cell.traffic["kind"]]
    res = driver.run(cell, seed, seconds, traced, dev, clock,
                     control=Fp8Products if control else None)
    print(f"setup split (s): {json.dumps({k: round(v, 3) for k, v in clock.marks.items()})}; "
          f"setup_s {res['setup_s']:.3f} against run_seconds {seconds}", file=sys.stderr)
    print(f"launches: {json.dumps(launch_counts())}", file=sys.stderr)
    if "host" in res:
        print(f"host over the window: {json.dumps(res['host'])}", file=sys.stderr)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch_device_name(dev), "count": cell.chips,
              "memory_peak_bytes": res["peak"]}
    result = {"correct": None, "attempted": res["attempted"], "failed": res["failed"]}
    if traced and "trace" in res:
        prof, calls, units, traced_us = res.pop("trace")
        view = trace.view_of(prof, calls, units, traced_us,
                             {"work": res.get("work"), "sec_per_unit": res.get("sec_per_unit")})
        del prof
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device.update(busy_s=view.busy_us / 1e6, window_s=view.window_us / 1e6)
        result["metrics"] = metrics
        result["breakdown"] = trace.breakdown(view)
        print(f"card: {power_limit()}", file=sys.stderr)
    else:
        e2e = dict(res["end_to_end"], setup_s=res["setup_s"])
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in e2e}
    result["device"] = device
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["numbers"].items() if k in limits}
    res["detail"]["read, not compared"] = {k: v for k, v in res["numbers"].items()
                                           if k not in limits}
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                            for c in checks.values()) and res["failed"] == 0
    print(f"compared: {json.dumps(res['detail'])}", file=sys.stderr)
    result["checks"] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def torch_device_name(dev):
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from benchmark.lib import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                             control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
