"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration, traffic mix, limits and metric readers are found by name
under ``benchmark/`` (see ``benchmark/README.md``). The run sets up the
program (``maed_tpu_torch``) from the seed, warms up the cell's shapes,
measures for ``--seconds``, with ``--trace 1`` then traces a short segment
with ``torch.profiler``, checks the answers against the plain reference, and
prints one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end ones, or with ``--trace 1`` the per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks`` (each compared number
and its limit, which also end standard error). Without a CUDA device, or
with fewer than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "maed_tpu"}


def process_start() -> float:
    """perf_counter's reading at the process's start (Linux: from
    /proc/self/stat; elsewhere the import of this file)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_PROCESS


def reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics this cell reports: with ``workloads``, where it names
    the cell; without, every end-to-end metric, and a per-layer one where
    the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def finite(x):
    return x if math.isfinite(x) else 1e300


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    # the program's kernel caches live in the checkout, at fixed paths
    build = ROOT / "maed_tpu_torch" / "kernels" / "_build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TRITON_HOME"] = str(build / "triton_home")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import drive
    from maed_tpu_torch.utils.timing import card_identity

    device = torch.device("cuda", 0)
    cell = drive.load_cell(bench, args.workload)
    print(f"{args.workload} seed {args.seed}: {card_identity()}, torch {torch.__version__}",
          file=sys.stderr)
    out = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    obs = out["obs"]
    metrics = {}
    for m in cell_metrics(bench, args.workload, bool(args.trace)):
        value = reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = loaded_forbidden()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
           "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace:
        dev.update(busy_s=obs.traced["busy_s"], window_s=obs.traced["window_s"])
        result["breakdown"] = {"device_ops": obs.traced["device_ops"],
                               "idle_gaps": obs.traced["idle_gaps"]}
    result["checks"] = {k: {"value": finite(c["value"]), "limit": finite(c["limit"])}
                        for k, c in out["checks"].items()}
    print(f"launches in the window: {obs.launches}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
