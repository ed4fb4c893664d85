"""BENCHMARK.json against the files of the benchmark, its names and the
imports of its modules; run.py without a card."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "maed_tpu"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["command"][1].startswith("benchmark/")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    assert config["name"] == conf["name"]
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())
    assert mix["size"] == config["img_size"]
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    assert cell["chips"] == 1 and len(cell["why"]) <= 200


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    assert callable(run.reader(metric["name"]))
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        # every cell that reports the per-layer metric reports what it moves
        assert set(metric.get("workloads", cells)) <= set(moved.get("workloads", cells))


def test_names_and_units():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[key]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[key]}) == len(BENCH[key])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    texts = [c["why"] for c in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "maed_tpu_torch" not in _imports(path)


def test_run_without_a_card_prints_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "3", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_readers_on_a_cpu_run(cell, traced):
    """Every metric the cell reports reads a number, or nothing, from a tiny
    run on the CPU (no device time there: the kernels' roofline reads
    nothing)."""
    import time

    import torch

    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    from benchmark.harness import drive
    from benchmark.tests import tiny

    out = drive.run_cell(tiny.cell(cell), 2 ** 31 + 1, 0.3, traced, torch.device("cpu"),
                         time.perf_counter())
    metrics = run.cell_metrics(BENCH, cell, traced)
    assert metrics
    values = {m["name"]: run.reader(m["name"])(out["obs"]) for m in metrics}
    assert all(v is None or v == v and v >= 0 for v in values.values()), values
    assert any(v is not None for v in values.values())
