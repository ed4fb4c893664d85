"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds: one block
of two heads, KTD 32 wide, 32^2 frames (stage 1: 64^2, so that BatchNorm
has moments to take), two clips of four frames."""

from __future__ import annotations

import json
from pathlib import Path

from benchmark.harness import drive

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name: str) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    size = 64 if cfg["encoder"] == "cnn" else 32
    cfg.update(num_blocks=1, num_heads=2, hidden_dim=32, img_size=size)
    return cfg


# the training cells' files, for the tests, whether or not BENCHMARK.json lists them
TRAIN = {"stage2_train": ("maed_stage2", "train_mixed"),
         "stage1_train": ("maed_stage1", "train_images128")}


def full_cell(name: str) -> drive.Cell:
    """The cell at its own size."""
    bench = BENCH
    if name in TRAIN and all(w["name"] != name for w in BENCH["workloads"]):
        conf, mix = TRAIN[name]
        bench = {"workloads": [{"name": name, "config": conf, "traffic": mix, "chips": 1}],
                 "configs": [{"name": conf, "file": f"benchmark/configs/{conf}.json"}]}
    return drive.load_cell(bench, name)


def cell(name: str) -> drive.Cell:
    c = full_cell(name)
    c.config = config(c.config["name"])
    m = c.mix
    m.update(size=c.config["img_size"], pool=3, trace_items=1)
    if m["kind"] == "infer":
        m.update(clips=2, frames=4, sample=2, reference_block=2, warmup=1)
    else:
        m.update(clips_2d=min(m["clips_2d"], 1), clips_3d=min(m["clips_3d"], 2),
                 frames=min(m["frames"], 4), images=2 if m["clips_3d"] else 8)
    return c
