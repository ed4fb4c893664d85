#!/usr/bin/env python3
"""Time the two bf16 attention kernels of the flagship against the library call.

    python3 tools/bench_attention.py [tree ...]

For each tree (a checkout of this repository; default: this one), in the
order given, in one process each: build its kernels, print ptxas' register
and spill lines of the TMA kernels, then time on the card, with CUDA events
over the same inputs,

- F/J: ``spatial_attention_btc`` on a (128, 197, 3, 12, 64) projection,
  against ``scaled_dot_product_attention`` on its (B, h, S, d) views;
- K: ``fused_attention`` on the coupling views (8, 12, 3152, 64) of the same
  projection, written in place into (128, 197, 768), against the library.

Each time is the median of 7 repetitions of 50 calls (K: 20). Give two trees
as ``a b b a`` to compare them within one call; the card and its power limit
head the output. Each tree prints one ``BENCH {json}`` line.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import json, statistics, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.nn.functional as F
from maed_tpu_torch import kernels
from maed_tpu_torch.ops import attention, st_attention

t0 = time.perf_counter()
lib = kernels.build()
build_s = time.perf_counter() - t0
import re
log = lib.with_suffix(".log").read_text().splitlines()
for i, line in enumerate(log):
    name = re.search(r"([a-z_]+_tma_kernel)I((?:Li\d+E)+)", line)
    if "Compiling entry" in line and name:
        args = ", ".join(re.findall(r"Li(\d+)E", name.group(2)))
        print(f"  ptxas {name.group(1)}<{args}>:", " | ".join(x.strip() for x in log[i + 2:i + 4]))

def ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)

dev = torch.device("cuda")
qkv = torch.from_numpy(np.random.RandomState(0).randn(128, 197, 3, 12, 64)).to(dev, torch.bfloat16)
q4, k4, v4 = (a.transpose(1, 2) for a in qkv.unbind(2))
att = 64 ** -0.5
out = {"tree": sys.argv[1], "build_s": build_s}
out["spatial_ms"] = ms(lambda: st_attention.spatial_attention_btc(qkv, att), 50)
out["spatial_library_ms"] = ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=att), 50)
qv, kv, vv = (a.transpose(1, 2) for a in qkv.view(8, 3152, 3, 12, 64).unbind(2))
y = torch.empty(128, 197, 768, dtype=torch.bfloat16, device=dev)
yv = y.view(8, 3152, 12, 64).transpose(1, 2)
out["blocked_ms"] = ms(lambda: attention.fused_attention(qv, kv, vv, att, out=yv), 20)
out["blocked_library_ms"] = ms(lambda: F.scaled_dot_product_attention(qv, kv, vv, scale=att), 20)
print("BENCH " + json.dumps(out))
"""


def main() -> int:
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]] or [str(ROOT)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    failed = 0
    for tree in trees:
        print(f"== {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN, tree], capture_output=True, text=True,
                              timeout=900)
        print(proc.stdout, end="")
        if proc.returncode:
            print(proc.stderr[-3000:])
            failed = 1
    return failed


if __name__ == "__main__":
    sys.exit(main())
