#!/usr/bin/env python3
"""Time the flagship's bf16 kernels C, D, E, F/J and K, each checkout in turn.

    python3 tools/bench_kernels.py [tree ...]

For each tree (a checkout of this repository; default: this one), in the
order given, in one process each: build its kernels, print ptxas' register
and spill lines of the TMA kernels and of the dense GEMM, then time on the
card, with CUDA events over the same inputs, through the public entry points
that every tree since the port began has:

- C: ``fused_ln_mlp`` at (25216, 768), hidden 3072; D: ``fused_ln_dense``
  at the qkv width 2304; E: ``fused_gate_proj`` at (128, 197, 768);
- where the tree has them, C's and D's pieces: the LN pre-pass ``ln_rows``
  (its calls queued behind a sleep on the card, so that the events time the
  kernel and not the host's launches) and each GEMM launch alone, ``dense``
  as fc1, fc2 and the qkv product;
- F/J: ``spatial_attention_btc`` on a (128, 197, 3, 12, 64) projection,
  against ``scaled_dot_product_attention`` on its (B, h, S, d) views;
- K: ``fused_attention`` on the coupling views (8, 12, 3152, 64) of the same
  projection, written in place into (128, 197, 768), against the library.

Each time is the median of 7 repetitions of 20 calls (F/J: 50). Give two
trees as ``a b b a`` to compare them within one call; the card and its power
limit head the output. Each tree prints one ``BENCH {json}`` line.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r"""
import json, re, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.nn.functional as F
from maed_tpu_torch import kernels
from maed_tpu_torch.ops import attention, mlp, st_attention

t0 = time.perf_counter()
lib = kernels.build()
build_s = time.perf_counter() - t0
log = lib.with_suffix(".log").read_text().splitlines()
for i, line in enumerate(log):
    entry = re.search(r"entry function '(\w+)'", line)
    if entry and re.search(r"tma_kernel|dense_bf16|gemm_bf16|gate_proj_bf16|ln_rows", entry.group(1)):
        print(f"  ptxas {entry.group(1)}:", " | ".join(x.strip() for x in log[i + 2:i + 4]))

def ms(fn, iters=20):
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

def device_ms(fn, iters=50):
    # as ms, with the calls queued behind a sleep on the card, so that the
    # events time the kernels and not the host's launches
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)

dev = torch.device("cuda")
bf = torch.bfloat16
rng = np.random.RandomState(0)
T = lambda a, dt=torch.float32: torch.from_numpy(a).to(dev, dt)
out = {"tree": sys.argv[1], "build_s": build_s}
M, C, H = 25216, 768, 3072
x = T(rng.randn(M, C), bf)
s, b = T(rng.rand(C) + 0.5), T(rng.randn(C) * 0.1)
w1, w2 = T(rng.randn(H, C) / np.sqrt(C), bf), T(rng.randn(C, H) / np.sqrt(H), bf)
b1, b2 = T(rng.randn(H) * 0.1), T(rng.randn(C) * 0.1)
wq, bq = T(rng.randn(3 * C, C) / np.sqrt(C), bf), T(rng.randn(3 * C) * 0.1)
out["ln_mlp_ms"] = ms(lambda: mlp.fused_ln_mlp(x, s, b, w1, b1, w2, b2))
out["ln_dense_ms"] = ms(lambda: mlp.fused_ln_dense(x, s, b, wq, bq))
if hasattr(mlp, "ln_rows"):  # the trees that split C and D into the pre-pass and the GEMM
    xn = mlp.ln_rows(x, s, b)
    out["ln_rows_device_ms"] = device_ms(lambda: mlp.ln_rows(x, s, b))
    h = mlp.dense(xn, w1, b1, "gelu")
    out["fc1_ms"] = ms(lambda: mlp.dense(xn, w1, b1, "gelu"))
    out["fc2_ms"] = ms(lambda: mlp.dense(h, w2, b2, "residual", x))
    out["qkv_ms"] = ms(lambda: mlp.dense(xn, wq, bq, "bias"))
    del xn, h
ys, yt, xr = (T(rng.randn(128, 197, C), bf) for _ in range(3))
wts, bts = T(rng.randn(2 * C, 2 * C) / np.sqrt(2 * C), bf), T(rng.randn(2 * C) * 0.1)
wp, bp = T(rng.randn(C, C) / np.sqrt(C), bf), T(rng.randn(C) * 0.1)
out["gate_proj_ms"] = ms(lambda: mlp.fused_gate_proj(ys, yt, xr, wts, bts, wp, bp))
del x, ys, yt, xr
qkv = T(rng.randn(128, 197, 3, 12, 64), bf)
q4, k4, v4 = (a.transpose(1, 2) for a in qkv.unbind(2))
att = 64 ** -0.5
out["spatial_ms"] = ms(lambda: st_attention.spatial_attention_btc(qkv, att), 50)
out["spatial_library_ms"] = ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=att), 50)
qv, kv, vv = (a.transpose(1, 2) for a in qkv.view(8, 3152, 3, 12, 64).unbind(2))
y = torch.empty(128, 197, 768, dtype=bf, device=dev)
yv = y.view(8, 3152, 12, 64).transpose(1, 2)
out["blocked_ms"] = ms(lambda: attention.fused_attention(qv, kv, vv, att, out=yv))
out["blocked_library_ms"] = ms(lambda: F.scaled_dot_product_attention(qv, kv, vv, scale=att))
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
