#!/usr/bin/env python3
"""Time the flagship's kernels, bf16 C to K and f32 A, each checkout in turn.

    python3 tools/bench_kernels.py [tree ...]

For each tree (a checkout of this repository; default: this one), in the
order given, in one process each: build its kernels, print ptxas' register
and spill lines of the TMA kernels, the dense GEMM, the gate, GroupNorm,
temporal attention and skinning kernels, then time on the card, with CUDA
events over the same inputs,
through the public entry points that every tree since the port began has:

- C: ``fused_ln_mlp`` at (25216, 768), hidden 3072; D: ``fused_ln_dense``
  at the qkv width 2304; E: ``fused_gate_proj`` at (128, 197, 768), also
  on the device (its calls queued behind a sleep on the card, so that the
  events time the kernels and not the host's launches);
- where the tree has them, C's and D's pieces: the LN pre-pass ``ln_rows``
  (on the device) and each GEMM launch alone, ``dense`` as fc1, fc2 and the
  qkv product; E's pieces on the device: ``gate_means``, ``gate_alpha``,
  ``gate_blend`` and ``dense`` as "proj", beside cuBLAS on the same proj
  product;
- I: ``fused_groupnorm`` on the device at the stem's 12 kinds of site (the
  nine shapes, three of them also with the residual and ReLU of a
  bottleneck's norm3), 128 frames channels-last, beside ``F.group_norm`` on
  the same frames where the site has no residual and no ReLU; where the tree
  has ``cluster_groupnorm``, each site again at every cluster size that fits;
- F/J: ``spatial_attention_btc`` on a (128, 197, 3, 12, 64) projection,
  against ``scaled_dot_product_attention`` on its (B, h, S, d) views;
- K: ``fused_attention`` on the coupling views (8, 12, 3152, 64) of the same
  projection, written in place into (128, 197, 768), against the library;
- G/H on the device: ``temporal_attention_fused`` ((128, 197, 768)) and
  ``temporal_attention`` ((12, 128, 197, 64)) at 16 frames on the same
  projection, against ``scaled_dot_product_attention`` on its
  (8, 197, 12, 16, 64) views;
- A on the device: ``skinning`` at (128, 6890) f32, chip_smoke.py's inputs.

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
from maed_tpu_torch.ops import attention, groupnorm, mlp, skinning, st_attention

t0 = time.perf_counter()
lib = kernels.build()
build_s = time.perf_counter() - t0
log = lib.with_suffix(".log").read_text().splitlines()
for i, line in enumerate(log):
    entry = re.search(r"entry function '(\w+)'", line)
    if entry and re.search(r"tma_kernel|dense_bf16|gemm_bf16|gate_|ln_rows|groupnorm|temporal|"
                           r"skinning", entry.group(1)):
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
out["gate_proj_device_ms"] = device_ms(lambda: mlp.fused_gate_proj(ys, yt, xr, wts, bts, wp, bp))
if hasattr(mlp, "gate_means"):  # the trees that split E into its pieces
    means = mlp.gate_means(ys, yt)
    alpha = mlp.gate_alpha(means, wts, bts)
    yb = mlp.gate_blend(ys, yt, alpha)
    out["gate_means_device_ms"] = device_ms(lambda: mlp.gate_means(ys, yt))
    out["gate_alpha_device_ms"] = device_ms(lambda: mlp.gate_alpha(means, wts, bts))
    out["gate_blend_device_ms"] = device_ms(lambda: mlp.gate_blend(ys, yt, alpha))
    out["gate_gemm_device_ms"] = device_ms(lambda: mlp.dense(yb, wp, bp, "proj", xr))
    out["gate_gemm_library_ms"] = device_ms(lambda: torch.matmul(yb, wp.t()))
    del means, alpha, yb
del x, ys, yt, xr

# I: the stem's sites, 128 frames (side, channels, ReLU, residual)
sites = ((112, 64, True, False), (56, 64, True, False), (56, 256, False, False),
         (56, 256, True, True), (56, 128, True, False), (28, 128, True, False),
         (28, 512, False, False), (28, 512, True, True), (28, 256, True, False),
         (14, 256, True, False), (14, 1024, False, False), (14, 1024, True, True))
gen = torch.Generator(device=dev).manual_seed(0)
gn, sweep = {}, {}
for side, ch, relu, with_res in sites:
    name = f"{side}x{side}x{ch}" + (" +res" if with_res else "") + (" +relu" if relu else "")
    xg = (torch.randn(128, side, side, ch, device=dev, generator=gen) * 2 + 0.5).to(bf)
    rg = torch.randn(128, side, side, ch, device=dev, generator=gen).to(bf) if with_res else None
    gs = torch.rand(ch, device=dev, generator=gen) + 0.5
    gb = torch.randn(ch, device=dev, generator=gen) * 0.1
    gn[name] = device_ms(lambda: groupnorm.fused_groupnorm(xg, gs, gb, 32, 1e-5, relu, rg))
    if not relu and not with_res:
        xn, gsb, gbb = xg.permute(0, 3, 1, 2), gs.to(bf), gb.to(bf)
        gn[name + " F.group_norm"] = device_ms(lambda: F.group_norm(xn, 32, gsb, gbb, 1e-5))
    if hasattr(groupnorm, "cluster_groupnorm"):
        sweep[name] = {}
        for ranks in groupnorm.CLUSTERS:
            if groupnorm.cluster_fits(side * side, ch, 32, ranks):
                sweep[name][ranks] = device_ms(lambda: groupnorm.cluster_groupnorm(
                    xg, gs, gb, 32, 1e-5, relu, rg, ranks=ranks))
    del xg, rg
out["groupnorm_device_ms"] = gn
if sweep:
    out["groupnorm_cluster_sweep_device_ms"] = sweep
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
del qv, kv, vv, y, yv
q5, k5, v5 = (a.reshape(8, 16, 197, 12, 64).permute(0, 2, 3, 1, 4) for a in qkv.unbind(2))
out["temporal_device_ms"] = device_ms(lambda: st_attention.temporal_attention_fused(qkv, 16, att))
out["temporal_head_leading_device_ms"] = device_ms(
    lambda: st_attention.temporal_attention(qkv, 16, att))
out["temporal_library_device_ms"] = device_ms(
    lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=att))
del qkv, q4, k4, v4, q5, k5, v5
# A as chip_smoke.py draws it: rigid transforms, weights normalized per vertex
rng = np.random.RandomState(0)
v_posed = T(rng.randn(128, 6890, 3) * 0.3)
W = rng.rand(6890, 24) ** 4
W = T(W / W.sum(axis=1, keepdims=True))
rot, _ = np.linalg.qr(rng.randn(128 * 24, 3, 3))
A = np.zeros((128 * 24, 4, 4))
A[:, :3, :3], A[:, :3, 3], A[:, 3, 3] = rot, rng.randn(128 * 24, 3) * 0.3, 1.0
A = T(A.reshape(128, 24, 4, 4))
out["skinning_device_ms"] = device_ms(lambda: skinning.skinning(v_posed, W, A))
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
