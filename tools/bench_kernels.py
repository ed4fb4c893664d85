#!/usr/bin/env python3
"""Time the flagship's kernels, bf16 C to K and f32 A (or, with --f32, the f32
forms of C, D, E and F/J), each checkout in turn.

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

    python3 tools/bench_kernels.py --f32 [tree ...]

times the f32 forms instead (TF32 off), at the same shapes: C, D and E
through ``fused_ln_mlp``, ``fused_ln_dense`` and ``fused_gate_proj``; each
GEMM launch alone (fc1 with the GELU, fc2 with the residual, qkv, E's proj),
through ``dense`` where the tree's takes f32, else through the tree's own C
entry ``maed_dense_f32`` (an older tree's, whose fc1 and qkv normalize their
A tile), beside ``torch.matmul`` on the same f32 products; the f32 pre-passes
``ln_rows`` and ``gate_blend`` where the tree has them in f32, and there E's
``gate_means`` and ``gate_alpha`` beside ``torch.mean`` over N of each branch
and ``torch.addmm`` of the gate's product and bias, with their max abs
errors against the plain versions, and the gate of one clip (BT 16) at C
768, 1024 and 1280 beside ``torch.addmm``; F/J's
``spatial_attention_btc`` on the (128, 197, 3, 12, 64) projection beside
``scaled_dot_product_attention``, and, where the tree has
``st_attention.general_plan``, the general kernel's f32 rows form launched
at the same head dim 64; K's ``fused_attention`` on the coupling views
(8, 12, 3152, 64) of that projection, written in place into
(128, 197, 768), and G/H's ``temporal_attention_fused`` and
``temporal_attention`` at 16 frames, each beside
``scaled_dot_product_attention`` on the same views (K: 5 calls a
repetition). All on the device (calls queued behind a sleep), with each
kernel's max abs error against its plain version and ptxas' register and
spill lines of the f32 kernels.
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


RUN_F32 = r"""
import json, re, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import torch.nn.functional as F
from maed_tpu_torch import kernels
from maed_tpu_torch.ops import attention, mlp, st_attention

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
built = kernels.build()
lib = kernels.library()
build_s = time.perf_counter() - t0
log = built.with_suffix(".log").read_text().splitlines()
for i, line in enumerate(log):
    entry = re.search(r"entry function '(\w+)'", line)
    if entry and "f32" in entry.group(1):
        print(f"  ptxas {entry.group(1)}:", " | ".join(x.strip() for x in log[i + 2:i + 4]))

def device_ms(fn, iters=20):
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
rng = np.random.RandomState(0)
T = lambda a: torch.from_numpy(a).to(dev, torch.float32)
out = {"tree": sys.argv[1], "build_s": build_s}
M, C, H, B, N = 25216, 768, 3072, 128, 197
x = T(rng.randn(M, C))
s, b = T(rng.rand(C) + 0.5), T(rng.randn(C) * 0.1)
w1, w2 = T(rng.randn(H, C) / np.sqrt(C)), T(rng.randn(C, H) / np.sqrt(H))
b1, b2 = T(rng.randn(H) * 0.1), T(rng.randn(C) * 0.1)
wq, bq = T(rng.randn(3 * C, C) / np.sqrt(C)), T(rng.randn(3 * C) * 0.1)
wp, bp = T(rng.randn(C, C) / np.sqrt(C)), T(rng.randn(C) * 0.1)
ys, yt = T(rng.randn(B, N, C)), T(rng.randn(B, N, C))
wts, bts = T(rng.randn(2 * C, 2 * C) / np.sqrt(2 * C)), T(rng.randn(2 * C) * 0.1)
out["ln_mlp_ms"] = device_ms(lambda: mlp.fused_ln_mlp(x, s, b, w1, b1, w2, b2), 10)
out["ln_dense_ms"] = device_ms(lambda: mlp.fused_ln_dense(x, s, b, wq, bq), 10)
out["gate_proj_ms"] = device_ms(lambda: mlp.fused_gate_proj(ys, yt, x.view(B, N, C), wts, bts,
                                                             wp, bp), 10)
xn = mlp.ln_rows_reference(x, s, b, 1e-6)
h = mlp.dense_reference(xn, w1, b1, "gelu")
alpha = mlp.gate_alpha_reference(mlp.gate_means_reference(ys, yt), wts, bts)
y = mlp.gate_blend_reference(ys, yt, alpha).reshape(M, C)
try:
    mlp.dense(xn, wq, bq)
    split = True  # the GEMM takes f32 after the pre-passes
except ValueError:
    split = False
if split:
    out["ln_rows_ms"] = device_ms(lambda: mlp.ln_rows(x, s, b, 1e-6))
    out["gate_blend_ms"] = device_ms(lambda: mlp.gate_blend(ys, yt, alpha))
    # E's gate: the branch means and the gate product, each beside the
    # library's calls for the same function (torch.mean over N of each
    # branch; torch.addmm of the product and the bias, before the softmax)
    means = mlp.gate_means_reference(ys, yt)
    out["gate_means_ms"] = device_ms(lambda: mlp.gate_means(ys, yt))
    out["gate_means_library_ms"] = device_ms(lambda: (torch.mean(ys, 1), torch.mean(yt, 1)))
    out["gate_means_max_abs_err"] = (mlp.gate_means(ys, yt) - means).abs().max().item()
    out["gate_alpha_ms"] = device_ms(lambda: mlp.gate_alpha(means, wts, bts))
    out["gate_alpha_library_ms"] = device_ms(lambda: torch.addmm(bts, means, wts.t()))
    out["gate_alpha_max_abs_err"] = (mlp.gate_alpha(means, wts, bts) - mlp.gate_alpha_reference(
        means, wts, bts)).abs().max().item()
    # the gate of one clip (16 frames) at the stock ViTs' widths
    for width in (768, 1024, 1280):
        m16 = T(rng.randn(16, 2 * width))
        w16 = T(rng.randn(2 * width, 2 * width) / np.sqrt(2 * width))
        b16 = T(rng.randn(2 * width) * 0.1)
        out[f"gate_alpha_bt16_c{width}_ms"] = device_ms(lambda: mlp.gate_alpha(m16, w16, b16))
        out[f"gate_alpha_bt16_c{width}_library_ms"] = device_ms(
            lambda: torch.addmm(b16, m16, w16.t()))
    del m16, w16, b16
    gemms = {"fc1": lambda: mlp.dense(xn, w1, b1, "gelu"),
             "fc2": lambda: mlp.dense(h, w2, b2, "residual", x),
             "qkv": lambda: mlp.dense(xn, wq, bq),
             "proj": lambda: mlp.dense(y, wp, bp, "proj", x)}
else:  # the older C entry: (epilogue, a, ln_scale, ln_bias, eps, w, bias, residual, out, M, N, K)
    o1, o2, oq = (torch.empty(M, n, device=dev) for n in (H, C, 3 * C))
    st = lambda: torch.cuda.current_stream().cuda_stream
    call = lambda *a: kernels.check(lib.maed_dense_f32(*a, st()), "maed_dense_f32")
    gemms = {"fc1": lambda: call(1, x.data_ptr(), s.data_ptr(), b.data_ptr(), 1e-6,
                                 w1.data_ptr(), b1.data_ptr(), None, o1.data_ptr(), M, H, C),
             "fc2": lambda: call(2, h.data_ptr(), None, None, 0.0, w2.data_ptr(), b2.data_ptr(),
                                 x.data_ptr(), o2.data_ptr(), M, C, H),
             "qkv": lambda: call(0, x.data_ptr(), s.data_ptr(), b.data_ptr(), 1e-6,
                                 wq.data_ptr(), bq.data_ptr(), None, oq.data_ptr(), M, 3 * C, C)}
operands = {"fc1": (xn, w1), "fc2": (h, w2), "qkv": (xn, wq), "proj": (y, wp)}
for name, fn in gemms.items():
    out[name + "_ms"] = device_ms(fn, 10)
for name, (a, w) in operands.items():
    out[name + "_library_ms"] = device_ms(lambda: torch.matmul(a, w.t()), 10)
del x, xn, h, y, ys, yt
qkv = T(rng.randn(B, N, 3, 12, 64))
q4, k4, v4 = (a.transpose(1, 2) for a in qkv.unbind(2))
att = 64 ** -0.5
out["spatial_ms"] = device_ms(lambda: st_attention.spatial_attention_btc(qkv, att), 50)
out["spatial_library_ms"] = device_ms(
    lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=att), 50)
if hasattr(st_attention, "general_plan"):
    res = torch.empty(B, N, 768, device=dev)
    view = res.view(B, N, 12, 64).transpose(1, 2)
    out["general_rows_d64_ms"] = device_ms(lambda: st_attention.launch_general(
        "spatial", "spatial_attention_general", 0, False, q4, k4, v4, view, (B, 12, 1),
        (*q4.stride()[:2], 0, q4.stride(2)), (*view.stride()[:2], 0, view.stride(2)), N, att), 50)
    want = st_attention.spatial_reference_btc(qkv, att)
    out["general_rows_d64_max_abs_err"] = (res - want).abs().max().item()
# K f32: the coupling mode's views of 8 clips of 16 frames, written in place
S = 16 * N
qv, kv, vv = (a.transpose(1, 2) for a in qkv.view(8, S, 3, 12, 64).unbind(2))
res = torch.empty(B, N, 768, device=dev)
view = res.view(8, S, 12, 64).transpose(1, 2)
out["blocked_ms"] = device_ms(lambda: attention.fused_attention(qv, kv, vv, att, out=view), 5)
out["blocked_library_ms"] = device_ms(
    lambda: F.scaled_dot_product_attention(qv, kv, vv, scale=att), 5)
want = attention.attention_blocked_reference(qv, kv, vv, att).transpose(1, 2).reshape(B, N, 768)
out["blocked_max_abs_err"] = (res - want).abs().max().item()
del res, view, want
# G/H f32 at 16 frames, both layouts
q5, k5, v5 = (a.reshape(8, 16, N, 12, 64).permute(0, 2, 3, 1, 4) for a in qkv.unbind(2))
out["temporal_ms"] = device_ms(lambda: st_attention.temporal_attention_fused(qkv, 16, att), 50)
out["temporal_head_leading_ms"] = device_ms(
    lambda: st_attention.temporal_attention(qkv, 16, att), 50)
out["temporal_library_ms"] = device_ms(
    lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=att), 50)
want = st_attention.temporal_reference_btc(qkv, 16, att)
out["temporal_max_abs_err"] = (st_attention.temporal_attention_fused(qkv, 16, att)
                               - want).abs().max().item()
print("BENCH " + json.dumps(out))
"""


def main() -> int:
    f32 = "--f32" in sys.argv[1:]
    trees = [str(Path(t).resolve()) for t in sys.argv[1:] if t != "--f32"] or [str(ROOT)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    failed = 0
    for tree in trees:
        print(f"== {tree}", flush=True)
        proc = subprocess.run([sys.executable, "-c", RUN_F32 if f32 else RUN, tree],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, end="")
        if proc.returncode:
            print(proc.stderr[-3000:])
            failed = 1
    return failed


if __name__ == "__main__":
    sys.exit(main())
