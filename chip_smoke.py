#!/usr/bin/env python3
"""Smoke run of the PyTorch port (maed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from maed_tpu_torch/csrc (nvcc, sm_90a, one
   compiler per source).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship eval forward gives it, in f32 and bf16, and times
   both, beside the least time the card could take for the same work and,
   where one PyTorch call computes the same function, that call (for LN +
   MLP, LN + qkv and the attention's gated tail, which no one call
   computes, their products through cuBLAS as ``gemm_library_ms``). The
   tail's bf16 pieces (means, gate, blend, proj), GroupNorm at each of the
   stem's 12 kinds of site, the temporal attention in both layouts and the
   skinning are also timed on the device, their launches queued.
3. Drives the eval forward the way a user would: ``build_eval_model`` for
   the released stage-2 MAED (6 blocks, 12 heads, KTD hidden 1024) in bf16
   with seeded random weights and the synthetic 6890-vertex SMPL body, then
   answers 3 requests of 8 clips x 16 frames x 224^2 uint8 with a (14, 6890)
   J14 regressor. The launch counts must show that every kernel ran.
4. Runs one f32 forward with the kernels and one with their plain versions,
   which must agree, and holds the bf16 answers to the f32 ones: through
   the kernels they may lie at most BF16_RATIO times as far from them as
   through the plain versions.
5. Then the eval protocol over a coupling model, and one request of each
   other attention mode.
6. Trains: ``build_train_model`` for the same model with f32 master weights,
   ``make_train_step`` over the stage-2 composition (3 2D clips and 4 3D
   clips of 16 frames, 7 images, uint8, with self-consistent synthetic
   targets), 5 steps in f32 and 5 in bf16 from one generator seed. A step's
   launches must be those of a video and an image forward (the backward
   launches nothing); the f32 step through the kernels must agree with the
   same step through their plain versions (and, for the whole gradient, be
   as close to the same step in f64), and the bf16 gradient must lie at
   most BF16_RATIO times as far from the f32 one through the kernels as
   through the plain versions. The f32 step of the same model with remat
   (each ViT block recomputed in the backward) must give the gradient of
   the step without it bit for bit; both print their step time and peak
   memory.
7. Data parallel (``phase_ddp``): two ranks on the one card over gloo
   (``python3 chip_smoke.py --ddp-rank <dir>`` each; NCCL takes one rank a
   device), each on half of a global batch, against one process on the
   whole batch through the kernels in f32 at full width: stage 2 on 4 2D +
   4 3D clips and 8 images, stage 1 on 128 images (global BatchNorm
   moments), every dropout rate 0 on both sides.
7b. Tensor parallel (``phase_tp``): two ranks on the one card over gloo
   (``python3 chip_smoke.py --tp-rank <dir>`` each, MAED_MESH_TP=2), each
   holding half of every ViT block (6 of the 12 heads, 1536 of the 3072
   hidden columns) and launching every kernel on its shard: a bf16 and an
   f32 eval forward of 8 clips x 16 frames held against one process (f32
   within the kernels-vs-plain bound, bf16 by BF16_RATIO), one f32 stage-2
   step on 2 + 2 clips and 4 images (the loss, the gathered gradient and the
   updated parameters by the step's own bounds), each rank's launches those
   of the split forwards (past tp rank 0, C's fc2 and E's proj through the
   row-parallel epilogue), and that epilogue alone against its plain version
   at fc2's and proj's shard shapes.
8. Runs the CLIs (``phase_trainer``) at full width on
   configs/config_stage2.yaml in f32 over synthetic DBs of the JPEG frames
   in tests/torch_port_data: ``python -m maed_tpu_torch.train`` for 2 epochs
   of 3 iterations with validation and checkpoints each epoch; the same
   command with TRAIN.RESUME auto as the one NCCL rank of ``python -m
   torch.distributed.run --nproc_per_node 1``, stopped by SIGTERM in epoch 2
   and relaunched, whose losses and last checkpoint must match the first
   run's;
   ``python -m maed_tpu_torch.eval`` on model_best.pth.tar, whose metrics
   must match the validation that chose it; the native decoder against the
   pixels cv2 decoded from the frames; the 3D loader's rate alone with 0 and
   8 workers.
9. Stage 1 (``phase_stage1``): ``build_train_model`` for the ResNet-50
   with BatchNorm and KTD at full width in f32, 3 steps of 128 uint8 images
   through kernel A (its only kernel: the ResNet stays on cuDNN), through
   A's plain version and through the plain versions in f64, held to each
   other with the running statistics (STAGE1_STATS_RTOL, F32_GRAD_RATIO);
   a bf16 eval forward of 8 clips x 16 frames through cnn + ktd and cnn +
   iterative by BF16_RATIO; A at B = 128; ``python -m maed_tpu_torch.train
   --cfg configs/config_stage1.yaml`` for 2 epochs of 3 iterations, the
   same under torchrun (its one rank's BatchNorm takes the group's moments:
   its first step held to the run without a launcher), and under torchrun
   stopped by SIGTERM and resumed bit for bit, BatchNorm buffers included,
   and the
   eval CLI on its model_best.pth.tar; the published-backbone import
   (``--init_backbone``) from a synthetic in21k .npz and a timm .pth.
10. The demo (``phase_demo``): ``python -m maed_tpu_torch.demo --render``
   as a user runs it, on configs/config_stage2.yaml (the released model in
   f32) with a .pth.tar of seeded random weights, over 65 frames of the
   fixture JPEGs with seeded boxes; its inference.pkl against the same
   frames through the kernels' plain versions in this process
   (``demo.infer``), its launches those of the f32 forwards (every kernel
   but K), an overlay PNG a frame, and ``python -m maed_tpu_torch.visualize``
   writing the same PNGs byte for byte.
11. The 3DPW preprocessor (``phase_preprocess``): ``python -m
   maed_tpu_torch.data.preprocess.threedpw`` on a synthetic raw layout of
   3 splits x 4 people x 1200 frames, its SMPL forwards through kernel A;
   each DB's joints3D against the plain version within 1e-4 m, and the
   port's VideoDataset reading a window of the test DB.

Any failed check raises. On success the last two lines are the kernels'
record and {"ok": true, "device": {...}}. Needs a CUDA card (and exits
non-zero without one) and the repository around this file. It drives one
card, the first visible one, and hides the others from itself.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# one card: the device count in the last line is the count the run drove
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
N_CLIPS, SEQLEN, IMG = 8, 16, 224
NUM_VERTS = 6890
REQUESTS = 3
# the eval protocol's loader: window batches (the second is ragged and padded
# to the first's size), frames a window
EVAL_BATCHES, POOL = (8, 5), 128
# kernel launches per forward (f32 and bf16): the stem's 52 GroupNorms, the MLP's three
# launches per block (norm2's rows, fc1, fc2), the final norm and SMPL's
# skinning; then per block what the attention of each st_mode launches
# (parallel: norm1's rows and the qkv product, the spatial and the temporal
# branch, the tail's branch means, gate, blend and proj; coupling: norm1's
# rows, qkv and the blocked attention; temporal: norm1 by itself)
BLOCK_KERNELS = {
    "parallel": ("ln_rows", "ln_dense", "spatial_attention", "temporal_attention", "gate_means",
                 "gate_alpha", "gate_blend", "gate_proj"),
    "coupling": ("ln_rows", "ln_dense", "attention_blocked"),
    "vanilla": ("ln_rows", "ln_dense", "spatial_attention"),
    "temporal": ("layernorm", "temporal_attention"),
    "series": ("ln_rows", "ln_dense", "spatial_attention", "temporal_attention"),
}


def per_forward(mode: str, depth: int = 6, dtype: torch.dtype = torch.bfloat16,
                seqlen: int = SEQLEN) -> dict:
    """Launches of every kernel in one forward of ``mode`` at ``depth`` blocks
    in ``dtype`` over clips of ``seqlen`` frames. In f32 the GroupNorms go to
    the strided kernel; C, D and E launch their pre-passes (the LN rows, the
    blend) in both dtypes; clips of one frame take the temporal branch's
    shortcut."""
    from maed_tpu_torch import kernels

    counts = dict.fromkeys(kernels.LAUNCHES, 0)
    if mode == "cnn":  # stage 1's ResNet-50 stays on cuDNN; then SMPL's skinning
        return dict(counts, skinning=1)
    counts.update(layernorm=1, skinning=1, ln_rows=depth, ln_mlp_fc1=depth, ln_mlp_fc2=depth)
    counts["groupnorm" if dtype == torch.bfloat16 else "groupnorm_strided"] = 52
    for name in BLOCK_KERNELS[mode]:
        counts[name] += depth
    if seqlen == 1:
        counts["temporal_attention"] = 0
    return counts


def expect_launches(launches: dict, mode: str, forwards: int, depth: int = 6, extra=None,
                    dtype: torch.dtype = torch.bfloat16):
    """Raise unless ``launches`` are those of ``forwards`` forwards of ``mode``
    in ``dtype`` (plus ``extra``: launches made beside the forwards)."""
    for name, per in per_forward(mode, depth, dtype).items():
        want = per * forwards + (extra or {}).get(name, 0)
        if launches[name] != want:
            raise AssertionError(f"{mode}: {name} launched {launches[name]} times, want {want} "
                                 f"({per} per forward x {forwards})")


# every distinct (side, channels, relu) of the stem's 52 GroupNorms at 224 px:
# the stem norm; stage 1's norm1/2 and norm3/downsample; stage 2's first norm1,
# its norm2/norm1 and norm3/downsample; stage 3's likewise
GROUPNORM_SHAPES = ((112, 64, True), (56, 64, True), (56, 256, False), (56, 128, True),
                    (28, 128, True), (28, 512, False), (28, 256, True), (14, 256, True),
                    (14, 1024, False))
# kernel I against its plain version (f32; bf16: mul, add or an output up to
# ~5 rounding to the neighbouring bf16 value)
GROUPNORM_LIMITS = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 1e-2)}
# the pre-activation ResNetV2's sites that the hybrid stem lacks: a stage's
# input through norm1 + ReLU with no residual (side, channels; at 14 x 14 x
# 1024 also the final norm)
PREACT_GROUPNORM_SHAPES = ((56, 256), (28, 512), (14, 1024))
# the 52 sites a forward: (side, channels, relu, residual, launches a forward);
# the 16 bottlenecks' norm3 takes the shortcut as its residual, the ReLU after
GROUPNORM_SITES = ((112, 64, True, False, 1), (56, 64, True, False, 6),
                   (56, 256, False, False, 1), (56, 256, True, True, 3),
                   (56, 128, True, False, 1), (28, 128, True, False, 7),
                   (28, 512, False, False, 1), (28, 512, True, True, 4),
                   (28, 256, True, False, 1), (14, 256, True, False, 17),
                   (14, 1024, False, False, 1), (14, 1024, True, True, 9))
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s, and FLOP/s of the bf16 tensor cores and of f32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# The bf16 flagship's answers through the kernels may lie at most this many
# times as far from the f32 answer (max abs over the requests, verts and
# kp_3d) as its answers through the plain versions do. Both bf16 paths round
# at the same points but accumulate in another order, and the random
# weights' 6D-to-rotation step turns the difference into whole rotations,
# so an absolute bound cannot hold across seeds; the ratio does. Readings
# over weight seeds 0-4 came to at most 1.03 (verts) and 1.24 (kp_3d): PERF.md.
BF16_RATIO = 1.5
# the stage-2 train step's composition (configs/config_stage2.yaml,
# tools/bench_train.py): 2D clips, 3D clips and images a step; steps a dtype
TRAIN_2D, TRAIN_3D, TRAIN_IMAGES, TRAIN_STEPS = 3, 4, 7, 5
# f32, the step through the kernels against the same step through their plain
# versions from the same weights and generator: the total loss within this
# relative difference, the gradient within this relative L2 distance. The
# kernels and cuBLAS/cuDNN sum in other orders, in f32 with TF32 off. The
# bf16 gradient is held by BF16_RATIO to the f32 plain one.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
# The hybrid stem's gradient at these random weights is conditioned so that
# f32 fixes it only to ~1.5%, on either path: the plain f32 step's whole
# gradient lies 2.3e-3 from the same step in f64, the kernels' 2.3e-3 too,
# and the two f32 gradients 1.9e-3 apart, all of it in the stem (its
# GroupNorms' backward magnifies the ~1e-5 by which the two forwards' stem
# activations differ; PERF.md §6). So TRAIN_GRAD_RTOL holds the gradient
# of every parameter outside the stem, and the whole gradient is held to the
# f64 step's: through the kernels at most F32_GRAD_RATIO times as far from
# it as through the plain versions.
F32_GRAD_RATIO = 1.1


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, queued: bool = False) -> float:
    """Mean device time of fn() over iters launches, after a warmup. With
    ``queued`` the launches wait behind a sleep on the card, so that the
    events time the kernels and not the host's work between them."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def rel_l2(a, b):
    """The L2 distance of ``a`` from ``b``, relative to ``b``'s norm."""
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def check_close(name, got, want, atol, rtol=0.0):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    excess = ((got - want).abs() - (atol + rtol * want.abs())).max().item()
    err = max_abs_err(got, want)
    print(f"  {name}: max abs err {err:.3e} (atol {atol:g}, rtol {rtol:g})")
    if excess > 0:
        raise AssertionError(f"{name}: max abs err {err:.3e} beyond atol {atol:g} rtol {rtol:g}")
    return err


def bound(tensors, flops: float, kind: str) -> dict:
    """The least time the card could take: each of ``tensors`` (inputs and
    outputs) moved once at the memory rate, or ``flops`` at the peak rate of
    their ``kind``, whichever is larger."""
    by_bytes = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[kind] * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def compare(label, kernel, plain, atol, rtol, moved=None, flops=0.0, kind="bf16",
            library=None, iters=20):
    """Hold kernel() against plain(); with ``moved`` (the tensors besides the
    output that the function must read) also time both and the optional
    library() call, and return the record of the kernels line."""
    got = kernel()
    err = check_close(label, got, plain(), atol, rtol)
    if moved is None:
        return None
    record = dict(max_abs_err=err, ms=time_ms(kernel, iters),
                  plain_ms=time_ms(plain, max(iters // 4, 2)),
                  **bound([*moved, got], flops, kind),
                  library_ms=None if library is None else time_ms(library, iters))
    print(f"    kernel {record['ms']:.4f} ms, plain {record['plain_ms']:.4f} ms, bound "
          f"{record['bound_ms']:.4f} ms by {record['bound_by']}, library "
          + ("none" if library is None else f"{record['library_ms']:.4f} ms"))
    return record


def skinning_inputs(rng, B, device):
    """Kernel A's inputs for B frames, f32: rest vertices, weights normalized
    per vertex, rigid joint transforms."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32)  # noqa: E731
    v_posed = T(rng.randn(B, NUM_VERTS, 3) * 0.3)
    W = rng.rand(NUM_VERTS, 24) ** 4
    W = T(W / W.sum(axis=1, keepdims=True))
    q, _ = np.linalg.qr(rng.randn(B * 24, 3, 3))
    A = np.zeros((B * 24, 4, 4))
    A[:, :3, :3], A[:, :3, 3], A[:, 3, 3] = q, rng.randn(B * 24, 3) * 0.3, 1.0
    return v_posed, W, T(A.reshape(B, 24, 4, 4))


def phase_kernels(device):
    """Each kernel against its plain version at the flagship shapes, timed in
    f32 and bf16. The records: each kernel's in bf16 (the serving dtype;
    skinning is f32) under its name, and in f32 (the eval CLI's, the demo's
    and the trainer's dtype) under its name + "_f32"."""
    import torch.nn.functional as F

    from maed_tpu_torch import kernels
    from maed_tpu_torch.ops import attention, groupnorm, layernorm, mlp, skinning, st_attention

    rng = np.random.RandomState(0)
    T = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    B, N, C, H, heads = N_CLIPS * SEQLEN, 197, 768, 3072, 12
    M, d = B * N, C // heads
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = {f32: "f32", bf16: "bf16"}  # the peak a product of that dtype is held to
    record = {}

    def key(name, dt):  # the record of a kernel in a dtype
        return name if dt == bf16 else name + "_f32"

    args = skinning_inputs(rng, B, device)
    v_posed = args[0]
    print(f"kernel A skinning: v_posed {tuple(v_posed.shape)} f32")
    # per vertex: 24 joints blended into a 3x4 transform, then applied
    record["skinning"] = compare(
        "skinning f32", lambda: skinning.skinning(*args),
        lambda: skinning.skinning_reference(*args), 1e-5, 0.0, moved=args,
        flops=B * NUM_VERTS * (24 * 12 * 2 + 24), kind="f32", iters=50)
    # on the device (its launches queued behind a sleep: events time the
    # wrapper's host work at this size), ms above by events
    record["skinning"]["device_ms"] = time_ms(lambda: skinning.skinning(*args), 50, queued=True)
    print(f"    on the device: kernel {record['skinning']['device_ms']:.4f} ms")

    # B: layernorm, bf16 (the serving dtype) and f32.
    x = rng.randn(M, C) * 2 + 0.5
    scale, bias = T(rng.rand(C) + 0.5), T(rng.randn(C) * 0.1)
    print(f"kernel B layernorm: x {(M, C)}")
    for dt, atol, rtol in ((f32, 1e-5, 0.0), (bf16, 2e-2, 1e-2)):
        xd, sd, bd = T(x, dt), scale.to(dt), bias.to(dt)
        rec = compare(f"layernorm {dt}", lambda: layernorm.fast_layernorm(xd, scale, bias, 1e-6),
                      lambda: layernorm.layernorm_reference(xd, scale, bias, 1e-6), atol, rtol,
                      moved=(xd, scale, bias), flops=8.0 * M * C,
                      kind="f32", library=lambda: F.layer_norm(xd, (C,), sd, bd, 1e-6), iters=50)
        record[key("layernorm", dt)] = rec

    # C: LN + MLP, and D: LN + dense (the qkv projection), bf16 and f32.
    # Weights as nn.Linear stores them. In bf16 both are the LN pre-pass and
    # then the TMA + wgmma GEMM (once for D, twice for C); beside each, the
    # same products alone through cuBLAS (torch.matmul on the same bf16
    # operands, one call a product, summed) as gemm_library_ms: no one
    # library call computes LN + dense + epilogue, and the port never calls it.
    x = rng.randn(M, C)
    w1, w2 = rng.randn(H, C) / np.sqrt(C), rng.randn(C, H) / np.sqrt(H)
    wq = rng.randn(3 * C, C) / np.sqrt(C)
    b1, b2, bq = T(rng.randn(H) * 0.1), T(rng.randn(C) * 0.1), T(rng.randn(3 * C) * 0.1)
    print(f"kernel C ln_mlp: x {(M, C)}, H {H}; kernel D ln_dense: O {3 * C}")
    for dt, (atol, rtol), (atol_d, rtol_d) in ((f32, (1e-4, 0.0), (1e-4, 0.0)),
                                               (bf16, (5e-2, 2e-2), (2e-2, 1e-2))):
        xd = T(x, dt)
        margs = (xd, scale, bias, T(w1, dt), b1, T(w2, dt), b2, 1e-6)
        rec = compare(f"ln_mlp {dt}", lambda: mlp.fused_ln_mlp(*margs),
                      lambda: mlp.ln_mlp_reference(*margs), atol, rtol,
                      moved=margs[:-1], flops=4.0 * M * C * H, kind=kinds[dt], iters=10)
        record[key("ln_mlp", dt)] = rec
        dargs = (xd, scale, bias, T(wq, dt), bq, 1e-6)
        # bf16 at 2e-2 abs + 1e-2 rel: one bf16 rounding of outputs up to ~5
        rec = compare(f"ln_dense {dt}", lambda: mlp.fused_ln_dense(*dargs),
                      lambda: mlp.ln_dense_reference(*dargs), atol_d, rtol_d,
                      moved=dargs[:-1], flops=2.0 * M * C * 3 * C, kind=kinds[dt], iters=10)
        record[key("ln_dense", dt)] = rec
    # the bf16 pieces: the pre-pass against its plain version within one bf16
    # step of its outputs (f32 statistics summed in another order may move a
    # value across a rounding boundary), each GEMM launch alone, and cuBLAS
    xn = mlp.ln_rows(xd, scale, bias, 1e-6)
    record["ln_rows"] = compare(
        "ln_rows bf16", lambda: mlp.ln_rows(xd, scale, bias, 1e-6),
        lambda: mlp.ln_rows_reference(xd, scale, bias, 1e-6), 1e-6, 2.0 ** -7,
        moved=(xd, scale, bias), flops=8.0 * M * C, kind="f32",
        library=lambda: F.layer_norm(xd, (C,), scale.to(bf16), bias.to(bf16), 1e-6), iters=50)
    w1d, w2d, wqd = margs[3], margs[5], dargs[3]
    h = mlp.dense(xn, w1d, b1, "gelu")
    products = {"fc1": (lambda: mlp.dense(xn, w1d, b1, "gelu"),
                        lambda: torch.matmul(xn, w1d.t())),
                "fc2": (lambda: mlp.dense(h, w2d, b2, "residual", xd),
                        lambda: torch.matmul(h, w2d.t())),
                "qkv": (lambda: mlp.dense(xn, wqd, bq), lambda: torch.matmul(xn, wqd.t()))}
    gemm = {name: (time_ms(kern, 10), time_ms(lib, 10)) for name, (kern, lib) in products.items()}
    for name, (kern_ms, lib_ms) in gemm.items():
        print(f"    dense GEMM {name} alone: kernel {kern_ms:.4f} ms, cuBLAS {lib_ms:.4f} ms")
    record["ln_mlp"].update(gemm_library_ms=gemm["fc1"][1] + gemm["fc2"][1],
                            fc1_ms=gemm["fc1"][0], fc2_ms=gemm["fc2"][0])
    record["ln_dense"].update(gemm_library_ms=gemm["qkv"][1], qkv_ms=gemm["qkv"][0])
    c_rec, d_rec = record["ln_mlp"], record["ln_dense"]
    print(f"    C: {c_rec['ms']:.4f} ms, cuBLAS products {c_rec['gemm_library_ms']:.4f}; "
          f"D: {d_rec['ms']:.4f} ms, cuBLAS product {d_rec['gemm_library_ms']:.4f}")
    del margs, dargs, xd, xn, h, products
    # the f32 pieces (TF32 off): the pre-pass at B's f32 limit (the same
    # function), each GEMM launch alone at C's and D's f32 limit, and cuBLAS
    # on the same f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    xf = T(x)
    xnf = mlp.ln_rows(xf, scale, bias, 1e-6)
    record["ln_rows_f32"] = compare(
        "ln_rows f32", lambda: mlp.ln_rows(xf, scale, bias, 1e-6),
        lambda: mlp.ln_rows_reference(xf, scale, bias, 1e-6), 1e-5, 0.0,
        moved=(xf, scale, bias), flops=8.0 * M * C, kind="f32",
        library=lambda: F.layer_norm(xf, (C,), scale, bias, 1e-6), iters=50)
    w1f, w2f, wqf = T(w1), T(w2), T(wq)
    hf = mlp.dense(xnf, w1f, b1, "gelu")
    gemm = {}
    for name, args, epi, res, flops in (
            ("fc1", (xnf, w1f, b1), "gelu", None, 2.0 * M * C * H),
            ("fc2", (hf, w2f, b2), "residual", xf, 2.0 * M * C * H),
            ("qkv", (xnf, wqf, bq), "bias", None, 2.0 * M * C * 3 * C)):
        gemm[name] = compare(f"dense {name} f32", lambda: mlp.dense(*args, epi, res),
                             lambda: mlp.dense_reference(*args, epi, res), 1e-4, 0.0,
                             moved=(args[0], args[1], args[2]) + ((res,) if res is not None else ()),
                             flops=flops, kind="f32",
                             library=lambda: torch.matmul(args[0], args[1].t()), iters=10)
    record["ln_mlp_f32"].update(
        gemm_library_ms=gemm["fc1"]["library_ms"] + gemm["fc2"]["library_ms"],
        fc1_ms=gemm["fc1"]["ms"], fc2_ms=gemm["fc2"]["ms"],
        fc1_bound_ms=gemm["fc1"]["bound_ms"], fc2_bound_ms=gemm["fc2"]["bound_ms"])
    record["ln_dense_f32"].update(gemm_library_ms=gemm["qkv"]["library_ms"],
                                  qkv_ms=gemm["qkv"]["ms"], qkv_bound_ms=gemm["qkv"]["bound_ms"])
    del xf, xnf, hf, w1f, w2f, wqf

    # E: the attention's tail, gate + blend + proj + residual, bf16 and f32.
    # alpha at one bf16 step of a probability (4e-3). The output in bf16 at
    # 3e-2 abs + 2e-2 rel: an alpha rounding to the neighbouring bf16 value
    # moves its channel of a whole frame's blend, then one bf16 rounding of
    # the proj and one of the sum with x, of outputs up to ~7.
    ys, yt, xr = (rng.randn(B, N, C) for _ in range(3))
    wts, wp = rng.randn(2 * C, 2 * C) / np.sqrt(2 * C), rng.randn(C, C) / np.sqrt(C)
    bts, bp = T(rng.randn(2 * C) * 0.1), T(rng.randn(C) * 0.1)
    print(f"kernel E gate_proj: y_s, y_t, x {(B, N, C)}")
    for dt, atol, rtol, atol_a in ((f32, 1e-4, 0.0, 1e-6), (bf16, 3e-2, 2e-2, 4e-3)):
        gargs = (T(ys, dt), T(yt, dt), T(xr, dt), T(wts, dt), bts, T(wp, dt), bp)
        alpha = mlp.fused_gate_proj(*gargs)[1]
        check_close(f"gate_proj alpha {dt}", alpha, mlp.gate_proj_reference(*gargs)[1], atol_a)
        rec = compare(f"gate_proj {dt}", lambda: mlp.fused_gate_proj(*gargs)[0],
                      lambda: mlp.gate_proj_reference(*gargs)[0], atol, rtol,
                      moved=(*gargs, alpha), flops=2.0 * M * C * C + 2.0 * B * (2 * C) ** 2,
                      kind=kinds[dt], iters=10)
        record[key("gate_proj", dt)] = rec
        if dt == f32:  # the f32 blend bit for bit, the proj GEMM alone beside cuBLAS
            ysf, ytf, xrf, wtsf, _, wpf, _ = gargs
            # the branch means and the gate product, each against its plain
            # version (the means at 1e-6: f32 sums in another order; alpha
            # from the same means at the tail's 1e-6) and timed, also on the
            # device; beside them the library's calls for the same function:
            # torch.mean over N of each branch (two calls), torch.addmm of the
            # product and the bias (the pair softmax not included)
            meansf = mlp.gate_means_reference(ysf, ytf)
            record["gate_means_f32"] = compare(
                "gate_means f32", lambda: mlp.gate_means(ysf, ytf),
                lambda: mlp.gate_means_reference(ysf, ytf), 1e-6, 0.0,
                moved=(ysf, ytf), flops=2.0 * B * N * C, kind="f32",
                library=lambda: (torch.mean(ysf, 1), torch.mean(ytf, 1)), iters=20)
            record["gate_alpha_f32"] = compare(
                "gate_alpha f32", lambda: mlp.gate_alpha(meansf, wtsf, bts),
                lambda: mlp.gate_alpha_reference(meansf, wtsf, bts), 1e-6, 0.0,
                moved=(meansf, wtsf, bts), flops=2.0 * B * (2 * C) ** 2, kind="f32",
                library=lambda: torch.addmm(bts, meansf, wtsf.t()), iters=20)
            for piece, fn, library in (
                    ("gate_means_f32", lambda: mlp.gate_means(ysf, ytf),
                     lambda: (torch.mean(ysf, 1), torch.mean(ytf, 1))),
                    ("gate_alpha_f32", lambda: mlp.gate_alpha(meansf, wtsf, bts),
                     lambda: torch.addmm(bts, meansf, wtsf.t()))):
                record[piece].update(device_ms=time_ms(fn, 20, queued=True),
                                     library_device_ms=time_ms(library, 20, queued=True))
                print(f"    {piece} on the device: kernel {record[piece]['device_ms']:.4f} ms, "
                      f"library {record[piece]['library_device_ms']:.4f} ms")
            rec.update(means_ms=record["gate_means_f32"]["device_ms"],
                       alpha_ms=record["gate_alpha_f32"]["device_ms"])
            del meansf
            yf = mlp.gate_blend(ysf, ytf, alpha)
            check_close("gate_blend f32", yf, mlp.gate_blend_reference(ysf, ytf, alpha), 0.0)
            check_close("gate proj GEMM f32", mlp.dense(yf, wpf, bp, "proj", xrf),
                        mlp.dense_reference(yf, wpf, bp, "proj", xrf), 1e-4)
            rec.update(
                blend_ms=time_ms(lambda: mlp.gate_blend(ysf, ytf, alpha), 20, queued=True),
                proj_ms=time_ms(lambda: mlp.dense(yf, wpf, bp, "proj", xrf), 20, queued=True),
                device_ms=time_ms(lambda: mlp.fused_gate_proj(*gargs), 20, queued=True),
                gemm_library_ms=time_ms(lambda: torch.matmul(yf, wpf.t()), 20, queued=True))
            print("    E f32 on the device: " + ", ".join(
                f"{k} {rec[k]:.4f}" for k in ("means_ms", "alpha_ms", "blend_ms", "proj_ms",
                                               "device_ms", "gemm_library_ms")))
            del ysf, ytf, xrf, wtsf, wpf, yf
    # the bf16 pieces, each against its plain version and timed on the
    # device: the means within one bf16 step (f32 sums in another order),
    # alpha from the same means at 4e-3, the blend from the same alpha bit
    # for bit, the proj GEMM at C's fc2 limits; beside them cuBLAS on the same
    # proj product (gemm_library_ms), which no one call computes with the gate
    ysd, ytd, xrd, wtsd, _, wpd, _ = gargs
    means = mlp.gate_means_reference(ysd, ytd)
    check_close("gate_means bf16", mlp.gate_means(ysd, ytd), means, 1e-6, 2.0 ** -8)
    alpha = mlp.gate_alpha(means, wtsd, bts)
    check_close("gate_alpha bf16", alpha, mlp.gate_alpha_reference(means, wtsd, bts), 4e-3)
    yb = mlp.gate_blend(ysd, ytd, alpha)
    check_close("gate_blend bf16", yb, mlp.gate_blend_reference(ysd, ytd, alpha), 0.0)
    check_close("gate proj GEMM bf16", mlp.dense(yb, wpd, bp, "proj", xrd),
                mlp.dense_reference(yb, wpd, bp, "proj", xrd), 5e-2, 2e-2)
    parts = dict(means_ms=time_ms(lambda: mlp.gate_means(ysd, ytd), 20, queued=True),
                 alpha_ms=time_ms(lambda: mlp.gate_alpha(means, wtsd, bts), 20, queued=True),
                 blend_ms=time_ms(lambda: mlp.gate_blend(ysd, ytd, alpha), 20, queued=True),
                 proj_ms=time_ms(lambda: mlp.dense(yb, wpd, bp, "proj", xrd), 20, queued=True),
                 device_ms=time_ms(lambda: mlp.fused_gate_proj(*gargs), 20, queued=True),
                 gemm_library_ms=time_ms(lambda: torch.matmul(yb, wpd.t()), 20, queued=True))
    record["gate_proj"].update(parts)
    print("    E on the device: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    del gargs, alpha, means, yb, ysd, ytd, xrd

    # F, J (spatial) and G, H (temporal) attention on one qkv projection.
    # bf16 at 1e-2 abs + 1e-2 rel: a probability or an output (magnitudes
    # below 1) rounding to the neighbouring bf16 value on one side only.
    qkv_np = rng.randn(B, N, 3, heads, d)
    att = d ** -0.5
    print(f"kernels F, J spatial and G, H temporal attention: qkv {qkv_np.shape}")
    for dt, atol, rtol in ((f32, 1e-5, 0.0), (bf16, 1e-2, 1e-2)):
        qkv = T(qkv_np, dt)
        q4, k4, v4 = (a.transpose(1, 2) for a in qkv.unbind(2))          # (B, h, N, d) views
        rec = compare(f"spatial (BT, N, C) {dt}", lambda: st_attention.spatial_attention_btc(qkv, att),
                      lambda: st_attention.spatial_reference_btc(qkv, att), atol, rtol,
                      moved=(qkv,), flops=4.0 * B * heads * N * N * d, kind=kinds[dt],
                      library=lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=att))
        record[key("spatial", dt)] = rec
        compare(f"spatial (h, BT, N, d) {dt}", lambda: st_attention.spatial_attention(qkv, att),
                lambda: st_attention.spatial_reference(qkv, att), atol, rtol)
        qc, kc, vc = (a.contiguous() for a in (q4, k4, v4))
        compare(f"fused_attention (B, h, S, d) {dt}", lambda: attention.fused_attention(qc, kc, vc, att),
                lambda: attention._xla_attention(qc, kc, vc, att), atol, rtol)
        # the one-shot range past one 256-key chunk (no model path): the
        # spatial kernel's two passes over the keys
        for S in (577, 1024):
            qc, kc, vc = (T(a, dt) for a in rng.randn(3, 4, heads, S, d))
            compare(f"fused_attention (B, h, S, d), S {S} {dt}",
                    lambda: attention.fused_attention(qc, kc, vc, att),
                    lambda: attention._xla_attention(qc, kc, vc, att), atol, rtol)
        del qc, kc, vc
        q5, k5, v5 = (a.reshape(N_CLIPS, SEQLEN, N, heads, d).permute(0, 2, 3, 1, 4)
                      for a in qkv.unbind(2))                            # (G, N, h, T, d) views
        rec = compare(f"temporal (BT, N, C) {dt}",
                      lambda: st_attention.temporal_attention_fused(qkv, SEQLEN, att),
                      lambda: st_attention.temporal_reference_btc(qkv, SEQLEN, att), atol, rtol,
                      moved=(qkv,), flops=4.0 * B * N * heads * SEQLEN * d, kind=kinds[dt],
                      library=lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=att))
        record[key("temporal", dt)] = rec
        compare(f"temporal (h, BT, N, d) {dt}", lambda: st_attention.temporal_attention(qkv, SEQLEN, att),
                lambda: st_attention.temporal_reference(qkv, SEQLEN, att), atol, rtol)
        # both layouts and the library call on the device, the launches
        # queued behind a sleep, beside the events' ms above
        dev = dict(device_ms=time_ms(
            lambda: st_attention.temporal_attention_fused(qkv, SEQLEN, att), 20, queued=True),
            device_ms_head_leading=time_ms(
                lambda: st_attention.temporal_attention(qkv, SEQLEN, att), 20, queued=True),
            library_device_ms=time_ms(
                lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=att), 20, queued=True))
        rec.update(dev)
        print("    on the device: " + ", ".join(f"{k} {v:.4f}" for k, v in dev.items()))
        # st_mode temporal hands the kernel the projection of one mean token a frame
        qkv1 = T(qkv_np.mean(axis=1, keepdims=True) * np.sqrt(N), dt)
        compare(f"temporal (BT, 1, C), one token a frame {dt}",
                lambda: st_attention.temporal_attention_fused(qkv1, SEQLEN, att),
                lambda: st_attention.temporal_reference_btc(qkv1, SEQLEN, att), atol, rtol)
        # 32 frames (two 16-row tiles) at a head dim of 24 (padded to 32 in bf16)
        qkv32 = T(rng.randn(64, 5, 3, 3, 24), dt)
        for label, kern, plain in (
                ("(BT, N, C)", st_attention.temporal_attention_fused,
                 st_attention.temporal_reference_btc),
                ("(h, BT, N, d)", st_attention.temporal_attention,
                 st_attention.temporal_reference)):
            compare(f"temporal {label}, T 32, d 24 {dt}", lambda: kern(qkv32, 32, 24 ** -0.5),
                    lambda: plain(qkv32, 32, 24 ** -0.5), atol, rtol)
    del qkv, qkv1, qkv32, q4, k4, v4, q5, k5, v5

    # K: blocked attention over the T * N tokens of a clip (st_mode coupling),
    # through fused_attention's dispatch. q, k, v are in-place views of the
    # qkv projection and the output a view of the (BT, N, C) result, as the
    # model calls it (the record), then contiguous tensors. f32 at 2e-5: the
    # kernels' 128-key tiles and the plain version's 512-key blocks rescale
    # and sum in other orders. bf16 at 2e-3 abs + 1e-2 rel: the outputs are
    # means of v over ~1000 keys (|out| ~0.03, at most ~0.3), so rel carries
    # one bf16 step of an output and abs the unnormalised p that round to the
    # neighbouring bf16 value where the running max differs. A last tile of
    # 80 keys dropped or left unmasked would move outputs by ~1e-2 or more
    # (tools/mutate_attention_tail.py).
    S = SEQLEN * N
    print(f"kernel K blocked attention: q, k, v {(N_CLIPS, heads, S, d)} on qkv {qkv_np.shape}")
    for dt, atol, rtol in ((f32, 2e-5, 0.0), (bf16, 2e-3, 1e-2)):
        qkv = T(qkv_np, dt)
        qv, kv, vv = (a.transpose(1, 2) for a in qkv.view(N_CLIPS, S, 3, heads, d).unbind(2))

        def blocked_in_place():
            y = torch.empty((B, N, C), dtype=dt, device=device)
            attention.fused_attention(qv, kv, vv, att,
                                      out=y.view(N_CLIPS, S, heads, d).transpose(1, 2))
            return y

        rec = compare(f"blocked attention, in place {dt}", blocked_in_place,
                      lambda: attention.attention_blocked_reference(qv, kv, vv, att)
                      .transpose(1, 2).reshape(B, N, C), atol, rtol,
                      moved=(qkv,), flops=4.0 * N_CLIPS * heads * S * S * d, kind=kinds[dt],
                      library=lambda: F.scaled_dot_product_attention(qv, kv, vv, scale=att),
                      iters=10)
        # on the device too, the launches queued behind a sleep
        rec["device_ms"] = time_ms(blocked_in_place, 5, queued=True)
        print(f"    on the device: {rec['device_ms']:.4f} ms")
        record[key("attention_blocked", dt)] = rec
        qc, kc, vc = (a.contiguous() for a in (qv, kv, vv))
        compare(f"blocked attention, contiguous {dt}",
                lambda: attention.fused_attention(qc, kc, vc, att),
                lambda: attention.attention_blocked_reference(qc, kc, vc, att), atol, rtol)
        # just above the one-shot limit (a last tile of one key), head dim 32
        qs, ks, vs = (T(a, dt) for a in rng.randn(3, 2, heads, 1025, 32))
        compare(f"blocked attention, S 1025 d 32 {dt}",
                lambda: attention.fused_attention(qs, ks, vs),
                lambda: attention.attention_blocked_reference(qs, ks, vs, 32 ** -0.5), atol, rtol)
    del qkv, qv, kv, vv, qc, kc, vc, qs, ks, vs

    # I: GroupNorm(32, eps 1e-5), 128 frames in the channels-last memory
    # layout cuDNN hands the model, inputs drawn on the card. Each of the 12
    # kinds of site of a forward in bf16 (the cluster kernel) against its
    # plain version, timed on the device beside its bound and F.group_norm on
    # the same frames (the library call where the site has no residual and
    # no ReLU); from them the 52 launches of a forward. Then each of the nine
    # shapes with and without the residual (and the ReLU after it) in f32 (the
    # strided kernel) and bf16, and one bf16 frame beyond the cluster kernel's
    # shared memory (the strided kernel in bf16). bf16 at 2e-2 abs + 1e-2 rel:
    # mul, add or an output up to ~5 rounding to the neighbouring bf16 value.
    gen = torch.Generator(device=device).manual_seed(3)

    def gn_inputs(frames, side, ch, with_res, dt):
        x = (torch.randn(frames, side, side, ch, device=device, generator=gen) * 2 + 0.5).to(dt)
        res = torch.randn(x.shape, device=device, generator=gen).to(dt) if with_res else None
        return (x, torch.rand(ch, device=device, generator=gen) + 0.5,
                torch.randn(ch, device=device, generator=gen) * 0.1, res)

    print("kernel I groupnorm")
    sites = []
    for side, ch, relu, with_res, per in GROUPNORM_SITES:
        x, gs, gb, res = gn_inputs(B, side, ch, with_res, bf16)
        gargs = (x, gs, gb, 32, 1e-5, relu, res)
        x_nchw, gsb, gbb = x.permute(0, 3, 1, 2), gs.to(bf16), gb.to(bf16)
        library = lambda: F.group_norm(x_nchw, 32, gsb, gbb, 1e-5)  # noqa: E731
        name = (f"{side}x{side}x{ch}" + (" +residual" if with_res else "")
                + (" +relu" if relu else ""))
        rec = compare(f"groupnorm {name} bf16", lambda: groupnorm.fused_groupnorm(*gargs),
                      lambda: groupnorm.groupnorm_reference(*gargs), 2e-2, 1e-2,
                      moved=[t for t in (x, gs, gb, res) if t is not None],
                      flops=8.0 * x.numel(), kind="f32",
                      library=library if not relu and not with_res else None)
        # ms on the device (its launches queued behind a sleep: the small
        # sites take less than the wrapper's host work), events_ms as above
        rec.update(events_ms=rec["ms"],
                   ms=time_ms(lambda: groupnorm.fused_groupnorm(*gargs), 20, queued=True),
                   group_norm_ms=time_ms(library, 20, queued=True))
        print(f"    on the device: kernel {rec['ms']:.4f} ms, "
              f"F.group_norm {rec['group_norm_ms']:.4f}")
        sites.append(dict(site=name, launches_per_forward=per, **rec))
        if (side, ch, relu, with_res) == (56, 256, False, False):
            record["groupnorm"] = dict(rec)
        del x, res, gargs, x_nchw
    if sum(site["launches_per_forward"] for site in sites) != per_forward("parallel")["groupnorm"]:
        raise AssertionError("GROUPNORM_SITES do not add up to a forward's GroupNorm launches")
    record["groupnorm"].update(
        sites=sites,
        forward_ms=sum(t["ms"] * t["launches_per_forward"] for t in sites),
        forward_bound_ms=sum(t["bound_ms"] * t["launches_per_forward"] for t in sites),
        forward_group_norm_ms=sum(t["group_norm_ms"] * t["launches_per_forward"] for t in sites))
    print("    a forward's 52 GroupNorms: " + ", ".join(
        f"{k} {record['groupnorm'][k]:.4f}"
        for k in ("forward_ms", "forward_bound_ms", "forward_group_norm_ms")))
    # f32 (the strided kernel) at the site the bf16 record keeps, beside F.group_norm
    x, gs, gb, _ = gn_inputs(B, 56, 256, False, f32)
    gargs = (x, gs, gb, 32, 1e-5, False, None)
    x_nchw = x.permute(0, 3, 1, 2)
    record["groupnorm_f32"] = compare(
        "groupnorm 56x56x256 f32", lambda: groupnorm.fused_groupnorm(*gargs),
        lambda: groupnorm.groupnorm_reference(*gargs), 1e-4, 0.0, moved=(x, gs, gb),
        flops=8.0 * x.numel(), kind="f32",
        library=lambda: F.group_norm(x_nchw, 32, gs, gb, 1e-5))
    del x, gargs, x_nchw
    for side, ch, relu in GROUPNORM_SHAPES:
        for with_res in (False, True):
            for dt, atol, rtol in ((f32, 1e-4, 0.0), (bf16, 2e-2, 1e-2)):
                x, gs, gb, res = gn_inputs(B, side, ch, with_res, dt)
                gargs = (x, gs, gb, 32, 1e-5, relu or with_res, res)
                compare(f"groupnorm {side}x{side}x{ch}{' +residual' if with_res else ''}"
                        f"{' +relu' if relu or with_res else ''} {dt}",
                        lambda: groupnorm.fused_groupnorm(*gargs),
                        lambda: groupnorm.groupnorm_reference(*gargs), atol, rtol)
                del x, res, gargs
    preact = []
    for side, ch in PREACT_GROUPNORM_SHAPES:
        for dt in (f32, bf16):
            x, gs, gb, _ = gn_inputs(B, side, ch, False, dt)
            gargs = (x, gs, gb, 32, 1e-5, True, None)
            rec = compare(f"groupnorm {side}x{side}x{ch} +relu {dt} (preact)",
                          lambda: groupnorm.fused_groupnorm(*gargs),
                          lambda: groupnorm.groupnorm_reference(*gargs),
                          *GROUPNORM_LIMITS[dt], moved=(x, gs, gb), flops=8.0 * x.numel(),
                          kind="f32")
            preact.append(dict(site=f"{side}x{side}x{ch} +relu", dtype=str(dt), **rec))
            del x, gargs
    record["groupnorm"]["preact_sites"] = preact
    x, gs, gb, res = gn_inputs(16, 80, 256, True, bf16)
    gargs = (x, gs, gb, 32, 1e-5, True, res)
    before = kernels.LAUNCHES["groupnorm_strided"]
    compare("groupnorm 80x80x256 +residual +relu bf16, 16 frames (3.2 MB a frame: strided)",
            lambda: groupnorm.fused_groupnorm(*gargs),
            lambda: groupnorm.groupnorm_reference(*gargs), 2e-2, 1e-2)
    if kernels.LAUNCHES["groupnorm_strided"] != before + 1:
        raise AssertionError("a 3.2 MB bf16 frame did not go to the strided GroupNorm kernel")
    del x, res, gargs
    torch.cuda.synchronize()
    record.update(general_attention_checks(device))
    return record


# The head dims of csrc/attention_general.cu held in phase_kernels (the stock
# ViTs' 80 and 96, the tools' 2-head 384, one head's 768, and 24), and the
# ones also timed at the flagship's tokens (197 a frame, 16 frames, the 768
# channels in 768 / d heads; d 80 in vit_huge's 16 heads, 1280 channels,
# since 768 is no multiple of 80).
GENERAL_DIMS = (24, 80, 96, 384, 768)
GENERAL_TIMED = (80, 96, 384, 768)


def general_heads(d: int) -> int:
    """Heads of head dim d at GENERAL_TIMED's shapes."""
    return 16 if d == 80 else 768 // d


def general_attention_checks(device):
    """The spatial, temporal and blocked attention at every head dim of
    GENERAL_DIMS in f32 and bf16 against their plain versions, at small
    token and frame counts: 2 clips of 16 frames of 37 tokens, 2 heads;
    blocked over 1100 keys (through fused_attention's dispatch). Tolerances
    as the older kernels' at the flagship (bf16 1e-2 + 1e-2 rel; blocked f32
    2e-5, bf16 2e-3 + 1e-2 rel: the general kernel's key tiles, 128 keys in
    bf16 and 64 in f32, move the running max at other keys than the plain
    version's 512-key blocks). Then, at GENERAL_TIMED, each timed at the
    flagship's tokens beside its bound and scaled_dot_product_attention,
    the spatial and temporal calls also on the device (``device_ms``); and the general kernels through a
    model (general_attention_model). Returns the records of the kernels
    line: d 384 bf16 at the top, every (d, dtype) under ``by_head_dim``."""
    import torch.nn.functional as F

    from maed_tpu_torch import kernels
    from maed_tpu_torch.ops import attention, st_attention

    rng = np.random.RandomState(3)
    T = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    f32, bf16 = torch.float32, torch.bfloat16
    kinds = {f32: "f32", bf16: "bf16"}
    tol = {f32: (1e-5, 0.0), bf16: (1e-2, 1e-2)}
    blocked_tol = {f32: (2e-5, 0.0), bf16: (2e-3, 1e-2)}
    general = ("spatial_attention_general", "temporal_attention_general",
               "attention_blocked_general")
    print(f"general attention kernels at head dims {GENERAL_DIMS}")
    for d in GENERAL_DIMS:
        att = d ** -0.5
        for dt in (f32, bf16):
            before = {k: kernels.LAUNCHES[k] for k in general}
            qkv = T(rng.randn(2 * SEQLEN, 37, 3, 2, d), dt)
            compare(f"spatial d {d} {dt}", lambda: st_attention.spatial_attention_btc(qkv, att),
                    lambda: st_attention.spatial_reference_btc(qkv, att), *tol[dt])
            compare(f"temporal d {d} {dt}",
                    lambda: st_attention.temporal_attention_fused(qkv, SEQLEN, att),
                    lambda: st_attention.temporal_reference_btc(qkv, SEQLEN, att), *tol[dt])
            q, k, v = (a.transpose(1, 2) for a in T(rng.randn(2, 1100, 3, 2, d), dt).unbind(2))
            compare(f"blocked d {d}, S 1100 {dt}", lambda: attention.fused_attention(q, k, v, att),
                    lambda: attention.attention_blocked_reference(q, k, v, att),
                    *blocked_tol[dt])
            is_bf16 = dt == bf16
            want = (st_attention.general_head_dim(d, is_bf16),
                    st_attention.general_head_dim(d, is_bf16, temporal=True),
                    st_attention.general_head_dim(d, is_bf16))
            got = tuple(kernels.LAUNCHES[k] > before[k] for k in general)
            if got != want:
                raise AssertionError(f"d {d} {dt}: the general kernels launched {got}, want {want}")
    del qkv, q, k, v

    B, N, S = N_CLIPS * SEQLEN, 197, SEQLEN * 197
    records = {name: {"by_head_dim": {}} for name in ("spatial_general", "temporal_general",
                                                      "attention_blocked_general")}
    for d in GENERAL_TIMED:
        heads, att = general_heads(d), d ** -0.5
        qkv_np = rng.randn(B, N, 3, heads, d)
        print(f"general attention at the flagship's tokens: qkv {qkv_np.shape}")
        for dt in (f32, bf16):
            qkv = T(qkv_np, dt)
            q4, k4, v4 = (a.transpose(1, 2) for a in qkv.unbind(2))
            spatial = lambda: st_attention.spatial_attention_btc(qkv, att)  # noqa: E731
            temporal = lambda: st_attention.temporal_attention_fused(qkv, SEQLEN, att)  # noqa: E731
            sp = compare(f"spatial d {d} (BT, N, C) {dt}", spatial,
                         lambda: st_attention.spatial_reference_btc(qkv, att), *tol[dt],
                         moved=(qkv,), flops=4.0 * B * heads * N * N * d, kind=kinds[dt],
                         library=lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=att),
                         iters=10)
            q5, k5, v5 = (a.reshape(N_CLIPS, SEQLEN, N, heads, d).permute(0, 2, 3, 1, 4)
                          for a in qkv.unbind(2))
            tp = compare(f"temporal d {d} (BT, N, C) {dt}", temporal,
                         lambda: st_attention.temporal_reference_btc(qkv, SEQLEN, att), *tol[dt],
                         moved=(qkv,), flops=4.0 * B * N * heads * SEQLEN * d, kind=kinds[dt],
                         library=lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=att),
                         iters=10)
            qv, kv, vv = (a.transpose(1, 2) for a in qkv.view(N_CLIPS, S, 3, heads, d).unbind(2))

            def blocked_in_place():
                y = torch.empty((B, N, heads * d), dtype=dt, device=device)
                attention.fused_attention(qv, kv, vv, att,
                                          out=y.view(N_CLIPS, S, heads, d).transpose(1, 2))
                return y

            bk = compare(f"blocked d {d}, in place {dt}", blocked_in_place,
                         lambda: attention.attention_blocked_reference(qv, kv, vv, att)
                         .transpose(1, 2).reshape(B, N, heads * d), *blocked_tol[dt],
                         moved=(qkv,), flops=4.0 * N_CLIPS * heads * S * S * d, kind=kinds[dt],
                         library=lambda: F.scaled_dot_product_attention(qv, kv, vv, scale=att),
                         iters=3)
            # the short calls also on the device, queued behind a sleep: by
            # events alone they can time the host's enqueue (the wrapper's
            # Python, and the TMA forms' three tensor maps a call), not the kernel
            sp["device_ms"] = time_ms(spatial, 10, queued=True)
            tp["device_ms"] = time_ms(temporal, 10, queued=True)
            for name, rec, over_frames in (("spatial_general", sp, False),
                                           ("temporal_general", tp, True),
                                           ("attention_blocked_general", bk, False)):
                # which kernel the dispatch took at this (d, dtype)
                rec["general_kernel"] = st_attention.general_head_dim(d, dt == bf16, over_frames)
                rec["heads"] = heads
                records[name]["by_head_dim"][f"d{d}_{kinds[dt]}"] = rec
                if d == 384 and dt == bf16:
                    records[name].update(rec)
            del qkv, q4, k4, v4, q5, k5, v5, qv, kv, vv, spatial, temporal
    torch.cuda.synchronize()
    records["general_model_launches"] = general_attention_model(device)
    return records


def general_attention_model(device):
    """The general kernels through the model: one f32 request of 2 clips x
    16 frames at 224 px through ``build_eval_model`` with 1 block of 2 heads
    (head dim 384), parallel (spatial and temporal) and coupling (16 x 197 =
    3152 tokens a clip: the blocked kernel), each against the same request
    through the plain versions (phase_f32's limits); the count of every
    kernel launched from 0 just before to just after the two requests
    through the kernels. At 64 px the random weights' near-degenerate 6D
    outputs turned the kernels' ~1e-7 into 4.9e-4 m of verts (chip run 2 of
    PR 14), as PR 13's demo test saw at 96 px; the flagship's 224 px."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.builder import build_eval_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(5)
    runs = []
    for mode, px in (("parallel", IMG), ("coupling", IMG)):
        model, smpl = build_eval_model(st_mode=mode, num_blocks=1, num_heads=2, img_size=px,
                                       dtype=torch.float32, device=device, seed=4,
                                       allow_synthetic_smpl=True)
        clip = torch.randint(0, 256, (2, SEQLEN, px, px, 3), dtype=torch.uint8, device=device,
                             generator=gen)
        runs.append((mode, model, smpl, clip))
    kernels.reset_launches()
    outs = [model(clip, smpl) for _, model, smpl, clip in runs]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for (mode, model, smpl, clip), got in zip(runs, outs):
        check_outputs(got, clips=2, joints=49)
        want = model(clip, smpl, plain=True)
        for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
            check_close(f"{mode} 1 x 2 heads f32 {key}, kernels vs plain", got[key], want[key],
                        atol)
    print(f"  general kernels through the model: {launches}")
    for name in ("spatial_attention_general", "temporal_attention_general",
                 "attention_blocked_general"):
        if not launches[name]:
            raise AssertionError(f"the 2-head models did not launch {name}: {launches}")
    return launches


def make_requests(device):
    rng = np.random.RandomState(1)
    clips = [torch.from_numpy(rng.randint(0, 256, (N_CLIPS, SEQLEN, IMG, IMG, 3),
                                          dtype=np.uint8)).to(device)
             for _ in range(REQUESTS)]
    jreg = rng.rand(14, NUM_VERTS)
    jreg = torch.from_numpy(jreg / jreg.sum(axis=1, keepdims=True)).to(device, torch.float32)
    return clips, jreg


def check_outputs(out, clips=N_CLIPS, joints=14):
    want = {"theta": (clips, SEQLEN, 85), "verts": (clips, SEQLEN, NUM_VERTS, 3),
            "kp_2d": (clips, SEQLEN, joints, 2), "kp_3d": (clips, SEQLEN, joints, 3),
            "rotmat": (clips, SEQLEN, 24, 3, 3)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)}, want {shape}")
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key}: non-finite values")


def build_flagship(device, dtype, seed=0, st_mode="parallel", num_blocks=6):
    """The released stage-2 MAED (or its sibling of another attention mode or
    depth) through the port's entry point, with seeded random weights and the
    synthetic 6890-vertex body."""
    from maed_tpu_torch.core.builder import build_eval_model

    return build_eval_model(st_mode=st_mode, num_blocks=num_blocks, dtype=dtype, device=device,
                            seed=seed, allow_synthetic_smpl=True)


def worst_err(outs, wants):
    """Max abs difference of verts, kp_3d and theta over pairs of answers."""
    return {k: max(max_abs_err(o[k], w[k]) for o, w in zip(outs, wants))
            for k in ("verts", "kp_3d", "theta")}


def phase_serve(device, clips, jreg):
    """The bf16 flagship answering REQUESTS requests through the kernels;
    returns the launch counts and the answers through the kernels and
    through their plain versions."""
    from maed_tpu_torch import kernels

    t0 = time.perf_counter()
    model, smpl = build_flagship(device, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"built the bf16 flagship in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    model(clips[0], smpl, J_regressor=jreg)  # warmup: Triton compiles here
    torch.cuda.synchronize()

    kernels.reset_launches()
    times, outs = [], []
    for clip in clips:
        t0 = time.perf_counter()
        outs.append(model(clip, smpl, J_regressor=jreg))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    for out in outs:
        check_outputs(out)
    print(f"request ms (bf16, {N_CLIPS}x{SEQLEN}x{IMG}^2 uint8): "
          + ", ".join(f"{t:.2f}" for t in times))
    print(f"launches over {REQUESTS} requests: {launches}")
    expect_launches(launches, "parallel", REQUESTS)
    plains = [model(clip, smpl, J_regressor=jreg, plain=True) for clip in clips]
    print(f"bf16 forward, kernels vs plain over {REQUESTS} requests (no bound here; "
          "see the f32 phase): " + ", ".join(
              f"{k} {err:.3e}" for k, err in worst_err(outs, plains).items()))
    del model
    return launches, outs, plains, times


# phase_export: the artifacts of utils/export.py (file name, batch, weights baked)
ARTIFACTS = (("maed_b8.pt2", N_CLIPS, True), (f"maed_b8.pt2.b2", 2, True),
             ("maed_args_b8.pt2", N_CLIPS, False))


def equal_answers(label, got, want):
    """Raise unless the answers ``got`` (tensors or numpy arrays) equal
    ``want`` bit for bit."""
    for key in ("theta", "verts", "kp_2d", "kp_3d", "rotmat"):
        g = torch.as_tensor(got[key]).to(want[key].device)
        if g.shape != want[key].shape or not torch.equal(g, want[key]):
            raise AssertionError(f"{label}: {key} differs from the eager answer "
                                 f"(max abs {max_abs_err(g, want[key]):.3e})")


def phase_export(device, workdir: Path, clips, jreg, outs, eager_ms):
    """The bf16 flagship of phase_serve (the same seed) exported by
    ``utils.export.export_eval_forward``: baked with uint8 input at batch 8,
    its batch-2 bucket, and in args mode at batch 8, each one's seconds and
    MB. Then, the eager model deleted, the batch-8 artifact loaded and run
    on phase_serve's requests: each answer equals phase_serve's bit for
    bit, and each request launches what an eager one does; an f32 request
    is refused; the args-mode artifact with its weights from the .npz gives
    the first answer bit for bit. Returns the record."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.utils.export import export_eval_forward, load_exported

    model, smpl = build_flagship(device, torch.bfloat16)
    record = {"card": card_identity()}
    for name, batch, bake in ARTIFACTS:
        t0 = time.perf_counter()
        result = export_eval_forward(model, smpl, batch, SEQLEN, IMG, IMG, J_regressor=jreg,
                                     bake_params=bake)
        blob = result if bake else result[0]
        (workdir / name).write_bytes(blob)
        if not bake:
            np.savez(workdir / f"{name}.params.npz", **result[1])
        key = name.split(".pt2")[0] + ("_b2" if name.endswith(".b2") else "")
        record[key] = dict(export_s=time.perf_counter() - t0, mb=len(blob) / 2**20)
        print(f"exported {name} (batch {batch}, {'baked' if bake else 'args mode'}): "
              f"{record[key]['export_s']:.1f} s, {record[key]['mb']:.1f} MB"
              + ("" if bake else f" + {(workdir / f'{name}.params.npz').stat().st_size / 2**20:.1f}"
                                 " MB of .npz"))
    del model, smpl, result, blob
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    fwd = load_exported(workdir / ARTIFACTS[0][0])
    record["load_s"] = time.perf_counter() - t0
    fwd(clips[0])  # warmup
    torch.cuda.synchronize()
    kernels.reset_launches()
    served, times = [], []
    for clip in clips:
        t0 = time.perf_counter()
        served.append(fwd(clip))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    expect_launches(launches, "parallel", REQUESTS)
    for i, (got, want) in enumerate(zip(served, outs)):
        equal_answers(f"served request {i}", got, want)
    print(f"loaded the batch-8 artifact in {record['load_s']:.1f} s; its {REQUESTS} requests equal "
          f"phase_serve's bit for bit, launches as an eager request's: {launches}")
    print(f"request ms ({record['card']}), bf16 8x16x224^2 uint8: served "
          + ", ".join(f"{t:.2f}" for t in times) + "; eager " + ", ".join(f"{t:.2f}" for t in eager_ms))
    try:
        fwd(clips[0].float())
    except ValueError as e:
        print(f"an f32 request is refused: {e}")
    else:
        raise AssertionError("the uint8 artifact took an f32 request")
    del fwd, served

    args = load_exported(workdir / ARTIFACTS[2][0])
    with np.load(workdir / f"{ARTIFACTS[2][0]}.params.npz") as npz:
        params = args.place_params(dict(npz))
    equal_answers("args-mode artifact", args(params, clips[0]), outs[0])
    print("the args-mode artifact's answer equals phase_serve's bit for bit")
    del args, params
    torch.cuda.empty_cache()
    record.update(served_ms=times, eager_ms=eager_ms, launches=launches)
    return record


SERVE_CHILD = """
import atexit, json, runpy, sys
atexit.register(lambda: print("PORT_MODULES " + json.dumps(sorted(
    m for m in sys.modules if m.startswith("maed_tpu_torch"))), flush=True))
sys.argv = ["maed_tpu_torch.serve", *sys.argv[1:]]
runpy.run_module("maed_tpu_torch.serve", run_name="__main__")
"""


def post_npy(conn, images: np.ndarray):
    import io

    buf = io.BytesIO()
    np.save(buf, images)
    t0 = time.perf_counter()
    conn.request("POST", "/predict", body=buf.getvalue())
    r = conn.getresponse()
    body = r.read()
    ms = (time.perf_counter() - t0) * 1e3
    if r.status != 200:
        return r.status, body, ms
    with np.load(io.BytesIO(body)) as npz:
        return r.status, dict(npz), ms


def phase_http(device, workdir: Path, clips, outs, plains, wants, record):
    """``python -m maed_tpu_torch.serve`` over the batch-8 artifact and its
    batch-2 bucket in a child process on a free port: 8 clips and then 3
    (padded into the batch of 8) give phase_serve's answers bit for bit, 2
    clips take the bucket, whose answers are held by BF16_RATIO to the f32
    answers (another batch may round otherwise); an f32 request is a 400.
    The child loads no module of maed_tpu_torch.models or .core. Then
    tools/bench_serve.py against it, and a SIGTERM, after which it exits 0."""
    import http.client
    import signal
    import threading

    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    cmd = [sys.executable, "-c", SERVE_CHILD, "--artifact", str(workdir / ARTIFACTS[0][0]),
           str(workdir / ARTIFACTS[1][0]), "--port", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "ready" in line:
                ready.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the serving child was not ready in 300 s:\n" + "".join(lines)[-3000:])
        port = int(re.search(r"serving on http://[\d.]+:(\d+)", "".join(lines)).group(1))
        print(f"serving child ready in {time.perf_counter() - t0:.1f} s on port {port}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("GET", "/healthz")
        spec = json.loads(conn.getresponse().read())
        if spec.get("buckets") != [2, N_CLIPS] or not spec.get("ready"):
            raise AssertionError(f"/healthz {spec}")
        host = [c.cpu().numpy() for c in clips]
        ms = {}
        status, got, ms["8 clips"] = post_npy(conn, host[0])
        equal_answers("HTTP 8 clips", got, outs[0])
        status, got, ms["3 clips"] = post_npy(conn, host[2][:3])
        equal_answers("HTTP 3 clips (padded to 8)", got, {k: v[:3] for k, v in outs[2].items()})
        status, bucket, ms["2 clips"] = post_npy(conn, host[1][:2])
        bucket = {k: torch.from_numpy(v).to(device) for k, v in bucket.items()}
        same = all(torch.equal(bucket[k], outs[1][k][:2]) for k in bucket)
        print(f"HTTP: 8 and 3 clips equal phase_serve's answers bit for bit; the batch-2 bucket "
              f"{'equals them bit for bit too' if same else 'differs from them'}; request ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
        check_bf16_ratio("batch-2 bucket", [bucket], [{k: v[:2] for k, v in plains[1].items()}],
                         [{k: v[:2] for k, v in wants[1].items()}])
        status, body, _ = post_npy(conn, host[0].astype(np.float32))
        if status != 400 or b"uint8" not in body:
            raise AssertionError(f"an f32 request: {status} {body[:200]!r}")
        conn.close()
        bench = subprocess.run(
            [sys.executable, "-m", "maed_tpu_torch.tools.bench_serve", "--url",
             f"http://127.0.0.1:{port}", "--iters", "10", "--warmup", "2"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if bench.returncode != 0:
            raise AssertionError("bench_serve failed:\n" + bench.stderr[-3000:])
        line = json.loads(bench.stdout.strip().splitlines()[-1])
        print(f"bench_serve ({line['card']}): {line['value']:.2f} clips/s over HTTP, median "
              f"{line['median_latency_ms']:.1f} ms, p90 {line['p90_latency_ms']:.1f} ms a request "
              f"of {line['batch']} clips ({line['request_bytes'] / 2**20:.1f} MB)")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    if rc != 0 or "shut down" not in text:
        raise AssertionError(f"the serving child exited {rc} after SIGTERM:\n{text[-3000:]}")
    modules = json.loads(text.split("PORT_MODULES ", 1)[1].splitlines()[0])
    model_code = [m for m in modules if m.startswith(("maed_tpu_torch.models",
                                                       "maed_tpu_torch.core"))]
    if model_code:
        raise AssertionError(f"the serving child loaded model code: {model_code}")
    print(f"the serving child shut down on SIGTERM; it loaded {len(modules)} modules of the "
          "port, none of maed_tpu_torch.models or .core")
    record.update(http_ms=ms, bucket_bit_equal=same, bench=line)
    print(json.dumps({"serve": record}))


def phase_device_crop(device):
    """DATASET.DEVICE_CROP on the card: 8 clips x 16 frames of the fixture
    JPEGs (480 x 360), packed by the eval transform (raw frames and each
    frame's affine for a seeded box), cropped and normalized to 224^2 by
    ``ops.image.apply_device_preproc`` on the card; against the same
    function on the CPU (1e-4) and against the host's uint8 crop of the
    default path (0.05, tests/test_device_preproc.py's bound)."""
    from maed_tpu_torch import native
    from maed_tpu_torch.data.transforms import build_eval_transforms
    from maed_tpu_torch.ops.image import apply_device_preproc, device_normalize

    rng = np.random.RandomState(12)
    frames = [native.decode(p.read_bytes()) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    pack_tf = build_eval_transforms(IMG, IMG, device_crop=True)
    host_tf = build_eval_transforms(IMG, IMG, device_normalize=True)
    packs, crops = [], []
    for _ in range(N_CLIPS):
        inst = {"clip": [frames[i] for i in rng.randint(0, len(frames), SEQLEN)],
                "bbox": rng.uniform([180, 130, 140, 140], [300, 230, 260, 260], (SEQLEN, 4))}
        packs.append(pack_tf(dict(inst)))
        crops.append(host_tf(dict(inst))["clip"])
    raw = torch.from_numpy(np.stack([p["clip"] for p in packs]))
    trans = torch.from_numpy(np.stack([p["trans"] for p in packs]))
    pack = {"frames": raw.to(device), "trans": trans.to(device)}
    got = apply_device_preproc(pack, IMG, IMG)
    if got.shape != (N_CLIPS, SEQLEN, IMG, IMG, 3) or got.dtype != torch.float32:
        raise AssertionError(f"device crop: {got.dtype} {tuple(got.shape)}")
    check_close("device crop, card vs CPU", got.cpu(),
                apply_device_preproc({"frames": raw, "trans": trans}, IMG, IMG), 1e-4)
    host = device_normalize(torch.from_numpy(np.stack(crops)))
    err = max_abs_err(got.cpu(), host)
    print(f"  device crop vs the host's uint8 crop: max abs err {err:.3e} (bound 0.05)")
    if not err < 0.05:
        raise AssertionError(f"device crop: {err:.3e} from the host's uint8 crop")
    ms = time_ms(lambda: apply_device_preproc(pack, IMG, IMG), 10)
    print(f"  device crop of {N_CLIPS}x{SEQLEN} frames of {raw.shape[3]}x{raw.shape[2]} "
          f"({card_identity()}): {ms:.3f} ms; {raw.numel() / 2**20:.1f} MB of raw frames and "
          f"{trans.numel() * 4 / 2**10:.1f} KB of affines shipped, against "
          f"{np.stack(crops).nbytes / 2**20:.1f} MB of uint8 crops")


def phase_f32(device, clips, jreg, bf16_outs, bf16_plains):
    """One f32 forward through the kernels (its launches counted from 0, those
    of an f32 parallel forward) and one through their plain versions, TF32 off
    for both, which must agree; a second forward through the kernels timed.
    Then the bf16 answers through the kernels must lie about as close to the
    f32 plain answers as the bf16 answers through the plain versions do
    (BF16_RATIO). Returns the f32 plain answers and the launches."""
    from maed_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, smpl = build_flagship(device, torch.float32)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = model(clips[0], smpl, J_regressor=jreg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    expect_launches(launches, "parallel", 1, dtype=torch.float32)
    wants = [model(clip, smpl, J_regressor=jreg, plain=True) for clip in clips]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model(clips[1], smpl, J_regressor=jreg)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t2) * 1e3
    print(f"f32 forward: kernels {(t1 - t0) * 1e3:.1f} ms, plain {(t2 - t1) * 1e3:.1f} ms "
          f"for {len(clips)} (first calls, host clock); kernels again {warm_ms:.1f} ms "
          f"({card_identity()}); launches as expected")
    check_outputs(got)
    for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
        check_close(f"f32 forward {key}, kernels vs plain", got[key], wants[0][key], atol)

    check_bf16_ratio("parallel", bf16_outs, bf16_plains, wants)
    return wants, launches


def check_bf16_ratio(label, bf16_outs, bf16_plains, wants):
    """The bf16 answers through the kernels must lie about as close to the f32
    plain answers ``wants`` as the bf16 answers through the plain versions do."""
    kern, plain = worst_err(bf16_outs, wants), worst_err(bf16_plains, wants)
    for key in ("verts", "kp_3d"):
        print(f"  {label}: bf16 {key} vs f32 plain: through the kernels {kern[key]:.3e}, "
              f"through the plain versions {plain[key]:.3e}, ratio "
              f"{kern[key] / plain[key]:.3f} (bound {BF16_RATIO})")
        if not kern[key] <= BF16_RATIO * plain[key]:
            raise AssertionError(f"{label}: bf16 {key}: the kernels' answer is {kern[key]:.3e} "
                                 f"from the f32 answer, beyond {BF16_RATIO} x {plain[key]:.3e}")
    print(f"  {label}: bf16 theta vs f32 plain (no bound: whole rotations): kernels "
          f"{kern['theta']:.3e}, plain {plain['theta']:.3e}")


def f32_agreement(device, mode, clip, jreg, num_blocks=2):
    """One f32 forward of a ``num_blocks``-deep model of ``mode`` through the
    kernels and one through their plain versions, within phase_f32's limits
    (TF32 is off since that phase). Returns the model and its body."""
    model, smpl = build_flagship(device, torch.float32, st_mode=mode, num_blocks=num_blocks)
    got = model(clip, smpl, J_regressor=jreg)
    want = model(clip, smpl, J_regressor=jreg, plain=True)
    check_outputs(got, clips=clip.shape[0], joints=jreg.shape[0])
    for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
        check_close(f"{mode} f32 forward, depth {num_blocks}, {key}, kernels vs plain",
                    got[key], want[key], atol)
    return model, smpl


def make_windows(smpl, device):
    """The eval protocol's input, made from a seed: an h36m-style (17, V)
    regressor and, per batch of EVAL_BATCHES, a dict of POOL-frame uint8
    windows, a ``valid`` mask with about a tenth of the frames off, random GT
    theta, and GT joints of the body on that theta through the regressor and
    the 3dpw protocol's 14-joint selection, confidence 1."""
    from maed_tpu_torch.ops.joints import H36M_TO_J14
    from maed_tpu_torch.ops.smpl import smpl_forward

    rng = np.random.RandomState(2)
    jreg = rng.rand(17, NUM_VERTS) ** 8  # a few vertices each, so that the joints lie apart
    jreg = (jreg / jreg.sum(axis=1, keepdims=True)).astype(np.float32)
    jreg_dev = torch.from_numpy(jreg).to(device)
    batches = []
    for n in EVAL_BATCHES:
        theta = np.zeros((n, POOL, 85), np.float32)
        theta[..., 3:75] = rng.randn(n, POOL, 72) * 0.2
        theta[..., 75:] = rng.randn(n, POOL, 10) * 0.5
        flat = torch.from_numpy(theta.reshape(-1, 85)).to(device)
        with torch.inference_mode():
            verts = smpl_forward(smpl, flat[:, 75:], pose_axis_angle=flat[:, 3:75])["vertices"]
            kp = torch.einsum("jv,bvk->bjk", jreg_dev, verts)[:, H36M_TO_J14]
        kp = kp.reshape(n, POOL, 14, 3).cpu().numpy()
        kp3d = np.concatenate([kp, np.ones((n, POOL, 14, 1), np.float32)], axis=-1)
        batches.append({
            "images": rng.randint(0, 256, (n, POOL, IMG, IMG, 3), dtype=np.uint8),
            "kp_3d": kp3d, "kp_2d": kp3d[..., [0, 1, 3]], "theta": theta,
            "valid": rng.rand(n, POOL) < 0.9,
            "instance_id": np.arange(n * POOL).reshape(n, POOL),
            "bbox": rng.rand(n, POOL, 4).astype(np.float32)})
    return batches, jreg


def stamped(batches, stamps):
    """``batches`` as a loader that notes the time each batch is asked for."""
    for batch in batches:
        stamps.append(time.perf_counter())
        yield batch
    stamps.append(time.perf_counter())


def check_accumulators(evaluator, poses):
    want = {"pred_verts": (NUM_VERTS, 3), "pred_j3d": (14, 3), "pred_j2d": (14, 2),
            "pred_theta": (85,), "pred_rotmat": (24, 3, 3), "target_j3d": (14, 4),
            "target_j2d": (14, 3), "target_theta": (85,), "instance_id": (), "bboxes": (4,)}
    got = {key: np.concatenate(parts, axis=0) for key, parts in evaluator.accumulators.items()}
    if set(got) != set(want):
        raise AssertionError(f"accumulators {sorted(got)}, want {sorted(want)}")
    for key, tail in want.items():
        if got[key].shape != (poses,) + tail:
            raise AssertionError(f"{key}: shape {got[key].shape}, want {(poses,) + tail}")
        if not np.isfinite(got[key]).all():
            raise AssertionError(f"{key}: non-finite values")
    return got


def phase_eval(device):
    """This slice's path at full width: the bf16 coupling MAED under
    ``Evaluator.run`` over 13 windows, 16 sub-clip forwards of 8 x 16 x 224^2
    through the blocked attention kernel. Then the coupling forward's bf16
    ratio rule, one f32 coupling request at full width and depth through the
    kernels (K's f32 kernel six times) against its plain versions, and the
    same protocol in f32 at depth 2 through the kernels and through their
    plain versions. Returns the launch counts of the run and of the f32
    request."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.evaluate import Evaluator

    model, smpl = build_flagship(device, torch.bfloat16, st_mode="coupling")
    batches, jreg = make_windows(smpl, device)
    jreg_dev = torch.from_numpy(jreg).to(device)
    poses = int(sum(b["valid"].sum() for b in batches))
    forwards = len(batches) * (POOL // SEQLEN)
    clip = torch.from_numpy(batches[0]["images"][:, ::POOL // SEQLEN]).to(device)
    model(clip, smpl, J_regressor=jreg_dev)  # warmup
    torch.cuda.synchronize()

    def forward(images, J_regressor):
        return model(images, smpl, J_regressor=J_regressor)

    evaluator, stamps = Evaluator(smpl), []
    kernels.reset_launches()
    metrics, counted = evaluator.run(forward, stamped(batches, stamps), seqlen=SEQLEN, interp=1,
                                     dataset_name="3dpw", J_regressor=jreg,
                                     batch_size=EVAL_BATCHES[0])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"eval protocol (bf16 coupling, {sum(EVAL_BATCHES)} windows x {POOL} frames, "
          f"{forwards} sub-clip forwards): window batch s "
          + ", ".join(f"{b - a:.3f}" for a, b in zip(stamps, stamps[1:])))
    print(f"launches over the run: {launches}")
    # beside the forwards: one rebuild of the GT vertices (a chunk of up to 5000 poses)
    expect_launches(launches, "coupling", forwards, extra={"skinning": 1})
    if counted != poses:
        raise AssertionError(f"{counted} poses evaluated, want valid.sum() = {poses}")
    if sorted(metrics) != ["accel", "accel_err", "mpjpe", "pa-mpjpe", "pve"] \
            or not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"metrics {metrics}")
    check_accumulators(evaluator, poses)
    ms = time_ms(lambda: model(clip, smpl, J_regressor=jreg_dev), 4)
    print(f"coupling sub-clip forward (bf16, {N_CLIPS}x{SEQLEN}x{IMG}^2 uint8): {ms:.2f} ms "
          "(device, mean of 4)")

    # the bf16 ratio rule for the coupling forward, on the first sub-clip
    bf16_out = model(clip, smpl, J_regressor=jreg_dev)
    bf16_plain = model(clip, smpl, J_regressor=jreg_dev, plain=True)
    del model
    f32_model, _ = build_flagship(device, torch.float32, st_mode="coupling")
    want = f32_model(clip, smpl, J_regressor=jreg_dev, plain=True)
    check_bf16_ratio("coupling", [bf16_out], [bf16_plain], [want])

    # the f32 coupling request (the eval CLI's dtype, TF32 off since
    # phase_f32): launches counted from 0, within phase_f32's limits of its
    # plain answer, then timed warm on the host clock
    kernels.reset_launches()
    got = f32_model(clip, smpl, J_regressor=jreg_dev)
    torch.cuda.synchronize()
    f32_launches = dict(kernels.LAUNCHES)
    expect_launches(f32_launches, "coupling", 1, dtype=torch.float32)
    check_outputs(got, joints=jreg_dev.shape[0])
    for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
        check_close(f"coupling f32 request {key}, kernels vs plain", got[key], want[key], atol)
    t0 = time.perf_counter()
    f32_model(clip, smpl, J_regressor=jreg_dev)
    torch.cuda.synchronize()
    print(f"coupling f32 request ({N_CLIPS}x{SEQLEN}x{IMG}^2 uint8, 6 blocks): "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host clock, warm; {card_identity()}); "
          f"launches as expected, attention_blocked {f32_launches['attention_blocked']}")
    del f32_model, got

    # f32 at depth 2: the forward, then the whole protocol over 2 windows,
    # through the kernels and through their plain versions. Accumulators
    # within phase_f32's limits; the metrics (mm) within 0.05 mm, half of what
    # points 1e-4 m apart could move a mean distance.
    model, smpl = f32_agreement(device, "coupling", clip[:2], jreg_dev)
    small = [{key: value[:2] for key, value in batches[0].items()}]
    runs = []
    for plain in (False, True):
        ev = Evaluator(smpl)
        got, _ = ev.run(lambda x, j, plain=plain: model(x, smpl, J_regressor=j, plain=plain),
                        small, seqlen=SEQLEN, dataset_name="3dpw", J_regressor=jreg,
                        batch_size=2, verbose=False)
        runs.append((got, check_accumulators(ev, int(small[0]["valid"].sum()))))
    (m_kern, a_kern), (m_plain, a_plain) = runs
    for key, atol in (("pred_verts", 1e-4), ("pred_j3d", 1e-4), ("pred_theta", 1e-3)):
        check_close(f"coupling f32 protocol, depth 2, {key}, kernels vs plain",
                    torch.from_numpy(a_kern[key]), torch.from_numpy(a_plain[key]), atol)
    for key, value in m_kern.items():
        print(f"  coupling f32 protocol {key}: kernels {value:.4f} mm, plain {m_plain[key]:.4f} mm")
        if not abs(value - m_plain[key]) <= 0.05:
            raise AssertionError(f"{key}: {value} mm through the kernels, {m_plain[key]} mm "
                                 "through the plain versions")
    return launches, f32_launches


def phase_modes(device, clip, jreg):
    """The attention modes that need no kernel of their own: one bf16 request
    at full width and depth each (launch counts per mode, outputs finite) and
    the f32 kernels-vs-plain agreement at depth 2."""
    from maed_tpu_torch import kernels

    for mode in ("vanilla", "temporal", "series"):
        model, smpl = build_flagship(device, torch.bfloat16, st_mode=mode)
        model(clip, smpl, J_regressor=jreg)  # warmup
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = model(clip, smpl, J_regressor=jreg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        expect_launches(dict(kernels.LAUNCHES), mode, 1)
        check_outputs(out, clips=clip.shape[0])
        print(f"{mode}: bf16 request {ms:.2f} ms, launches as expected")
        del model
        f32_agreement(device, mode, clip[:2], jreg)


# The rest of the model surface at full width (build_encoder): each stock ViT
# on one clip of 16 frames, (factory, frame size, st_mode, depth: None for the
# factory's own); vit_large_patch16_384's coupling mode cut to 2 blocks (K
# over 16 x 577 tokens), a cut of depth only
SURFACE_VITS = (("vit_small_patch16_224", 224, "parallel", None),
                ("vit_large_patch16_384", 384, "parallel", None),
                ("vit_huge_patch16_224", 224, "parallel", None),
                ("vit_large_patch16_384", 384, "coupling", 2))
# the pre-activation ResNetV2's GroupNorms a forward: three a bottleneck, the
# final norm (no stem norm, no norm in a downsample)
PREACT_LAYERS = (3, 4, 9)
PREACT_NORMS = 3 * sum(PREACT_LAYERS) + 1
# f32 features through the kernels against the plain versions (the ViTs'
# normed cls tokens, of magnitude up to ~4): verts' limit of phase_f32
SURFACE_F32_ATOL = 1e-4


# The kernel that each stock ViT's head dim must reach, stated here rather
# than asked of the port's dispatch: (head dim, bf16) -> the kernels of the
# spatial, the temporal and the blocked attention. In bf16, d 80 and 96 lie
# outside the wgmma kernels' head dims (16, 32, 64, 128), so spatial and
# blocked attention go to csrc/attention_general.cu; temporal attention and
# every f32 form take any d up to 128 in csrc/st_attention.cu.
OWN_ATTENTION = ("spatial_attention", "temporal_attention", "attention_blocked")
GENERAL_ATTENTION = ("spatial_attention_general", "temporal_attention",
                     "attention_blocked_general")
STOCK_ATTENTION = {(64, True): OWN_ATTENTION, (64, False): OWN_ATTENTION,
                   (80, True): GENERAL_ATTENTION, (80, False): OWN_ATTENTION,
                   (96, True): GENERAL_ATTENTION, (96, False): OWN_ATTENTION}


def encoder_launches(mode, depth, dtype, head_dim):
    """Launches of a stock ViT's forward alone: per_forward's without the
    hybrid stem's GroupNorms and the body's skinning, the attention at
    head_dim on the kernels STOCK_ATTENTION names."""
    counts = dict(per_forward(mode, depth, dtype), skinning=0, groupnorm=0, groupnorm_strided=0)
    per = {name: counts[name] for name in OWN_ATTENTION}
    counts.update(dict.fromkeys(OWN_ATTENTION + GENERAL_ATTENTION, 0))
    for own, name in zip(OWN_ATTENTION, STOCK_ATTENTION[head_dim, dtype == torch.bfloat16]):
        counts[name] += per[own]
    return counts


def check_counts(label, launches, want):
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {name} launched {launches[name]} times, want {n}")


def check_norm_sites(label, model, run, dt):
    """Every GroupNorm of ``model`` in ``run(model)`` (through the kernels)
    held against its plain version on the very input it was given there,
    within GROUPNORM_LIMITS[dt]: kernel I at each site on the model's own
    activations, apart from the convolutions around it."""
    from maed_tpu_torch.models.resnetv2 import GroupNormAct

    seen = []
    handles = [m.register_forward_hook(
        lambda module, args, kwargs, out: seen.append((module, args, kwargs, out)),
        with_kwargs=True) for m in model.modules() if isinstance(m, GroupNormAct)]
    try:
        with torch.inference_mode():
            run(model)
    finally:
        for handle in handles:
            handle.remove()
    atol, rtol = GROUPNORM_LIMITS[dt]
    worst = 0.0
    with torch.inference_mode():
        for i, (module, args, kwargs, got) in enumerate(seen):
            want = module(args[0], True, *args[2:], **kwargs).float()
            got = got.float()
            excess = ((got - want).abs() - (atol + rtol * want.abs())).max().item()
            err = max_abs_err(got, want)
            worst = max(worst, err)
            if not torch.isfinite(got).all() or excess > 0:
                raise AssertionError(f"{label} {dt}: GroupNorm site {i} of {tuple(args[0].shape)} "
                                     f"(ReLU {module.apply_act}): max abs err {err:.3e} beyond "
                                     f"atol {atol:g} rtol {rtol:g}")
    print(f"  {label} {dt}: {len(seen)} GroupNorm sites through kernel I, each within atol "
          f"{atol:g} rtol {rtol:g} of its plain version on the same input (worst {worst:.3e})")
    return len(seen)


def surface_pair(label, build, run, want_launches, f64=None, norm_sites=0):
    """``run(model)`` of the f32 and the bf16 model ``build(dtype)`` gives,
    through the kernels (the launches counted from 0 and held to
    ``want_launches(dtype)``) and through the plain versions: the f32
    answers within SURFACE_F32_ATOL, or, given ``f64`` (the plain versions'
    answer in f64), through the kernels at most F32_GRAD_RATIO times as far
    from it (relative L2) as through the plain versions; the bf16 answer
    through the kernels at most BF16_RATIO times as far from the f32 plain
    one as through the plain versions (max abs), and, given ``f64``, at most
    BF16_RATIO times as far from the f64 answer (relative L2) as through the
    plain versions. Given ``norm_sites``, each model's
    GroupNorms also one by one (check_norm_sites), that many of them. Returns
    the first calls' ms (host clock)."""
    from maed_tpu_torch import kernels

    answers, ms = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        model = build(dt)
        with torch.inference_mode():
            kernels.reset_launches()
            t0 = time.perf_counter()
            got = run(model, False)
            torch.cuda.synchronize()
            ms[dt] = (time.perf_counter() - t0) * 1e3
            check_counts(f"{label} {dt}", kernels.LAUNCHES, want_launches(dt))
            answers[dt] = (got.float(), run(model, True).float())
        if not torch.isfinite(answers[dt][0]).all():
            raise AssertionError(f"{label} {dt}: non-finite features")
        if norm_sites and check_norm_sites(label, model, lambda m: run(m, False), dt) != norm_sites:
            raise AssertionError(f"{label} {dt}: not {norm_sites} GroupNorm sites")
        del model
    (got, want), (bgot, bwant) = answers[torch.float32], answers[torch.bfloat16]
    print(f"  {label}: f32 features' largest magnitude {want.abs().max().item():.3e}")
    if f64 is None:
        check_close(f"{label} f32 features, kernels vs plain", got, want, SURFACE_F32_ATOL)
    else:
        ref = f64()
        kern64, plain64 = rel_l2(got, ref), rel_l2(want, ref)
        print(f"  {label}: f32 features vs f64 plain (relative L2): kernels {kern64:.3e}, "
              f"plain {plain64:.3e}, ratio {kern64 / plain64:.3f} (bound {F32_GRAD_RATIO}); "
              f"kernels vs plain max abs {max_abs_err(got, want):.3e}")
        if not kern64 <= F32_GRAD_RATIO * plain64:
            raise AssertionError(f"{label}: f32 features {kern64:.3e} from the f64 answer, "
                                 f"beyond {F32_GRAD_RATIO} x {plain64:.3e}")
        # bf16 by relative L2 from the f64 answer too, which a max abs error
        # that the shared bf16 convolutions set cannot show
        kern64, plain64 = rel_l2(bgot, ref), rel_l2(bwant, ref)
        print(f"  {label}: bf16 features vs f64 plain (relative L2): kernels {kern64:.3e}, "
              f"plain {plain64:.3e}, ratio {kern64 / plain64:.3f} (bound {BF16_RATIO})")
        if not kern64 <= BF16_RATIO * plain64:
            raise AssertionError(f"{label}: bf16 features {kern64:.3e} from the f64 answer, "
                                 f"beyond {BF16_RATIO} x {plain64:.3e}")
    kern, plain = max_abs_err(bgot, want), max_abs_err(bwant, want)
    print(f"  {label}: bf16 features vs f32 plain: kernels {kern:.3e}, plain {plain:.3e}, "
          f"ratio {kern / plain:.3f} (bound {BF16_RATIO}); first calls f32 "
          f"{ms[torch.float32]:.1f} ms, bf16 {ms[torch.bfloat16]:.1f} ms; launches as expected")
    if not kern <= BF16_RATIO * plain:
        raise AssertionError(f"{label}: bf16 features {kern:.3e} from the f32 answer, beyond "
                             f"{BF16_RATIO} x {plain:.3e}")
    return ms


def phase_surface(device):
    """The stock ViTs and the pre-activation ResNetV2 at full width, as a user
    builds them (``build_encoder`` with seeded random weights), through the
    kernels and their plain versions in f32 and bf16 (``surface_pair``):
    vit_small_patch16_224 (head dim 96, a qkv without bias, MLP 2304),
    vit_large_patch16_384 (577 tokens a frame, C 1024, MLP 4096) in the
    parallel mode and, at 2 blocks, in the coupling mode (K over 9232
    tokens), vit_huge_patch16_224 (head dim 80, C 1280, MLP 5120), each on
    one clip of 16 frames; ResNetV2(preact=True, layers (3, 4, 9)) on 16
    frames at 224^2 (its f32 held to an f64 run); and the f32 flagship MAED's
    ``extract_feature`` on 2 clips. Returns the f32 launches of the ViTs'
    parallel forwards."""
    import functools

    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.builder import build_encoder
    from maed_tpu_torch.models.resnetv2 import ResNetV2
    from maed_tpu_torch.models.vit import FACTORIES, VisionTransformer

    # f32 is f32 arithmetic on both paths: a TF32 conv would turn the paths'
    # last-bit differences into ~1e-3 relative ones (phase_f32 sets the same)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(31)
    f32_parallel = dict.fromkeys(kernels.LAUNCHES, 0)
    for name, img, mode, depth in SURFACE_VITS:
        frames = torch.randn(SEQLEN, img, img, 3, device=device, generator=gen)
        with torch.device("meta"):
            shape = FACTORIES[name](st_mode=mode)
        factory = name
        if depth is not None:  # the factory's model at another depth
            factory = functools.partial(VisionTransformer, depth=depth, **{
                k: getattr(shape, k) for k in ("embed_dim", "num_heads", "mlp_ratio", "qkv_bias",
                                               "hybrid", "patch_size", "representation_size",
                                               "img_size")})

        def build(dt, factory=factory, mode=mode):
            return build_encoder(factory, st_mode=mode, dtype=dt, device=device, seed=5)

        head_dim, blocks = shape.embed_dim // shape.num_heads, depth or shape.depth
        want = functools.partial(encoder_launches, mode, blocks, head_dim=head_dim)
        surface_pair(f"{name} {mode} ({blocks} blocks)", build,
                     lambda m, plain, x=frames: m(x, SEQLEN, plain=plain),
                     lambda dt: want(dt))
        if mode == "parallel":
            for key, n in want(torch.float32).items():
                f32_parallel[key] += n
        del frames
    # The pre-activation stem's residual stream runs through 16 blocks with
    # no norm on it, and its norms divide by the small spread of a large
    # stream: f32 rounding on either path grows to ~1e-4 of features ~5 (PERF.md
    # section 6), so its f32 answer is held to the f64 one as phase_train
    # holds the step's gradient
    frames = torch.randn(SEQLEN, IMG, IMG, 3, device=device, generator=gen).permute(0, 3, 1, 2)
    norms = dict.fromkeys(kernels.LAUNCHES, 0)
    stem = functools.partial(ResNetV2, layers=PREACT_LAYERS, preact=True)

    def stem_f64():
        model = build_encoder(stem, dtype=torch.float64, device=device, seed=6)
        with torch.inference_mode():
            return model(frames.double(), plain=True)

    surface_pair(
        f"ResNetV2(preact=True, layers={PREACT_LAYERS})",
        lambda dt: build_encoder(stem, dtype=dt, device=device, seed=6),
        lambda m, plain: m(frames, plain),
        lambda dt: dict(norms, **{"groupnorm" if dt == torch.bfloat16 else "groupnorm_strided":
                                  PREACT_NORMS}),
        f64=stem_f64, norm_sites=PREACT_NORMS)
    del frames
    # extract_feature of the f32 flagship: the encoder's launches alone
    clips = torch.from_numpy(np.random.RandomState(32).randint(
        0, 256, (2, SEQLEN, IMG, IMG, 3), dtype=np.uint8)).to(device)
    model, _ = build_flagship(device, torch.float32)
    kernels.reset_launches()
    feat = model.extract_feature(clips)
    torch.cuda.synchronize()
    check_counts("extract_feature f32", kernels.LAUNCHES,
                 dict(per_forward("parallel", dtype=torch.float32), skinning=0))
    if tuple(feat.shape) != (2, SEQLEN, 768):
        raise AssertionError(f"extract_feature: shape {tuple(feat.shape)}")
    check_close("extract_feature f32, kernels vs plain", feat,
                model.extract_feature(clips, plain=True), SURFACE_F32_ATOL)
    return f32_parallel


def consistent_targets(rng, smpl, n, frames, device):
    """Self-consistent targets for n clips of ``frames`` frames (as
    tools/bench_train.py makes them): smooth pose tracks between random
    anchor poses, a shape a clip, a unit camera; theta (n, frames, 85), the
    body's 49 joints with confidence 1 (n, frames, 49, 4) and their
    weak-perspective projection (n, frames, 49, 3), so that zero loss is
    reachable."""
    from maed_tpu_torch.ops.geometry import weak_perspective_projection
    from maed_tpu_torch.ops.smpl import smpl_forward

    anchors = rng.randn(n, 4, 72).astype(np.float32) * 0.4
    t = np.linspace(0, 3, frames)
    i0 = np.minimum(t.astype(int), 2)
    w = (0.5 - 0.5 * np.cos(np.pi * (t - i0)))[None, :, None].astype(np.float32)
    pose = (1 - w) * anchors[:, i0] + w * anchors[:, i0 + 1]
    shape = np.repeat(rng.randn(n, 1, 10).astype(np.float32) * 0.3, frames, axis=1)
    cam = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, frames, 1))
    pose_d, shape_d, cam_d = (torch.from_numpy(a).to(device) for a in (pose, shape, cam))
    with torch.no_grad():
        joints = smpl_forward(smpl, shape_d.reshape(-1, 10),
                              pose_axis_angle=pose_d.reshape(-1, 72))["joints"]
        joints = joints.reshape(n, frames, 49, 3)
        kp2d = weak_perspective_projection(joints, cam_d)
    conf = torch.ones((n, frames, 49, 1), device=device)
    return {"theta": torch.cat([cam_d, pose_d, shape_d], dim=-1),
            "kp_3d": torch.cat([joints, conf], dim=-1), "kp_2d": torch.cat([kp2d, conf], dim=-1)}


def make_train_batch(smpl, device, n2d=TRAIN_2D, n3d=TRAIN_3D, n_img=TRAIN_IMAGES):
    """One stage-2 step's batches: n2d + n3d uint8 clips of SEQLEN frames
    (the 2D clips first) and n_img uint8 images at IMG^2, with targets from
    :func:`consistent_targets`."""
    rng = np.random.RandomState(3)
    n_vid = n2d + n3d
    frames = rng.randint(0, 256, (n_vid * SEQLEN + n_img, IMG, IMG, 3), dtype=np.uint8)
    frames = torch.from_numpy(frames).to(device)
    tgt2 = consistent_targets(rng, smpl, n2d, SEQLEN, device)
    tgt3 = consistent_targets(rng, smpl, n3d, SEQLEN, device)
    tgti = consistent_targets(rng, smpl, n_img, 1, device)
    vid = {"images": frames[:n_vid * SEQLEN].reshape(n_vid, SEQLEN, IMG, IMG, 3),
           "target_2d": {"kp_2d": tgt2["kp_2d"]},
           "target_3d": {"kp_2d": tgt3["kp_2d"], "kp_3d": tgt3["kp_3d"], "theta": tgt3["theta"],
                         "w_smpl": torch.ones((n3d, SEQLEN), device=device)}}
    img = {"image": frames[n_vid * SEQLEN:], "kp_2d": tgti["kp_2d"][:, 0],
           "kp_3d": tgti["kp_3d"][:, 0], "theta": tgti["theta"][:, 0],
           "w_smpl": torch.ones((n_img,), device=device)}
    return vid, img


class TrainRecipe:
    """tools/bench_train.py's optimizer settings: Adam at 5e-5, no weight
    decay, two warmup epochs at a tenth of the rate, a milestone at 30."""
    OPTIM, LR, WD, MOMENTUM = "adam", 5e-5, 0.0, 0.9
    WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES = 2, 0.1, [30]


def train_steps(model, smpl, batch, steps, plain=False, seed=7):
    """``steps`` stage-2 steps of ``model`` from a new optimizer and a
    generator seeded with ``seed``. Returns the metrics of each step, the
    first step's whole gradient (one f32 vector), its kernel launches, the
    host-clock ms of each step (CUDA-synchronised) and the peak device
    memory over the steps."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.parallel.train_step import (debug_nan_params, make_optimizer,
                                                    make_train_step)

    device = next(model.parameters()).device
    optimizer = make_optimizer(TrainRecipe, 500, model.parameters())
    step = make_train_step(model, optimizer, smpl, LossWeights(),
                           torch.Generator(device=device).manual_seed(seed), plain=plain)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    metrics, times, grad, launches = [], [], None, None
    for i in range(steps):
        kernels.reset_launches()
        t0 = time.perf_counter()
        metrics.append(step(*batch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(kernels.LAUNCHES)
            bad = debug_nan_params(model)
            if bad:
                raise AssertionError(f"non-finite gradients in {bad[:5]} ({len(bad)} parameters)")
            grad = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    peak = torch.cuda.max_memory_allocated(device)
    return metrics, grad, launches, times, peak


def f64_plain_grad(start, smpl, batch, device, dropout=True):
    """The first step's whole gradient (f64) through the plain versions of
    the model in f64 from the f32 weights ``start``, on the same batch and
    generator seed as :func:`train_steps` (``dropout=False``: with every
    dropout rate 0)."""
    from maed_tpu_torch.core.builder import build_train_model

    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() else t

    model, _ = build_train_model(dtype=torch.float64, device=device, seed=0,
                                 allow_synthetic_smpl=True)
    model.double().load_state_dict({k: f64(v) for k, v in start.items()})
    if not dropout:
        without_dropout(model)
    vid, img = batch
    vid = {"images": vid["images"], "target_2d": {k: f64(v) for k, v in vid["target_2d"].items()},
           "target_3d": {k: f64(v) for k, v in vid["target_3d"].items()}}
    img = {k: f64(v) for k, v in img.items()}
    metrics, grad, *_ = train_steps(model, type(smpl)(*map(f64, smpl)), (vid, img), 1,
                                    plain=True)
    del model
    torch.cuda.empty_cache()
    return metrics[0]["loss"].item(), grad


def check_f32_train(record, loss_k, loss_p, grad, plain_grad, stem, loss_64, grad_64):
    """The f32 step's limits (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL outside the
    stem, F32_GRAD_RATIO against the f64 step); adds the distances to
    ``record``."""
    rest = rel_l2(grad[~stem], plain_grad[~stem])
    kern, plain = rel_l2(grad, grad_64), rel_l2(plain_grad, grad_64)
    record.update(grad_rel_l2_outside_stem=rest,
                  grad_rel_l2_stem=rel_l2(grad[stem], plain_grad[stem]),
                  grad_rel_l2_kernels_vs_f64=kern, grad_rel_l2_plain_vs_f64=plain)
    print(f"  f32 gradient, kernels vs plain: outside the stem {rest:.3e} (bound "
          f"{TRAIN_GRAD_RTOL}), the stem {record['grad_rel_l2_stem']:.3e}; against the f64 step "
          f"(loss {loss_64:.6f}): kernels {kern:.3e}, plain {plain:.3e}, ratio {kern / plain:.3f} "
          f"(bound {F32_GRAD_RATIO})")
    if not abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"train f32: loss {loss_k} through the kernels, {loss_p} through "
                             f"the plain versions, beyond rel {TRAIN_LOSS_RTOL}")
    if not rest <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train f32: gradient outside the stem rel L2 {rest:.3e} beyond "
                             f"{TRAIN_GRAD_RTOL}")
    if not kern <= F32_GRAD_RATIO * plain:
        raise AssertionError(f"train f32: the kernels' gradient lies {kern:.3e} from the f64 "
                             f"step's, beyond {F32_GRAD_RATIO} x the plain versions' {plain:.3e}")


def remat_check(model, smpl, batch, start, card):
    """The f32 step of ``model`` from ``start`` without and with remat (each
    ViT block under ``torch.utils.checkpoint``, recomputed in the backward),
    TRAIN_STEPS steps each, with cuDNN's deterministic algorithms: the first
    step's gradients must be equal bit for bit. Returns each one's step time
    (median of steps 2 on, host clock), peak memory and launches a step."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for remat in (False, True):
            model.load_state_dict(start)
            model.encoder.remat = remat
            _, grad, launches, times, peak = train_steps(model, smpl, batch, TRAIN_STEPS)
            runs["remat" if remat else "no_remat"] = dict(
                grad=grad, ms_per_step=float(np.median(times[1:])), step_ms=times,
                peak_memory_bytes=peak, launches=launches)
    finally:
        model.encoder.remat = False
        torch.backends.cudnn.deterministic = deterministic
    equal = torch.equal(runs["no_remat"].pop("grad"), runs["remat"].pop("grad"))
    a, b = runs["no_remat"], runs["remat"]
    print(f"  remat, f32, cuDNN deterministic ({card}): {b['ms_per_step']:.1f} ms a step, peak "
          f"{b['peak_memory_bytes'] / 2 ** 30:.2f} GiB; without: {a['ms_per_step']:.1f} ms, peak "
          f"{a['peak_memory_bytes'] / 2 ** 30:.2f} GiB; step 1 gradients equal bit for bit: "
          f"{equal}; launches a remat step {b['launches']}")
    if not equal:
        raise AssertionError("train f32: the remat step's gradient differs from the step's "
                             "without remat")
    return dict(runs, grad_bit_equal=equal)


def phase_train(device):
    """The stage-2 train step at full width, f32 and bf16; prints the
    record of each and returns the bf16 and the f32 step's launches."""
    from maed_tpu_torch.core.builder import build_train_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    n_vid = TRAIN_2D + TRAIN_3D
    records, grads, launches_train = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        label = "f32" if dtype == torch.float32 else "bf16"
        t0 = time.perf_counter()
        model, smpl = build_train_model(dtype=dtype, device=device, seed=0,
                                        allow_synthetic_smpl=True)
        batch = make_train_batch(smpl, device)
        start = {k: v.clone() for k, v in model.state_dict().items()}
        print(f"train {label}: built in {time.perf_counter() - t0:.1f} s, "
              f"{n_vid}x{SEQLEN} + {TRAIN_IMAGES} frames a step at {IMG}^2, uint8")
        metrics, grad, launches, times, peak = train_steps(model, smpl, batch, TRAIN_STEPS)
        for m in metrics:
            if not all(torch.isfinite(v) for v in m.values()):
                raise AssertionError(f"train {label}: non-finite loss terms {m}")
        expect = per_forward("parallel", dtype=dtype)
        image = per_forward("parallel", dtype=dtype, seqlen=1)
        for name in expect:
            if launches[name] != expect[name] + image[name]:
                raise AssertionError(
                    f"train {label}: {name} launched {launches[name]} times in a step, want "
                    f"{expect[name]} (video forward) + {image[name]} (image forward)")
        for name in ("groupnorm" if dtype == torch.bfloat16 else "groupnorm_strided", "skinning",
                     "layernorm", "ln_rows", "ln_mlp_fc1", "ln_mlp_fc2", "ln_dense",
                     "spatial_attention", "temporal_attention", "gate_means", "gate_alpha",
                     "gate_blend", "gate_proj"):
            if not launches[name]:
                raise AssertionError(f"train {label}: {name} was not launched")
        ms = float(np.median(times[1:]))
        losses = [m["loss"].item() for m in metrics]
        print(f"  {card}: {ms:.1f} ms a step (median of steps 2-{TRAIN_STEPS}; each "
              + ", ".join(f"{t:.1f}" for t in times) + f"), peak memory {peak / 2 ** 30:.2f} GiB, "
              f"loss step 1 {losses[0]:.4f}, step {TRAIN_STEPS} {losses[-1]:.4f}")
        print(f"  launches in step 1: {launches}")
        # the same first step through the plain versions, from the same weights and generator
        model.load_state_dict(start)
        plain_metrics, plain_grad, plain_launches, plain_times, plain_peak = train_steps(
            model, smpl, batch, 1, plain=True)
        if any(plain_launches.values()):
            raise AssertionError(f"train {label}: the plain step launched {plain_launches}")
        loss_k, loss_p = losses[0], plain_metrics[0]["loss"].item()
        grad_dist = ((grad - plain_grad).norm() / plain_grad.norm()).item()
        print(f"  step 1 through the plain versions: {plain_times[0]:.1f} ms, peak memory "
              f"{plain_peak / 2 ** 30:.2f} GiB, loss {loss_p:.6f} (kernels {loss_k:.6f}, rel "
              f"{abs(loss_k - loss_p) / abs(loss_p):.3e}); gradient rel L2 {grad_dist:.3e}")
        grads[label] = (grad, plain_grad)
        launches_train[label] = launches
        records[label] = dict(ms_per_step=ms, step_ms=times, peak_memory_bytes=peak,
                              loss_first=losses[0], loss_last=losses[-1],
                              plain_step_ms=plain_times[0], plain_peak_memory_bytes=plain_peak,
                              grad_rel_l2_kernels_vs_plain=grad_dist)
        if dtype == torch.float32:
            records["f32"]["remat"] = remat_check(model, smpl, batch, start, card)
            stem = torch.cat([torch.full((p.numel(),), "patch_embed.backbone." in name,
                                         device=device)
                              for name, p in model.named_parameters()])
            del model, metrics, plain_metrics
            torch.cuda.empty_cache()
            check_f32_train(records["f32"], loss_k, loss_p, grad, plain_grad, stem,
                            *f64_plain_grad(start, smpl, batch, device))
        else:
            del model, metrics, plain_metrics
        del start, grad, plain_grad
        torch.cuda.empty_cache()
    f32_plain = grads["f32"][1]
    kern, plain = ((g - f32_plain).norm().item() for g in grads["bf16"])
    print(f"  bf16 gradient vs f32 plain: through the kernels {kern:.4e}, through the plain "
          f"versions {plain:.4e}, ratio {kern / plain:.3f} (bound {BF16_RATIO})")
    if not kern <= BF16_RATIO * plain:
        raise AssertionError(f"train bf16: the kernels' gradient is {kern:.4e} from the f32 one, "
                             f"beyond {BF16_RATIO} x {plain:.4e}")
    records["bf16"].update(grad_dist_to_f32_plain=kern, plain_grad_dist_to_f32_plain=plain)
    print(json.dumps({"train": {"card": card, **records}}))
    return launches_train["bf16"], launches_train["f32"]

# phase_ddp: data parallel training on the one card, DDP_WORLD ranks over gloo
# (NCCL takes one rank a device), each on its slice of a global batch of
# DDP_2D + DDP_3D clips of SEQLEN frames and DDP_IMAGES images (stage 2), and
# of DDP_STAGE1_IMAGES images (stage 1), against one process on the whole
# batch, every dropout rate 0 on both sides (each rank draws its own masks)
DDP_WORLD, DDP_2D, DDP_3D, DDP_IMAGES, DDP_STAGE1_IMAGES = 2, 4, 4, 8, 128


def without_dropout(model):
    """``model`` with every dropout and drop-path rate set to 0."""
    from maed_tpu_torch.models.layers import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.rate = 0.0
    return model


def rank_slice(batch: dict, rank: int, world: int, counts: dict) -> dict:
    """Rank ``rank``'s equal slice of each leaf of ``batch`` along its first
    axis; ``counts`` maps a key to the number of leading rows it splits
    separately (the video batch's 2D clips come before its 3D clips)."""
    def part(t, n):
        return t[rank * (n // world):(rank + 1) * (n // world)]

    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = rank_slice(v, rank, world, {})
        elif k in counts:
            n = counts[k]
            out[k] = torch.cat([part(v[:n], n), part(v[n:], v.shape[0] - n)])
        else:
            out[k] = part(v, v.shape[0])
    return out


def ddp_rank(out_dir: Path) -> int:
    """One rank of :func:`phase_ddp` (``chip_smoke.py --ddp-rank <dir>``, with
    torchrun's environment): joins the gloo group, takes one f32 stage-2
    step through the kernels on its slice of the global batch, then one
    stage-1 step; rank 0 writes the loss terms averaged over the ranks, the
    averaged gradient and, for stage 1, the BatchNorm statistics after the
    step (global moments) to ``<dir>/rank0.pt``."""
    sys.path.insert(0, str(ROOT))
    from maed_tpu_torch.core.builder import build_train_model
    from maed_tpu_torch.parallel import dist

    rank, world = dist.init_from_env(cpu=False, backend="gloo")
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    model, smpl = build_train_model(device=device, seed=0, allow_synthetic_smpl=True)
    vid, img = make_train_batch(smpl, device, DDP_2D, DDP_3D, DDP_IMAGES)
    batch = (rank_slice(vid, rank, world, {"images": DDP_2D}), rank_slice(img, rank, world, {}))
    metrics, grad, launches, times, peak = train_steps(without_dropout(model), smpl, batch, 1)
    keys = sorted(metrics[0])
    mean = dist.mean_over_ranks(torch.stack([metrics[0][k] for k in keys])).tolist()
    out["stage2"] = dict(metrics=dict(zip(keys, mean)), grad=grad.cpu(), launches=launches,
                         step_ms=times[0], peak_memory_bytes=peak)
    del model, grad
    torch.cuda.empty_cache()
    model, smpl = build_train_model(encoder="cnn", decoder="ktd", device=device, seed=0,
                                    allow_synthetic_smpl=True)
    img = rank_slice(make_image_batch(smpl, device, DDP_STAGE1_IMAGES), rank, world, {})
    run = stage1_steps(without_dropout(model), smpl, img, 1)
    loss = dist.mean_over_ranks(torch.tensor([run["losses"][0]])).item()
    out["stage1"] = dict(loss=loss, grad=run["grad"].cpu(), launches=run["launches"],
                         stats={k: v.cpu() for k, v in run["stats"][0].items()},
                         step_ms=run["ms"][0], peak_memory_bytes=run["peak"])
    if rank == 0:
        torch.save(out, out_dir / "rank0.pt")
    dist.shutdown()
    return 0


def run_ddp_ranks(workdir: Path, timeout: float = 600, flag: str = "--ddp-rank",
                  world: int = DDP_WORLD, extra_env=None, result: str = "rank0.pt"):
    """``world`` processes of this script with ``flag`` (:func:`ddp_rank`, or
    :func:`tp_rank`) on a free localhost port, ``extra_env`` added to their
    environment; returns what they wrote to ``workdir / result``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), PYTHONUNBUFFERED="1",
                   **(extra_env or {}))
        logs.append(workdir / f"rank{rank}.log")
        with open(logs[-1], "w") as out:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                           flag, str(workdir)], env=env, stdout=out,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{flag} {rank} exited {p.returncode}:\n"
                                 + logs[rank].read_text()[-4000:])
    return torch.load(workdir / result, weights_only=False)


def phase_ddp(device):
    """Data parallel training on the one card: DDP_WORLD gloo ranks
    (``parallel.dist``: the loss terms over the global batch, BatchNorm over
    its moments, the gradient averaged before the update), each on its
    slice, against one process on the whole batch through the kernels, in
    f32 at full width. Stage 2 (the released MAED, DDP_2D + DDP_3D clips and
    DDP_IMAGES images): each loss term within TRAIN_LOSS_RTOL, the gradient
    outside the stem within TRAIN_GRAD_RTOL and the whole gradient at most
    F32_GRAD_RATIO times as far from the one-process step in f64 as the
    one-process plain f32 step (phase_train's rule). Stage 1 (ResNet-50 +
    KTD, DDP_STAGE1_IMAGES images): the loss within TRAIN_LOSS_RTOL, the
    gradient within TRAIN_GRAD_RTOL, the BatchNorm statistics after the step
    within STAGE1_STATS_RTOL (phase_stage1's bounds). Prints one JSON
    record."""

    from maed_tpu_torch.core.builder import build_train_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    torch.cuda.empty_cache()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_ddp_"))
    try:
        t0 = time.perf_counter()
        ranks = run_ddp_ranks(workdir)
        ranks_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record = {"card": card, "world": DDP_WORLD, "ranks_s": ranks_s}

    # stage 2: one process on the whole batch, through the kernels, plain, f64
    model, smpl = build_train_model(device=device, seed=0, allow_synthetic_smpl=True)
    without_dropout(model)
    batch = make_train_batch(smpl, device, DDP_2D, DDP_3D, DDP_IMAGES)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, grad, _, times, peak = train_steps(model, smpl, batch, 1)
    model.load_state_dict(start)
    _, plain_grad, *_ = train_steps(model, smpl, batch, 1, plain=True)
    stem = torch.cat([torch.full((p.numel(),), "patch_embed.backbone." in name, device=device)
                      for name, p in model.named_parameters()])
    del model
    torch.cuda.empty_cache()
    loss_64, grad_64 = f64_plain_grad(start, smpl, batch, device, dropout=False)
    del start
    got = ranks["stage2"]
    ddp_grad = got["grad"].to(device)
    terms = {k: abs(got["metrics"][k] - v.item()) / abs(v.item()) for k, v in metrics[0].items()}
    rest = rel_l2(ddp_grad[~stem], grad[~stem])
    ddp_64, plain_64, one_64 = (rel_l2(g, grad_64) for g in (ddp_grad, plain_grad, grad))
    record["stage2"] = dict(
        loss_terms_rel=terms, grad_rel_l2_outside_stem=rest,
        grad_rel_l2_stem=rel_l2(ddp_grad[stem], grad[stem]), grad_rel_l2_ddp_vs_f64=ddp_64,
        grad_rel_l2_plain_vs_f64=plain_64, grad_rel_l2_one_process_vs_f64=one_64,
        rank_step_ms=got["step_ms"], rank_peak_memory_bytes=got["peak_memory_bytes"],
        one_process_step_ms=times[0], one_process_peak_memory_bytes=peak,
        rank_launches=got["launches"])
    print(f"  stage 2, {DDP_WORLD} ranks x ({DDP_2D // DDP_WORLD} + {DDP_3D // DDP_WORLD} clips, "
          f"{DDP_IMAGES // DDP_WORLD} images) against 1 x ({DDP_2D} + {DDP_3D}, {DDP_IMAGES}), "
          f"f32 through the kernels: loss terms max rel {max(terms.values()):.3e} (bound "
          f"{TRAIN_LOSS_RTOL}); gradient outside the stem rel L2 {rest:.3e} (bound "
          f"{TRAIN_GRAD_RTOL}), the stem {record['stage2']['grad_rel_l2_stem']:.3e}; against the "
          f"f64 step (loss {loss_64:.6f}): ranks {ddp_64:.3e}, one process {one_64:.3e}, plain "
          f"{plain_64:.3e}, ratio {ddp_64 / plain_64:.3f} (bound {F32_GRAD_RATIO})")
    print(f"  a rank's step: {got['step_ms']:.1f} ms, peak {got['peak_memory_bytes'] / 2 ** 30:.2f}"
          f" GiB (two ranks share the card); one process: {times[0]:.1f} ms, peak "
          f"{peak / 2 ** 30:.2f} GiB (host clock, first steps); launches a rank's step "
          f"{ {k: v for k, v in got['launches'].items() if v} }")
    if not (max(terms.values()) <= TRAIN_LOSS_RTOL and rest <= TRAIN_GRAD_RTOL
            and ddp_64 <= F32_GRAD_RATIO * plain_64):
        raise AssertionError("ddp stage 2: the ranks' step left the one-process step")
    if not all(got["launches"][k] for k in ("groupnorm_strided", "skinning", "layernorm",
                                            "ln_mlp_fc1", "ln_dense", "spatial_attention",
                                            "temporal_attention", "gate_proj")):
        raise AssertionError(f"ddp stage 2: a kernel was not launched: {got['launches']}")
    del ddp_grad, grad, plain_grad, grad_64, stem, batch
    torch.cuda.empty_cache()

    # stage 1: one process on all the images
    model, smpl = build_train_model(encoder="cnn", decoder="ktd", device=device, seed=0,
                                    allow_synthetic_smpl=True)
    img = make_image_batch(smpl, device, DDP_STAGE1_IMAGES)
    one = stage1_steps(without_dropout(model), smpl, img, 1)
    del model
    torch.cuda.empty_cache()
    got = ranks["stage1"]
    loss_rel = abs(got["loss"] - one["losses"][0]) / abs(one["losses"][0])
    grad_rel = rel_l2(got["grad"].to(device), one["grad"])
    stats_rel = stats_distance({k: v.to(device) for k, v in got["stats"].items()}, one["stats"][0])
    record["stage1"] = dict(loss_rel=loss_rel, grad_rel_l2=grad_rel, bn_stats_max_rel_l2=stats_rel,
                            rank_step_ms=got["step_ms"],
                            rank_peak_memory_bytes=got["peak_memory_bytes"],
                            one_process_step_ms=one["ms"][0],
                            one_process_peak_memory_bytes=one["peak"])
    print(f"  stage 1, {DDP_WORLD} x {DDP_STAGE1_IMAGES // DDP_WORLD} images against 1 x "
          f"{DDP_STAGE1_IMAGES}: loss rel {loss_rel:.3e} (bound {TRAIN_LOSS_RTOL}), gradient rel "
          f"L2 {grad_rel:.3e} (bound {TRAIN_GRAD_RTOL}), BatchNorm statistics max rel L2 "
          f"{stats_rel:.3e} (bound {STAGE1_STATS_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL
            and stats_rel <= STAGE1_STATS_RTOL):
        raise AssertionError("ddp stage 1: the ranks' step left the one-process step")
    print(json.dumps({"ddp": record}))
    return record


# phase_tp: tensor parallelism on the one card, TP_WORLD ranks over gloo at
# MAED_MESH_TP = TP_WORLD (one data rank: both take the whole batch), the
# released MAED at full width (12 heads, 6 a rank; 3072 hidden, 1536 a rank),
# against one process; the step on TP_2D + TP_3D clips and TP_IMAGES images
TP_WORLD, TP_2D, TP_3D, TP_IMAGES = 2, 2, 2, 4
# fc2's and proj's row-parallel products at tp = 2 on the flagship's tokens:
# (M, N, K) of a rank's part
TP_SHARD_SHAPES = {"fc2": (N_CLIPS * SEQLEN * 197, 768, 3072 // TP_WORLD),
                   "proj": (N_CLIPS * SEQLEN * 197, 768, 768 // TP_WORLD)}


def tp_per_forward(tp_rank: int, dtype: torch.dtype, seqlen: int = SEQLEN) -> dict:
    """A tensor-parallel rank's launches in one forward of the flagship
    (parallel mode, 6 blocks): those of one process (E's pieces launched one
    by one, as one process's one C call launches them); past tp rank 0, C's
    fc2 and E's proj through the row-parallel epilogue."""
    counts = per_forward("parallel", dtype=dtype, seqlen=seqlen)
    if tp_rank:
        counts["ln_mlp_fc2_partial"], counts["ln_mlp_fc2"] = counts["ln_mlp_fc2"], 0
        counts["gate_proj_partial"], counts["gate_proj"] = counts["gate_proj"], 0
    return counts


def tp_rank(out_dir: Path) -> int:
    """One rank of :func:`phase_tp` (``chip_smoke.py --tp-rank <dir>``, with
    torchrun's environment and MAED_MESH_TP): joins the gloo group, makes the
    mesh, runs a bf16 and an f32 eval forward of the split flagship on the
    first request (counted and timed: first calls), then one f32 stage-2
    step and a second one for its time; writes its answers, launches, times
    and, on rank 0, the first step's gathered gradient and updated
    parameters to ``<dir>/rank<r>.pt``."""
    sys.path.insert(0, str(ROOT))
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.builder import build_eval_model, build_train_model
    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel.mesh import gather_state_dict, make_mesh

    rank, _ = dist.init_from_env(cpu=False, backend="gloo")
    mesh = make_mesh(tp=int(os.environ["MAED_MESH_TP"]))
    device = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clips, jreg = make_requests(device)
    out = {"tp_rank": mesh.tp_rank, "forwards": {}}
    for dtype in (torch.bfloat16, torch.float32):
        model, smpl = build_eval_model(dtype=dtype, device=device, seed=0,
                                       allow_synthetic_smpl=True, mesh=mesh)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = model(clips[0], smpl, J_regressor=jreg)
        torch.cuda.synchronize()
        out["forwards"][str(dtype)] = dict(
            out={k: v.cpu() for k, v in got.items()}, launches=dict(kernels.LAUNCHES),
            ms=(time.perf_counter() - t0) * 1e3)
        del model, got
    torch.cuda.empty_cache()
    model, smpl = build_train_model(device=device, seed=0, allow_synthetic_smpl=True, mesh=mesh)
    batch = make_train_batch(smpl, device, TP_2D, TP_3D, TP_IMAGES)
    metrics, _, launches, times, peak = train_steps(without_dropout(model), smpl, batch, 1)
    named = dict(model.named_parameters())
    # copies, before the next step updates the replicated parameters in place
    grads = gather_state_dict({k: p.grad for k, p in named.items()}, mesh)
    params = gather_state_dict({k: p.detach() for k, p in named.items()}, mesh)
    grad = torch.cat([grads[k].reshape(-1) for k in named]).cpu()
    params = torch.cat([params[k].reshape(-1) for k in named]).cpu()
    _, _, _, warm, _ = train_steps(model, smpl, batch, 1)  # a second step, for its time
    out["step"] = dict(metrics={k: v.item() for k, v in metrics[0].items()}, launches=launches,
                       first_step_ms=times[0], step_ms=warm[0], peak_memory_bytes=peak)
    if rank == 0:
        out["step"].update(grad=grad, params=params)
    torch.save(out, out_dir / f"rank{rank}.pt")
    dist.barrier()
    dist.shutdown()
    return 0


def row_partial_records(device) -> dict:
    """The row-parallel epilogue (``dense``'s "fc2_partial" and
    "proj_partial": the product alone, past tp rank 0) at fc2's and proj's
    shard shapes, bf16 and f32, against its plain version, timed beside
    cuBLAS on the same product; the record of each dtype is fc2's, with
    proj's under "proj"."""
    from maed_tpu_torch.ops import mlp

    rng = np.random.RandomState(23)
    records = {}
    for dt, kind, limits in ((torch.bfloat16, "bf16", (2e-2, 1e-2)),
                             (torch.float32, "f32", (1e-4, 0.0))):
        recs = {}
        for name, (M, N, K) in TP_SHARD_SHAPES.items():
            a = torch.from_numpy(rng.randn(M, K)).to(device, dt)
            w = torch.from_numpy(rng.randn(N, K) / np.sqrt(K)).to(device, dt)
            epi = f"{name}_partial"
            kernel = lambda: mlp.dense(a, w, None, epi)  # noqa: E731
            library = lambda: torch.matmul(a, w.t())  # noqa: E731
            recs[name] = compare(
                f"row-parallel {name} {kind} ({M} x {N} x {K})", kernel,
                lambda: mlp.dense_reference(a, w, None, epi), *limits, moved=(a, w),
                flops=2.0 * M * N * K, kind=kind, library=library, iters=10)
            # on the device: the launches queued behind a sleep
            recs[name].update(device_ms=time_ms(kernel, 20, queued=True),
                              library_device_ms=time_ms(library, 20, queued=True))
            print(f"    on the device: kernel {recs[name]['device_ms']:.4f} ms, cuBLAS "
                  f"{recs[name]['library_device_ms']:.4f} ms")
            del a, w
        records[kind] = dict(recs["fc2"], proj=recs["proj"])
    return records


def adam_first_step_excess(p_got, p_want, g_got, g_want, lr, eps=1e-8):
    """How far the parameters after two Adam first steps (update lr g / (|g|
    + eps), no weight decay) from the same start lie beyond what their
    gradients' own difference allows: lr eps / (m + eps)^2 |g_got - g_want|
    (m the smaller |g|, or 0 where the signs differ: the update's steepest
    slope between them), plus f32's rounding of the update and of the
    parameter. Returns the largest excess (<= 0 within)."""
    g1, g2 = g_got.double(), g_want.double()
    m = torch.where(torch.sign(g1) == torch.sign(g2), torch.minimum(g1.abs(), g2.abs()),
                    torch.zeros_like(g1))
    limit = lr * eps / (m + eps) ** 2 * (g1 - g2).abs() + lr * 1e-5 \
        + 2.0 ** -22 * p_want.double().abs()
    return ((p_got.double() - p_want.double()).abs() - limit).max().item()


def phase_tp(device, clips, jreg, bf16_plains, wants):
    """Tensor parallelism on the one card: TP_WORLD gloo ranks
    (``parallel.mesh``, ``parallel.tensor``: each ViT block split by heads
    and hidden columns, kernels C, D, E's pieces, F/J and G/H on the rank's
    shard, fc2 and proj past tp rank 0 through the row-parallel epilogue,
    the partial sums all-reduced; two ranks on one card stage each
    all-reduce through the host) against one process on the same input, in
    f32 at full width. The
    bf16 forward's answers by BF16_RATIO to one process's f32 plain ones
    ``wants`` (one process's bf16 plain answers ``bf16_plains`` the
    measure), the f32 forward's within phase_f32's kernels-vs-plain bounds
    of them, both ranks' answers equal bit for bit; the step (every dropout
    rate 0): each loss term within TRAIN_LOSS_RTOL of one process's, the
    gathered gradient outside the stem within TRAIN_GRAD_RTOL, the whole
    gradient at most F32_GRAD_RATIO times as far from the f64 step as one
    process's plain f32 step, the updated parameters within what Adam's
    first step makes of the two gradients' difference; each rank's launches
    those of the split forwards and step. Returns the record (with the
    row-parallel epilogue's kernel records)."""
    from maed_tpu_torch.core.builder import build_train_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_identity()
    record = {"card": card, "tp": TP_WORLD, "kernels": row_partial_records(device)}
    torch.cuda.empty_cache()
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    try:
        t0 = time.perf_counter()
        run_ddp_ranks(workdir, flag="--tp-rank", world=TP_WORLD,
                      extra_env={"MAED_MESH_TP": str(TP_WORLD)})
        ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
                 for r in range(TP_WORLD)]
        record["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # the forwards: each rank's launches, the answers equal on the ranks
    for dtype in (torch.bfloat16, torch.float32):
        for r, got in enumerate(ranks):
            want = tp_per_forward(got["tp_rank"], dtype)
            launches = got["forwards"][str(dtype)]["launches"]
            bad = {k: (launches[k], v) for k, v in want.items() if launches[k] != v}
            if bad:
                raise AssertionError(f"tp rank {r} {dtype} forward: launches (got, want) {bad}")
            for k, v in got["forwards"][str(dtype)]["out"].items():
                if not torch.equal(v, ranks[0]["forwards"][str(dtype)]["out"][k]):
                    raise AssertionError(f"tp rank {r} {dtype}: {k} differs from rank 0's")
    bf16 = {k: v.to(device) for k, v in ranks[0]["forwards"][str(torch.bfloat16)]["out"].items()}
    f32 = {k: v.to(device) for k, v in ranks[0]["forwards"][str(torch.float32)]["out"].items()}
    check_outputs(bf16)
    check_outputs(f32)
    check_bf16_ratio("tp=2", [bf16], bf16_plains[:1], wants[:1])
    for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
        record[f"f32_{key}_max_abs_err"] = check_close(
            f"tp=2 f32 forward {key} vs one process's plain", f32[key], wants[0][key], atol)
    record.update({f"rank{r}_{dt}_forward_ms": got["forwards"][f"torch.{dt}"]["ms"]
                   for r, got in enumerate(ranks) for dt in ("bfloat16", "float32")})
    del bf16, f32

    # the step: one process through the kernels, through the plain versions, in f64
    model, smpl = build_train_model(device=device, seed=0, allow_synthetic_smpl=True)
    without_dropout(model)
    batch = make_train_batch(smpl, device, TP_2D, TP_3D, TP_IMAGES)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, grad, _, first, peak = train_steps(model, smpl, batch, 1)
    params = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    _, _, _, times, _ = train_steps(model, smpl, batch, 1)  # a second step, for its time
    model.load_state_dict(start)
    _, plain_grad, *_ = train_steps(model, smpl, batch, 1, plain=True)
    stem = torch.cat([torch.full((p.numel(),), "patch_embed.backbone." in name, device=device)
                      for name, p in model.named_parameters()])
    del model
    torch.cuda.empty_cache()
    loss_64, grad_64 = f64_plain_grad(start, smpl, batch, device, dropout=False)
    del start
    got = ranks[0]["step"]
    tp_grad, tp_params = got["grad"].to(device), got["params"].to(device)
    terms = {k: abs(got["metrics"][k] - v.item()) / abs(v.item()) for k, v in metrics[0].items()}
    rest = rel_l2(tp_grad[~stem], grad[~stem])
    tp_64, plain_64 = rel_l2(tp_grad, grad_64), rel_l2(plain_grad, grad_64)
    excess = adam_first_step_excess(tp_params, params, tp_grad, grad,
                                    TrainRecipe.LR * TrainRecipe.WARMUP_FACTOR)
    for r, rk in enumerate(ranks):
        step_launches = {k: tp_per_forward(rk["tp_rank"], torch.float32)[k]
                         + tp_per_forward(rk["tp_rank"], torch.float32, seqlen=1)[k]
                         for k in rk["step"]["launches"]}
        bad = {k: (rk["step"]["launches"][k], v) for k, v in step_launches.items()
               if rk["step"]["launches"][k] != v}
        if bad:
            raise AssertionError(f"tp rank {r} step: launches (got, want) {bad}")
    record["step"] = dict(
        loss_terms_rel=terms, grad_rel_l2_outside_stem=rest,
        grad_rel_l2_stem=rel_l2(tp_grad[stem], grad[stem]), grad_rel_l2_tp_vs_f64=tp_64,
        grad_rel_l2_plain_vs_f64=plain_64, params_excess_over_adam_bound=excess,
        rank_step_ms=[rk["step"]["step_ms"] for rk in ranks],
        rank_first_step_ms=[rk["step"]["first_step_ms"] for rk in ranks],
        rank_peak_memory_bytes=[rk["step"]["peak_memory_bytes"] for rk in ranks],
        one_process_step_ms=times[0], one_process_first_step_ms=first[0],
        one_process_peak_memory_bytes=peak,
        rank_launches=[rk["step"]["launches"] for rk in ranks])
    print(f"  tp={TP_WORLD} step ({TP_2D} + {TP_3D} clips, {TP_IMAGES} images) against one "
          f"process, f32 through the kernels: loss terms max rel {max(terms.values()):.3e} "
          f"(bound {TRAIN_LOSS_RTOL}); gradient outside the stem rel L2 {rest:.3e} (bound "
          f"{TRAIN_GRAD_RTOL}), the stem {record['step']['grad_rel_l2_stem']:.3e}; against the "
          f"f64 step (loss {loss_64:.6f}): tp {tp_64:.3e}, plain {plain_64:.3e}, ratio "
          f"{tp_64 / plain_64:.3f} (bound {F32_GRAD_RATIO}); parameters after the update: "
          f"excess over Adam's bound {excess:.3e} (<= 0)")
    print(f"  a tp rank's second step: " + ", ".join(
        f"rank {r} {rk['step']['step_ms']:.1f} ms, peak "
        f"{rk['step']['peak_memory_bytes'] / 2 ** 30:.2f} GiB" for r, rk in enumerate(ranks))
        + f" (two ranks share the card, all-reduces staged through the host by gloo); one "
        f"process: {times[0]:.1f} ms, peak {peak / 2 ** 30:.2f} GiB (host clock; first steps "
        f"{[rk['step']['first_step_ms'] for rk in ranks]} and {first[0]:.1f} ms; {card}); "
        f"launches a step " + "; ".join(
            f"rank {r} { {k: v for k, v in rk['step']['launches'].items() if v} }"
            for r, rk in enumerate(ranks)))
    if not (max(terms.values()) <= TRAIN_LOSS_RTOL and rest <= TRAIN_GRAD_RTOL
            and tp_64 <= F32_GRAD_RATIO * plain_64 and excess <= 0):
        raise AssertionError("tp: the split step left the one-process step")
    record["launches"] = {f"rank{r}_{dt}": rk["forwards"][f"torch.{dt}"]["launches"]
                          for r, rk in enumerate(ranks) for dt in ("bfloat16", "float32")}
    print(json.dumps({"tp": {k: v for k, v in record.items() if k != "launches"}}))
    return record


# phase_trainer: the CLIs at full width on the stage-2 config, a short run
TRAINER_ITERS, TRAINER_EPOCHS = 3, 2
FIXTURE_DIR = ROOT / "tests" / "torch_port_data"
# the JAX package's bound for two JPEG decoders, after the crop and the
# normalize (tests/test_data.py::test_native_jpeg_decode_crop_matches_cv2_path)
DECODE_BOUND = 0.06
# the resumed run against the uninterrupted one: each step's losses, and
# every parameter and optimizer moment (relative L2 of the whole)
RESUME_LOSS_RTOL, RESUME_PARAM_RTOL = 1e-5, 1e-4
METRIC_ATOL_MM = 0.05  # the eval CLI's metrics against the validation's (PERF.md section 2)
LOADER_BATCHES = 8


def synthetic_video_db(rng, frames, videos, length, with_3d=True):
    """A DB in the layout of the data pipeline over ``frames`` (JPEG paths,
    taken in turn): ``videos`` videos of ``length`` frames, a crop box
    drifting about each frame's middle, random keypoints, poses and shapes."""
    n = videos * length
    db = {"vid_name": np.repeat([f"v{i:02d}" for i in range(videos)], length),
          "img_name": np.array([frames[i % len(frames)] for i in range(n)]),
          "frame_id": np.tile(np.arange(length), videos),
          "bbox": np.concatenate([rng.uniform([200, 150], [280, 210], (n, 2)),
                                  rng.uniform(140, 200, (n, 1)).repeat(2, axis=1)], axis=1),
          "joints2D": np.concatenate([rng.uniform([140, 80], [340, 280], (n, 49, 2)),
                                      np.ones((n, 49, 1))], axis=2).astype(np.float32)}
    if with_3d:
        db["joints3D"] = np.concatenate([rng.randn(n, 49, 3) * 0.3, np.ones((n, 49, 1))],
                                        axis=2).astype(np.float32)
        db["pose"] = (rng.randn(n, 72) * 0.2).astype(np.float32)
        db["shape"] = (rng.randn(n, 10) * 0.5).astype(np.float32)
    return db


def write_trainer_dbs(workdir: Path, seed: int = 11):
    """The stage-2 config's four DBs over the fixture frames, as plain
    pickles under ``<workdir>/data/database``: 2D and 3D clips (12 and 72
    chunks of 128 frames: the 3D loader's rate is timed over LOADER_BATCHES
    batches after a first), 64 images, and 2 validation videos of one
    128-frame window each."""
    import pickle

    rng = np.random.RandomState(seed)
    frames = [str(p) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    image = synthetic_video_db(rng, frames, 1, 64)
    dbs = {"syn2d_train": synthetic_video_db(rng, frames, 4, 192, with_3d=False),
           "syn3d_train": synthetic_video_db(rng, frames, 24, 192),
           "synimg_train": {k: v for k, v in image.items() if k not in ("vid_name", "frame_id")},
           "3dpw_val": synthetic_video_db(rng, frames, 2, POOL)}
    (workdir / "data" / "database").mkdir(parents=True)
    for name, db in dbs.items():
        with open(workdir / "data" / "database" / f"{name}_db.pt", "wb") as f:
            pickle.dump(db, f)


def trainer_overrides(out: str):
    return ["DEVICE", "cuda", "OUTPUT_DIR", out, "SEED_VALUE", "7", "NUM_WORKERS", "8",
            "TRAIN.DATASETS_2D", "[syn2d]", "TRAIN.DATASETS_3D", "[syn3d]",
            "TRAIN.DATASETS_IMG", "[synimg]", "TRAIN.DATASET_EVAL", "3dpw",
            "TRAIN.NUM_ITERS_PER_EPOCH", str(TRAINER_ITERS), "TRAIN.END_EPOCH", str(TRAINER_EPOCHS),
            "SAVE_FREQ", "1", "DEBUG_FREQ", "1",
            # deterministic cuDNN algorithms, for the resumed run to equal the first
            "CUDNN.BENCHMARK", "false", "CUDNN.DETERMINISTIC", "true"]


def child_pids(pid: int) -> list:
    """The processes ``pid`` started (Linux's /proc)."""
    try:
        return [int(c) for c in Path(f"/proc/{pid}/task/{pid}/children").read_text().split()]
    except OSError:
        return []


def run_cli(workdir: Path, module: str, args, log: Path, stop_on: str | None = None,
            timeout: float = 600, cfg: str = "config_stage2.yaml", torchrun: bool = False):
    """``python -m <module> --cfg configs/<cfg> --allow_synthetic_smpl
    <args>`` in ``workdir``, its output to ``log``; with ``torchrun``, as
    the one rank of ``python -m torch.distributed.run --standalone
    --nproc_per_node 1`` (NCCL). With ``stop_on``, SIGTERM is sent to the
    trainer's process (under torchrun, the rank the launcher started) when a
    line containing it appears. Returns the exit code; the process is always
    ended."""
    import signal

    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1"] if torchrun else [sys.executable])
    cmd = [*launcher, "-m", module, "--cfg", str(ROOT / "configs" / cfg),
           "--allow_synthetic_smpl", *args]
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        try:
            for line in proc.stdout:
                out.write(line)
                if stop_on is not None and stop_on in line:
                    for pid in child_pids(proc.pid) if torchrun else [proc.pid]:
                        os.kill(pid, signal.SIGTERM)
                    stop_on = None
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"{module} ran over {timeout} s; see {log}")
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"  {'torchrun ' if torchrun else ''}{module} {' '.join(args[-4:])}: exit {rc} in "
          f"{time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"{module} exited {rc}:\n" + log.read_text()[-4000:])
    return rc


def run_records(out_dir: Path):
    """The train_metrics.jsonl records of every run dir under ``out_dir``,
    oldest first."""
    recs = []
    for run in sorted(out_dir.iterdir()):
        with open(run / "train_metrics.jsonl") as f:
            recs += [json.loads(line) for line in f]
    return recs


def state_distance(a: dict, b: dict):
    """(relative L2 over every tensor of two checkpoints' model and
    optimizer state, whether all are bit-equal)."""
    pairs = [(a["state_dict"][k], b["state_dict"][k]) for k in a["state_dict"]]
    for i, st in a["optimizer"]["state"].items():
        pairs += [(v, b["optimizer"]["state"][i][k]) for k, v in st.items()]
    diff = sum(((x.double() - y.double()) ** 2).sum().item() for x, y in pairs)
    norm = sum((y.double() ** 2).sum().item() for _, y in pairs)
    return (diff / norm) ** 0.5, all(torch.equal(x, y) for x, y in pairs)


def check_decoder(device):
    """The native library's decoder on this machine against the pixels cv2
    decoded from the fixture frames (tests/torch_port_data, made by
    tests/test_torch_port_data.py::make_fixture_frames: blurred seeded noise
    written by cv2 as JPEG at quality 95): the fused decode + crop +
    normalize within DECODE_BOUND of the same crop of cv2's pixels."""
    from maed_tpu_torch import native
    from maed_tpu_torch.data.transforms import FusedCropNormalize

    stored = np.load(FIXTURE_DIR / "decoded.npz")
    blobs = [(FIXTURE_DIR / f"frame_{k}.jpg").read_bytes() for k in range(len(stored["sha256"]))]
    t0 = time.perf_counter()
    crop = FusedCropNormalize(112, 112)({"clip": blobs, "bbox": stored["bbox"]}, None)["clip"]
    ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(crop - stored["crop"].astype(np.float32)).max())
    raw = np.stack([native.decode(b)[::6, ::6] for b in blobs]).astype(np.int32) - stored["sub"]
    record = dict(decoder=native.decoder(), crop_max_abs_err=err, bound=DECODE_BOUND,
                  raw_max_abs_lsb=int(np.abs(raw).max()), raw_mean_abs_lsb=float(np.abs(raw).mean()),
                  decode_crop_ms=ms)
    print(f"  decoder {record['decoder']}: decode + crop of {len(blobs)} frames within {err:.4f} "
          f"of cv2's (bound {DECODE_BOUND}); raw pixels max {record['raw_max_abs_lsb']} LSB, mean "
          f"{record['raw_mean_abs_lsb']:.3f}; {ms:.1f} ms")
    if not err < DECODE_BOUND:
        raise AssertionError(f"decoder {record['decoder']}: {err} from cv2's crop, beyond "
                             f"{DECODE_BOUND}")
    return record


LOADER_RATE = """
import json, os, sys, time
import torch
torch.zeros(1, device="cuda")  # a live CUDA context, as in the trainer: workers from a forkserver
from maed_tpu_torch.core.config import update_cfg
from maed_tpu_torch.data.loaders import get_data_loaders
cfg = update_cfg(sys.argv[1])
cfg.merge_from_list(sys.argv[3:])
loader = get_data_loaders(cfg, verbose=False)["train_3d"]
it = loader.iter_from(0)
next(it)
t0, clips = time.perf_counter(), 0
for _ in range(int(sys.argv[2])):
    clips += next(it)["images"].shape[0]
print(json.dumps(dict(used=loader.num_workers, clips_per_s=clips / (time.perf_counter() - t0))))
it.close()
"""


def loader_rate(workdir: Path, workers: int):
    """Clips a second of the 3D train loader alone (decode, crop, jitter,
    erase, flip, stack) with ``workers`` worker processes (capped at the
    cores less one, as get_data_loaders does), over LOADER_BATCHES batches
    after the first, in a process of its own with a CUDA context, as the
    trainer's."""
    args = [str(ROOT / "configs" / "config_stage2.yaml"), str(LOADER_BATCHES),
            *trainer_overrides("unused"), "NUM_WORKERS", str(workers)]
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", LOADER_RATE, *args], cwd=workdir, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the loader's rate run failed:\n{out.stderr[-3000:]}")
    return dict(workers=workers, **json.loads(out.stdout.strip().splitlines()[-1]))


def last_checkpoints(out_a: Path, out_b: Path, name: str):
    """(relative L2, bit-equal) of ``name`` in run directory trees ``out_a``
    and ``out_b``, and the second's checkpoint."""
    from maed_tpu_torch.utils.checkpoint import load_checkpoint

    (a,) = [d for d in out_a.iterdir() if (d / name).is_file()]
    (b,) = [d for d in out_b.iterdir() if (d / name).is_file()]
    last_b = load_checkpoint(str(b / name))
    return (*state_distance(load_checkpoint(str(a / name)), last_b), last_b)


def trainer_cli_runs(workdir: Path, cfg: str, overrides, iters: int, epochs: int,
                     torchrun_reference: bool = False) -> dict:
    """The train CLI on ``configs/<cfg>`` with ``overrides(out_dir)`` (DBs
    under ``workdir``): one uninterrupted run of ``epochs`` epochs of
    ``iters`` iterations; the same command with TRAIN.RESUME auto as the one
    rank of torchrun (NCCL: a process group of one, ``parallel.dist``),
    stopped by SIGTERM to that rank in epoch 2 and relaunched; the eval CLI on the first run's
    model_best.pth.tar, which must agree with the validation that chose it
    (METRIC_ATOL_MM) and write inference.pkl. The resumed run is held to the
    first run, or with ``torchrun_reference`` to an uninterrupted run under
    torchrun too, which is then held to the first (``launcher``). Returns
    the record: the first run's iterations (ms, the median of iterations 2
    on of each epoch), data wait, peak memory, validations, checkpoint
    writes and losses; the resumed run against its reference (``resume``)
    and the eval CLI's metrics."""
    from maed_tpu_torch.utils.checkpoint import load_checkpoint

    out1, out2, out3 = workdir / "run1", workdir / "run2", workdir / "run3"
    run_cli(workdir, "maed_tpu_torch.train", overrides(str(out1)), workdir / "run1.log", cfg=cfg)
    if torchrun_reference:
        run_cli(workdir, "maed_tpu_torch.train", overrides(str(out3)), workdir / "run3.log",
                cfg=cfg, torchrun=True)
    resume = overrides(str(out2)) + ["TRAIN.RESUME", "auto"]
    run_cli(workdir, "maed_tpu_torch.train", resume, workdir / "run2a.log",
            stop_on=f"[Train] epoch 2/{epochs} it 1/{iters}", cfg=cfg, torchrun=True)
    run_cli(workdir, "maed_tpu_torch.train", resume, workdir / "run2b.log", cfg=cfg,
            torchrun=True)

    # the uninterrupted run: times, memory, validation, checkpoint writes
    recs1 = run_records(out1)
    steps1 = [r for r in recs1 if "loss" in r]
    timed = [r for r in recs1 if "step_s" in r]
    per_epoch, data_ms = {}, {}
    for r in timed:
        per_epoch.setdefault(r["epoch"], []).append((r["data_s"] + r["step_s"]) * 1e3)
        data_ms.setdefault(r["epoch"], []).append(r["data_s"] * 1e3)
    later = [r for r in timed if r["iter"] >= 1]
    evals = [r for r in recs1 if "eval" in r]
    (run1,) = list(out1.iterdir())
    record = dict(
        ms_per_iteration=[float(np.median(v[1:])) for _, v in sorted(per_epoch.items())],
        each_iteration_ms=per_epoch, each_data_ms=data_ms,
        data_wait_share=sum(r["data_s"] for r in later) / sum(r["data_s"] + r["step_s"]
                                                             for r in later),
        peak_memory_bytes=max(r["peak_bytes"] or 0 for r in timed),
        validation_s=[r["eval_s"] for r in evals],
        validation_s_per_window_batch=[r["eval_s"] / r["window_batches"] for r in evals],
        checkpoint_writes=[dict(name=r["checkpoint"], s=r["write_s"], mb=r["bytes"] / 1e6)
                           for r in recs1 if "checkpoint" in r],
        losses=[r["loss"] for r in steps1])
    print(f"  {cfg} run 1: ms an iteration (median of iterations 2-{iters} of each epoch, host "
          f"clock) {record['ms_per_iteration']}, data wait {record['data_wait_share']:.3f}, peak "
          f"{record['peak_memory_bytes'] / 2 ** 30:.2f} GiB; validation {record['validation_s']} s "
          f"({record['validation_s_per_window_batch']} s a window batch); writes "
          + ", ".join(f"{w['name']} {w['mb']:.0f} MB {w['s']:.2f} s"
                      for w in record["checkpoint_writes"]))
    if len(steps1) != iters * epochs or not all(np.isfinite(r["loss"]) for r in steps1):
        raise AssertionError(f"run 1 recorded {len(steps1)} steps: {steps1}")

    name = f"epoch_{epochs - 1}.pth.tar"
    reference, steps_ref = out1, steps1
    if torchrun_reference:
        # the one rank under torchrun against the process without a launcher
        steps3 = [r for r in run_records(out3) if "loss" in r]
        rel, exact, _ = last_checkpoints(out3, out1, name)
        record["launcher"] = dict(
            first_loss_rel=abs(steps3[0]["loss"] - steps1[0]["loss"]) / abs(steps1[0]["loss"]),
            loss_max_rel=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                             for a, b in zip(steps3, steps1)),
            losses_equal=steps3 == steps1, state_rel_l2=rel, bit_equal=exact)
        print(f"  {cfg} run 3 (torchrun, one NCCL rank, uninterrupted) against run 1: step 1 loss "
              f"rel {record['launcher']['first_loss_rel']:.3e}, losses max rel "
              f"{record['launcher']['loss_max_rel']:.3e}; {name} rel L2 {rel:.3e}, bit for bit: "
              f"{exact}")
        reference, steps_ref = out3, steps3

    # the resumed run against its reference
    (first, *_), recs2 = sorted(out2.iterdir()), run_records(out2)
    pre = load_checkpoint(str(first / "preempt.pth.tar"))
    steps2 = [r for r in recs2 if "loss" in r]
    if [(r["epoch"], r["iter"]) for r in steps2] != [(r["epoch"], r["iter"]) for r in steps1]:
        raise AssertionError(f"the resumed run's steps {[(r['epoch'], r['iter']) for r in steps2]}")
    rel, exact, last_ref = last_checkpoints(out2, reference, name)
    record["resume"] = dict(
        stopped_at=dict(epoch=pre["epoch"], iter=pre["epoch_iter"]),
        loss_max_rel=max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                         for a, b in zip(steps2, steps_ref)),
        losses_equal=steps2 == steps_ref, state_rel_l2=rel, bit_equal=exact,
        buffers=sum(k.endswith(("running_mean", "running_var", "num_batches_tracked"))
                    for k in last_ref["state_dict"]))
    print(f"  {cfg} run 2 (torchrun, one NCCL rank): SIGTERM in epoch {pre['epoch'] + 1}, "
          f"preempt.pth.tar after iteration {pre['epoch_iter']}; resumed, against run "
          f"{3 if torchrun_reference else 1}: losses max rel "
          f"{record['resume']['loss_max_rel']:.3e}, each step's equal: {steps2 == steps_ref}; "
          f"{name} (weights, {record['resume']['buffers']} BatchNorm buffers, Adam's moments) "
          f"rel L2 {rel:.3e}, bit for bit: {exact}")
    if not 0 < pre["epoch_iter"] < iters or pre["epoch"] != 1:
        raise AssertionError(f"the SIGTERM landed at epoch {pre['epoch']} iteration "
                             f"{pre['epoch_iter']}, not inside epoch 2")

    # the eval CLI on model_best against the validation that chose it
    eval_log = workdir / "eval.log"
    run_cli(workdir, "maed_tpu_torch.eval",
            ["--checkpoint", str(run1 / "model_best.pth.tar"), "--eval_ds", "3dpw",
             "--eval_set", "val", "--output_path", str(workdir / "eval_out")]
            + overrides(str(workdir / "unused")), eval_log, cfg=cfg)
    line = [ln for ln in eval_log.read_text().splitlines() if ln.startswith("MPJPE:")][-1]
    got = {k.strip().lower(): float(v) for k, v in
           (part.split(":") for part in line.rstrip(",").split(","))}
    best = float((run1 / "best.txt").read_text())
    chosen = [r["eval"] for r in evals if r["eval"]["pa-mpjpe"] == best][0]
    worst = max(abs(got[k] - v) for k, v in chosen.items())
    record["eval_cli"] = dict(metrics=got, validation=chosen, max_abs_mm=worst)
    print(f"  {cfg} eval CLI on model_best: {got}; against its validation max {worst:.4f} mm "
          f"(bound {METRIC_ATOL_MM})")
    if not worst <= METRIC_ATOL_MM or not (workdir / "eval_out" / "inference.pkl").is_file():
        raise AssertionError("the eval CLI disagrees with the validation or wrote no "
                             "inference.pkl")
    return record


def phase_trainer(device):
    """The port's CLIs at full width on configs/config_stage2.yaml (the
    released stage-2 MAED in f32, 3 + 4 clips of 16 frames and 7 images a
    step) over synthetic DBs of the fixture frames: one uninterrupted run of
    TRAINER_EPOCHS epochs of TRAINER_ITERS iterations; the same command
    (with TRAIN.RESUME auto) stopped by SIGTERM in epoch 2 and relaunched,
    whose last checkpoint and losses must equal the first run's; the eval
    CLI on model_best.pth.tar against its validation; the decoder against
    cv2's pixels; the 3D loader's rate alone. Prints one JSON record."""

    card = card_identity()
    torch.cuda.empty_cache()
    record = {"card": card, "decode": check_decoder(device)}
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        write_trainer_dbs(workdir)
        record.update(trainer_cli_runs(workdir, "config_stage2.yaml", trainer_overrides,
                                       TRAINER_ITERS, TRAINER_EPOCHS))
        resume = record["resume"]
        print(f"  the resumed run: losses max rel {resume['loss_max_rel']:.3e} (bound "
              f"{RESUME_LOSS_RTOL}), state rel L2 {resume['state_rel_l2']:.3e} (bound "
              f"{RESUME_PARAM_RTOL})")
        if not (resume["loss_max_rel"] <= RESUME_LOSS_RTOL
                and resume["state_rel_l2"] <= RESUME_PARAM_RTOL):
            raise AssertionError("the resumed run left the uninterrupted one")
        record["loader"] = [loader_rate(workdir, w) for w in (0, 8)]
        print("  3D loader alone: " + ", ".join(
            f"{r['clips_per_s']:.1f} clips/s with {r['used']} workers" for r in record["loader"]))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"trainer": record}))
    return record


# phase_stage1: stage 1 (configs/config_stage1.yaml: the ResNet-50 with
# BatchNorm and KTD, image-only, 128 images a step) at full width
STAGE1_IMAGES, STAGE1_STEPS = 128, 3
STAGE1_ITERS, STAGE1_EPOCHS = 3, 2
# f32, the steps through kernel A against the same steps through its plain
# version from the same weights and generator. Each step's loss within
# TRAIN_LOSS_RTOL and the first step's gradient within TRAIN_GRAD_RTOL; the
# BatchNorm statistics after the first step (its forward's) within
# STAGE1_STATS_RTOL relative L2, each running_mean and running_var. After an
# Adam update f32 itself cannot hold them that close: the first update,
# lr g / (|g| + eps), turns the ResNet's f32 gradient error (6.7e-3 relative
# L2 from an f64 step at these random weights on an H100, on either path)
# into whole steps of lr, and the f32 statistics after the second and third
# steps lie 7e-4 and 5e-3 from the f64 run's, on either path (PERF.md). So
# from the second step on, the statistics, and every step's loss and the
# first gradient too, are held as the stem's gradient is (F32_GRAD_RATIO):
# through the kernels at most F32_GRAD_RATIO times as far from the same
# steps in f64 as through the plain versions.
STAGE1_STATS_RTOL = 1e-5


class Stage1Recipe:
    """configs/config_stage1.yaml's optimizer: Adam at 1e-4 with L2 1e-5, no
    warmup, milestones at 60 and 90."""
    OPTIM, LR, WD, MOMENTUM = "adam", 1e-4, 1e-5, 0.9
    WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES = 0, 0.1, [60, 90]


def make_image_batch(smpl, device, n, seed=5):
    """A stage-1 step's batch: n uint8 images at IMG^2 with targets from
    :func:`consistent_targets` (one frame each)."""
    rng = np.random.RandomState(seed)
    image = torch.from_numpy(rng.randint(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)).to(device)
    tgt = consistent_targets(rng, smpl, n, 1, device)
    return {"image": image, "kp_2d": tgt["kp_2d"][:, 0], "kp_3d": tgt["kp_3d"][:, 0],
            "theta": tgt["theta"][:, 0], "w_smpl": torch.ones((n,), device=device)}


def stage1_steps(model, smpl, img, steps, plain=False, seed=7):
    """``steps`` stage-1 steps (the image batch alone) of ``model`` from a new
    optimizer and a generator seeded with ``seed``. Returns a dict: each
    step's loss, the first step's whole gradient, the kernel launches over
    all the steps (counted from 0), the host-clock ms of each step
    (CUDA-synchronised), the peak device memory, and after each step the
    BatchNorm running statistics."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    device = next(model.parameters()).device
    step = make_train_step(model, make_optimizer(Stage1Recipe, 500, model.parameters()), smpl,
                           LossWeights(), torch.Generator(device=device).manual_seed(seed),
                           plain=plain)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    run = dict(losses=[], ms=[], stats=[], grad=None)
    kernels.reset_launches()
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = step(None, img)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"stage 1: non-finite loss terms {metrics}")
        run["losses"].append(metrics["loss"].item())
        run["stats"].append({k: v.clone() for k, v in model.state_dict().items()
                             if k.endswith(("running_mean", "running_var"))})
        if i == 0:
            run["grad"] = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    run["launches"] = dict(kernels.LAUNCHES)
    run["peak"] = torch.cuda.max_memory_allocated(device)
    return run


def stats_distance(a: dict, b: dict) -> float:
    """The largest relative L2 distance between two sets of BatchNorm buffers."""
    return max(rel_l2(a[k], b[k]) for k in a)


def stage1_f64(start, smpl, img, device):
    """The same steps through the plain versions in f64 from the f32 weights
    ``start``."""
    from maed_tpu_torch.core.builder import build_train_model

    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() else t

    model, _ = build_train_model(encoder="cnn", decoder="ktd", dtype=torch.float64,
                                 device=device, seed=0, allow_synthetic_smpl=True)
    model.double().load_state_dict({k: f64(v) for k, v in start.items()})
    run = stage1_steps(model, type(smpl)(*map(f64, smpl)), {k: f64(v) for k, v in img.items()},
                       STAGE1_STEPS, plain=True)
    del model
    torch.cuda.empty_cache()
    return run


def stage1_step_phase(device, record):
    """The f32 stage-1 step at full width through kernel A, through its
    plain version and in f64; returns the trained state_dict and the
    steps' launches."""
    from maed_tpu_torch.core.builder import build_train_model

    t0 = time.perf_counter()
    model, smpl = build_train_model(encoder="cnn", decoder="ktd", device=device, seed=0,
                                    allow_synthetic_smpl=True)
    img = make_image_batch(smpl, device, STAGE1_IMAGES)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    print(f"stage 1 f32: built cnn + ktd in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters), "
          f"{STAGE1_IMAGES} images a step at {IMG}^2, uint8")
    kern = stage1_steps(model, smpl, img, STAGE1_STEPS)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    expect_launches(kern["launches"], "cnn", STAGE1_STEPS)
    if int(trained["encoder.bn1.num_batches_tracked"]) != STAGE1_STEPS or torch.equal(
            trained["encoder.bn1.running_var"], start["encoder.bn1.running_var"]):
        raise AssertionError("stage 1: the steps left the BatchNorm statistics as they were")
    model.load_state_dict(start)
    plain = stage1_steps(model, smpl, img, STAGE1_STEPS, plain=True)
    del model
    torch.cuda.empty_cache()
    if any(plain["launches"].values()):
        raise AssertionError(f"stage 1: the plain steps launched {plain['launches']}")
    exact = stage1_f64(start, smpl, img, device)

    loss_rel = [abs(a - b) / abs(b) for a, b in zip(kern["losses"], plain["losses"])]
    loss_64 = [(abs(a - c), abs(b - c)) for a, b, c in
               zip(kern["losses"], plain["losses"], exact["losses"])]
    grad_rel = rel_l2(kern["grad"], plain["grad"])
    grad_64 = (rel_l2(kern["grad"], exact["grad"]), rel_l2(plain["grad"], exact["grad"]))
    stats_rel = [stats_distance(a, b) for a, b in zip(kern["stats"], plain["stats"])]
    stats_64 = [(stats_distance(a, c), stats_distance(b, c))
                for a, b, c in zip(kern["stats"], plain["stats"], exact["stats"])]
    ms = float(np.median(kern["ms"][1:]))
    record["step"] = dict(
        ms_per_step=ms, step_ms=kern["ms"], peak_memory_bytes=kern["peak"],
        losses=kern["losses"], plain_step_ms=plain["ms"], f64_step_ms=exact["ms"],
        plain_peak_memory_bytes=plain["peak"], loss_rel=loss_rel, grad_rel_l2=grad_rel,
        bn_stats_max_rel_l2=stats_rel, loss_abs_to_f64=loss_64, grad_rel_l2_to_f64=grad_64,
        bn_stats_max_rel_l2_to_f64=stats_64, launches=kern["launches"])
    print(f"  {record['card']}: {ms:.1f} ms a step (median of steps 2-{STAGE1_STEPS}; each "
          + ", ".join(f"{t:.1f}" for t in kern["ms"]) + f"), peak memory "
          f"{kern['peak'] / 2 ** 30:.2f} GiB; plain " + ", ".join(f"{t:.1f}" for t in plain["ms"])
          + " ms; f64 " + ", ".join(f"{t:.1f}" for t in exact["ms"]) + " ms")
    print(f"  launches over {STAGE1_STEPS} steps: "
          f"{ {k: v for k, v in kern['launches'].items() if v} }")
    print("  kernels vs plain, each step: loss rel " + ", ".join(f"{r:.3e}" for r in loss_rel)
          + f" (bound {TRAIN_LOSS_RTOL}); BatchNorm statistics max rel L2 "
          + ", ".join(f"{r:.3e}" for r in stats_rel)
          + f" (bound {STAGE1_STATS_RTOL} after step 1); step 1 gradient rel L2 {grad_rel:.3e} "
          f"(bound {TRAIN_GRAD_RTOL})")
    print("  against the f64 steps (kernels, plain): loss abs "
          + ", ".join(f"({a:.3e}, {b:.3e})" for a, b in loss_64) + "; statistics "
          + ", ".join(f"({a:.3e}, {b:.3e})" for a, b in stats_64)
          + f"; step 1 gradient ({grad_64[0]:.3e}, {grad_64[1]:.3e}) (ratio bound "
          f"{F32_GRAD_RATIO})")
    ratios = [a <= F32_GRAD_RATIO * b for a, b in loss_64 + stats_64[1:] + [grad_64]]
    if not (max(loss_rel) <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL
            and stats_rel[0] <= STAGE1_STATS_RTOL and all(ratios)):
        raise AssertionError("stage 1: the f32 steps through kernel A left the plain ones")
    return trained, kern["launches"]


def stage1_eval_phase(device, record, trained):
    """One bf16 eval forward of N_CLIPS x SEQLEN frames through cnn + ktd (the
    trained weights and statistics) and cnn + iterative (seeded), each held
    by BF16_RATIO to the f32 plain forward; returns the launches of the
    first."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.builder import build_eval_model

    clips = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (N_CLIPS, SEQLEN, IMG, IMG, 3), dtype=np.uint8)).to(device)
    eval_launches = None
    for decoder, state in (("ktd", trained), ("iterative", None)):
        kw = dict(encoder="cnn", decoder=decoder, device=device, seed=1, allow_synthetic_smpl=True)
        f32_model, smpl = build_eval_model(dtype=torch.float32, state_dict=state, **kw)
        want = f32_model(clips, smpl, plain=True)
        state = f32_model.state_dict()
        del f32_model
        model, _ = build_eval_model(dtype=torch.bfloat16, state_dict=state, **kw)
        model(clips, smpl)  # warmup
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = model(clips, smpl)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        expect_launches(launches, "cnn", 1)
        check_outputs(out, clips=N_CLIPS, joints=49)
        plain = model(clips, smpl, plain=True)
        check_bf16_ratio(f"stage 1 cnn + {decoder}", [out], [plain], [want])
        record[f"eval_{decoder}"] = dict(bf16_forward_ms=ms, launches=launches,
                                         device_ms=time_ms(lambda: model(clips, smpl), 4))
        print(f"  cnn + {decoder}: bf16 forward of {N_CLIPS}x{SEQLEN}x{IMG}^2 uint8 {ms:.2f} ms "
              f"(host clock), {record[f'eval_{decoder}']['device_ms']:.2f} ms (device, mean of "
              f"4); launches { {k: v for k, v in launches.items() if v} }")
        eval_launches = eval_launches or launches
        del model, want, out, plain
        torch.cuda.empty_cache()
    return eval_launches


def write_stage1_dbs(workdir: Path, seed: int = 13):
    """Stage 1's DBs over the fixture frames, as plain pickles under
    ``<workdir>/data/database``: 640 images (five batches of
    STAGE1_IMAGES: the loader drops a partial batch) and 2 validation videos
    of one 128-frame window each."""
    import pickle

    rng = np.random.RandomState(seed)
    frames = [str(p) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    image = synthetic_video_db(rng, frames, 1, 5 * STAGE1_IMAGES)
    dbs = {"synimg_train": {k: v for k, v in image.items() if k not in ("vid_name", "frame_id")},
           "3dpw_val": synthetic_video_db(rng, frames, 2, POOL)}
    (workdir / "data" / "database").mkdir(parents=True)
    for name, db in dbs.items():
        with open(workdir / "data" / "database" / f"{name}_db.pt", "wb") as f:
            pickle.dump(db, f)


def stage1_overrides(out: str):
    return ["DEVICE", "cuda", "OUTPUT_DIR", out, "SEED_VALUE", "7",
            "NUM_WORKERS", str(max(1, (os.cpu_count() or 2) - 1)),
            "TRAIN.DATASETS_IMG", "[synimg]", "TRAIN.DATASET_EVAL", "3dpw",
            "TRAIN.BATCH_SIZE_IMG", str(STAGE1_IMAGES),
            "TRAIN.NUM_ITERS_PER_EPOCH", str(STAGE1_ITERS), "TRAIN.END_EPOCH", str(STAGE1_EPOCHS),
            "SAVE_FREQ", "1", "DEBUG_FREQ", "1",
            # deterministic cuDNN algorithms, for the resumed run to equal the first
            "CUDNN.BENCHMARK", "false", "CUDNN.DETERMINISTIC", "true"]


def stage1_cli_phase(workdir: Path, record):
    """``python -m maed_tpu_torch.train --cfg configs/config_stage1.yaml`` at
    full width through :func:`trainer_cli_runs`: the resumed run under
    torchrun must be the uninterrupted one under torchrun bit for bit, every
    step's losses and the last checkpoint, BatchNorm buffers included. The
    one rank's BatchNorm takes the group's moments (another rounding than
    ``F.batch_norm`` without a group), so against the run without a
    launcher its first step's loss is held as phase_stage1 holds the first
    step (TRAIN_LOSS_RTOL); after Adam's updates f32 cannot hold two
    roundings together (section 6 of PERF.md)."""
    write_stage1_dbs(workdir)
    record["cli"] = trainer_cli_runs(workdir, "config_stage1.yaml", stage1_overrides,
                                     STAGE1_ITERS, STAGE1_EPOCHS, torchrun_reference=True)
    resume, launcher = record["cli"]["resume"], record["cli"]["launcher"]
    if not (resume["losses_equal"] and resume["bit_equal"] and resume["buffers"]):
        raise AssertionError("the resumed stage-1 run is not the uninterrupted one bit for bit")
    if not launcher["first_loss_rel"] <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"stage-1 CLI under torchrun: step 1 loss rel "
                             f"{launcher['first_loss_rel']:.3e} from the run without a launcher, "
                             f"beyond {TRAIN_LOSS_RTOL}")


def npz_from_state_dict(sd: dict, heads: int = 12) -> dict:
    """A stage-2 encoder's weights (the port's names, torch layouts) as the
    published in21k .npz names them: TF/JAX naming, HWIO convs, (in, out)
    dense kernels, q, k and v apart as (C, h, d), the attention's out kernel
    as (h, d, C); with a classifier head, and without MAED's own gate and
    temp_embed."""
    out = {"head/kernel": np.ones((768, 8), np.float32), "head/bias": np.zeros(8, np.float32)}
    gn, abc = {"weight": "gamma", "bias": "beta"}, {"1": "a", "2": "b", "3": "c"}
    leaf = {"weight": "kernel", "bias": "bias"}
    bb = r"encoder\.patch_embed\.backbone\."
    for key, value in sd.items():
        v = value.detach().cpu().numpy()
        tf = v.transpose(2, 3, 1, 0) if v.ndim == 4 else (v.T if v.ndim == 2 else v)
        if key == "encoder.patch_embed.backbone.stem.conv.weight":
            out["resnet/root_block/standardized_conv2d/kernel"] = tf
        elif m := re.fullmatch(bb + r"stem\.norm\.(weight|bias)", key):
            out[f"resnet/group_norm/{gn[m[1]]}"] = v
        elif m := re.fullmatch(bb + r"stages\.(\d+)\.blocks\.(\d+)\.(.+)", key):
            unit, rest = f"resnet/block{int(m[1]) + 1}/unit{int(m[2]) + 1:02d}", m[3]
            if mm := re.fullmatch(r"conv(\d)\.weight", rest):
                out[f"{unit}/{abc[mm[1]]}/standardized_conv2d/kernel"] = tf
            elif mm := re.fullmatch(r"norm(\d)\.(weight|bias)", rest):
                out[f"{unit}/{abc[mm[1]]}/group_norm/{gn[mm[2]]}"] = v
            elif rest == "downsample.conv.weight":
                out[f"{unit}/a/proj/standardized_conv2d/kernel"] = tf
            elif mm := re.fullmatch(r"downsample\.norm\.(weight|bias)", rest):
                out[f"{unit}/a/proj/group_norm/{gn[mm[1]]}"] = v
        elif m := re.fullmatch(r"encoder\.patch_embed\.proj\.(weight|bias)", key):
            out[f"embedding/{leaf[m[1]]}"] = tf
        elif key == "encoder.cls_token":
            out["cls"] = v
        elif key == "encoder.pos_embed":
            out["Transformer/posembed_input/pos_embedding"] = v
        elif m := re.fullmatch(r"encoder\.norm\.(weight|bias)", key):
            out[f"Transformer/encoder_norm/{'scale' if m[1] == 'weight' else 'bias'}"] = v
        elif m := re.fullmatch(r"encoder\.pre_logits\.fc\.(weight|bias)", key):
            out[f"pre_logits/{leaf[m[1]]}"] = tf
        elif m := re.fullmatch(r"encoder\.blocks\.(\d+)\.(.+)", key):
            base, rest = f"Transformer/encoderblock_{m[1]}", m[2]
            attn = f"{base}/MultiHeadDotProductAttention_1"
            C = v.shape[-1]
            if mm := re.fullmatch(r"norm([12])\.(weight|bias)", rest):
                ln = 0 if mm[1] == "1" else 2
                out[f"{base}/LayerNorm_{ln}/{'scale' if mm[2] == 'weight' else 'bias'}"] = v
            elif mm := re.fullmatch(r"mlp\.fc([12])\.(weight|bias)", rest):
                out[f"{base}/MlpBlock_3/Dense_{int(mm[1]) - 1}/{leaf[mm[2]]}"] = tf
            elif rest == "attn.proj.weight":
                out[f"{attn}/out/kernel"] = tf.reshape(heads, C // heads, C)
            elif rest == "attn.proj.bias":
                out[f"{attn}/out/bias"] = v
            elif rest.startswith("attn.qkv."):
                C = v.shape[0] // 3
                for i, n in enumerate(("query", "key", "value")):
                    if rest.endswith("weight"):
                        out[f"{attn}/{n}/kernel"] = tf[:, i * C:(i + 1) * C].reshape(
                            C, heads, C // heads)
                    else:
                        out[f"{attn}/{n}/bias"] = v[i * C:(i + 1) * C].reshape(heads, C // heads)
    return out


def stage1_import_phase(device, workdir: Path, record):
    """``--init_backbone``'s function at full width: a published init of 12
    blocks, seeded random weights, written as the in21k .npz and as a timm
    .pth, each loaded into the stage-2 model of 6 blocks. Every mapped tensor
    must equal its source; MAED's own gate and temp_embed, and the decoder,
    keep their init; blocks 6-11 of the file are left out."""
    from maed_tpu_torch.core.builder import build_train_model, empty_model, init_weights_
    from maed_tpu_torch.utils.pretrained import apply_pretrained_backbone

    own = ("ts_attn", "temp_embed")  # MAED's own parameters, not in a published init
    published = empty_model(device, num_blocks=12)
    init_weights_(published, seed=9)
    source = {k: v.detach().clone() for k, v in published.state_dict().items()
              if k.startswith("encoder.")}
    del published
    np.savez(workdir / "in21k.npz", **npz_from_state_dict(source))
    timm = {k[len("encoder."):]: v.cpu() for k, v in source.items()
            if not any(o in k for o in own)}
    timm.update({"head.weight": torch.ones(8, 768), "head.bias": torch.zeros(8)})
    torch.save(timm, workdir / "in21k.pth")
    model, _ = build_train_model(device=device, seed=0, allow_synthetic_smpl=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    record["import"] = {}
    for name in ("in21k.npz", "in21k.pth"):
        model.load_state_dict(init)
        t0 = time.perf_counter()
        unused = apply_pretrained_backbone(model, str(workdir / name))
        seconds = time.perf_counter() - t0
        got = model.state_dict()
        mapped = [k for k in got if k in source and not any(o in k for o in own)]
        kept = [k for k in got if k not in mapped]
        bad = ([k for k in mapped if not torch.equal(got[k], source[k])]
               + [k for k in kept if not torch.equal(got[k], init[k])])
        left_out = sorted({int(m[1]) for u in unused
                           if (m := re.match(r"encoder\.blocks\.(\d+)\.", u))})
        record["import"][name] = dict(mapped=len(mapped), kept=len(kept), unused=len(unused),
                                      blocks_left_out=left_out, s=seconds)
        print(f"  --init_backbone {name}: {len(mapped)} tensors equal to the file's, {len(kept)} "
              f"kept their init (the gate, temp_embed, the decoder), blocks {left_out} of the "
              f"file left out; {seconds:.2f} s")
        if bad or left_out != list(range(6, 12)) or not any("ts_attn" in k for k in kept):
            raise AssertionError(f"--init_backbone {name}: {len(bad)} tensors wrong, e.g. "
                                 f"{bad[:5]}; blocks left out {left_out}")
    del model


def phase_stage1(device):
    """Stage 1 at full width (the ResNet-50 with BatchNorm and KTD, 128
    images a step, f32, TF32 off, deterministic cuDNN): three steps through
    kernel A against the same steps through its plain version, running
    statistics included; a bf16 eval forward of cnn + ktd and of cnn +
    iterative held by BF16_RATIO; A at B = 128; the train CLI on
    configs/config_stage1.yaml, resumed after SIGTERM bit for bit, and the
    eval CLI; the published-backbone import. Prints one JSON record and
    returns A's launches in the steps and in one eval forward."""

    from maed_tpu_torch.ops import skinning

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    record = {"card": card_identity()}
    torch.cuda.empty_cache()
    trained, step_launches = stage1_step_phase(device, record)
    eval_launches = stage1_eval_phase(device, record, trained)
    del trained
    torch.cuda.empty_cache()
    args = skinning_inputs(np.random.RandomState(8), STAGE1_IMAGES, device)
    record["skinning"] = compare(
        f"skinning f32 at B = {STAGE1_IMAGES}", lambda: skinning.skinning(*args),
        lambda: skinning.skinning_reference(*args), 1e-5, 0.0, moved=args,
        flops=STAGE1_IMAGES * NUM_VERTS * (24 * 12 * 2 + 24), kind="f32", iters=50)
    record["skinning"]["device_ms"] = time_ms(lambda: skinning.skinning(*args), 50, queued=True)
    print(f"  {record['card']}: A at B = {STAGE1_IMAGES} {record['skinning']['ms']:.4f} ms "
          f"(events), {record['skinning']['device_ms']:.4f} ms on the device")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_stage1_"))
    try:
        stage1_cli_phase(workdir, record)
        stage1_import_phase(device, workdir, record)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"stage1": record}))
    return step_launches, eval_launches


# phase_demo and phase_preprocess: the host tools' paths that reach the
# kernels. Each runs its CLI as a child process that zeroes the launch counts
# before the module runs and prints them after it.
COUNTED_CHILD = """
import json, runpy, sys
from maed_tpu_torch import kernels
kernels.reset_launches()
module = sys.argv[1]
sys.argv = [module, *sys.argv[2:]]
runpy.run_module(module, run_name="__main__")
print("LAUNCHES " + json.dumps(kernels.LAUNCHES), flush=True)
"""
# frames of the demo's video: at least 65, so that the 128-frame window pads
# them by one reflection (a video under 65 frames is reflected more than
# once, and the protocol's valid mask then keeps the frames of the second
# reflection too, as in the JAX package: 40 frames give 79 predictions)
DEMO_FRAMES = 65
# 2 sequences of 2 people, 1200 frames each, a split: one 3DPW sequence file
THREEDPW_SEQS, THREEDPW_PEOPLE, THREEDPW_FRAMES = 2, 2, 1200


def run_counted(workdir: Path, module: str, args, log: Path, timeout: float = 600):
    """``python -m <module> <args>`` in ``workdir`` through COUNTED_CHILD:
    (its output, the launch counts of its run)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.run([sys.executable, "-c", COUNTED_CHILD, module, *args], cwd=workdir,
                              env=env, stdout=out, stderr=subprocess.STDOUT, timeout=timeout)
    text = log.read_text()
    print(f"  {module}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n" + text[-4000:])
    (line,) = [ln for ln in text.splitlines() if ln.startswith("LAUNCHES ")]
    return text, json.loads(line[len("LAUNCHES "):])


def number_after(text: str, pattern: str) -> float:
    match = re.search(pattern, text)
    if match is None:
        raise AssertionError(f"no line matches {pattern!r} in:\n{text[-2000:]}")
    return float(match.group(1))


def phase_demo(device):
    """``python -m maed_tpu_torch.demo`` as a user runs it, on the card: the
    released stage-2 MAED at full width and depth in f32 from a .pth.tar of
    seeded random weights, over DEMO_FRAMES frames copied in turn from the
    fixture JPEGs with seeded boxes, then ``--render``. Its inference.pkl is
    held against the same frames through ``demo.infer`` here with the
    kernels' plain versions (verts 1e-4 m, theta 1e-3: phase_f32's limits);
    its launches must be those of the f32 parallel forward, every kernel but
    K; an overlay PNG a frame, and ``python -m maed_tpu_torch.visualize`` on
    the same pkl must write the same PNGs, byte for byte. Prints the
    inference's frames/s and the host rasterizer's s a frame."""
    from maed_tpu_torch import demo
    from maed_tpu_torch.core.builder import (build_eval_model, build_train_model, load_weights,
                                             model_config)
    from maed_tpu_torch.core.config import update_cfg
    from maed_tpu_torch.data.dataset import read_pickled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()  # the child process needs the card's memory too
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_demo_"))
    try:
        frames = workdir / "frames"
        frames.mkdir()
        fixtures = sorted(FIXTURE_DIR.glob("frame_*.jpg"))
        for i in range(DEMO_FRAMES):
            shutil.copy(fixtures[i % len(fixtures)], frames / f"{i:06d}.jpg")
        rng = np.random.RandomState(17)
        boxes = np.concatenate([rng.uniform([200, 150], [280, 210], (DEMO_FRAMES, 2)),
                                rng.uniform(140, 200, (DEMO_FRAMES, 1)).repeat(2, 1)], 1)
        np.save(workdir / "boxes.npy", boxes.astype(np.float32))
        model, _ = build_train_model(device=device, seed=23, allow_synthetic_smpl=True)
        torch.save({"state_dict": model.state_dict()}, workdir / "weights.pth.tar")
        del model
        cfg_path = ROOT / "configs" / "config_stage2.yaml"
        common = ["--image_folder", str(frames), "--cfg", str(cfg_path), "--checkpoint",
                  str(workdir / "weights.pth.tar"), "--allow_synthetic_smpl"]
        text, launches = run_counted(
            workdir, "maed_tpu_torch.demo",
            [*common, "--bbox_file", str(workdir / "boxes.npy"), "--output_folder",
             str(workdir / "out"), "--render"], workdir / "demo.log")
        fps = number_after(text, r"inference: \d+ frames in [0-9.]+ s \(([0-9.]+) frames/s")
        raster_s = number_after(text, r"the rasterizer ([0-9.]+) s a frame")

        cfg = update_cfg(str(cfg_path))
        forwards = launches["layernorm"]  # one final LayerNorm a forward
        want_forwards = cfg.EVAL.SAMPLE_POOL // cfg.EVAL.SEQLEN  # one window batch of sub-clips
        if forwards != want_forwards:
            raise AssertionError(f"the demo ran {forwards} forwards, want {want_forwards}")
        for name, per in per_forward("parallel", dtype=torch.float32).items():
            if launches[name] != per * forwards:
                raise AssertionError(f"demo: {name} launched {launches[name]} times, want "
                                     f"{per} per forward x {forwards}")
        if launches["attention_blocked"] != 0:
            raise AssertionError("the demo's parallel model launched K")

        got = read_pickled(str(workdir / "out" / "inference.pkl"))
        model, smpl = build_eval_model(**model_config(cfg), dtype=torch.float32, device=device,
                                       state_dict=load_weights(str(workdir / "weights.pth.tar")),
                                       allow_synthetic_smpl=True)
        paths = [str(frames / f"{i:06d}.jpg") for i in range(DEMO_FRAMES)]
        plain = demo.infer(model, smpl, cfg, paths, boxes.astype(np.float32), plain=True)
        want = {k: np.concatenate(plain.accumulators[k]) for k in ("pred_theta", "pred_verts")}
        record = dict(card=card_identity(), frames=DEMO_FRAMES, forwards=forwards,
                      frames_per_s=fps, raster_s_per_frame=raster_s, launches=launches)
        for key, atol in (("pred_verts", 1e-4), ("pred_theta", 1e-3)):
            g = torch.from_numpy(np.asarray(got[key]))
            check_close(f"demo {key}, kernels vs plain", g, torch.from_numpy(want[key]), atol)
            record[f"{key}_max_abs_err"] = max_abs_err(g, torch.from_numpy(want[key]))
        if got["pred_verts"].shape != (DEMO_FRAMES, NUM_VERTS, 3):
            raise AssertionError(f"pred_verts {got['pred_verts'].shape}")

        overlays = sorted(os.listdir(workdir / "out" / "overlay"))
        if overlays != [f"{i:06d}_{i:06d}.png" for i in range(DEMO_FRAMES)]:
            raise AssertionError(f"overlays: {overlays[:3]}... ({len(overlays)})")
        run_counted(workdir, "maed_tpu_torch.visualize",
                    ["--input_file", str(workdir / "out" / "inference.pkl"), "--output_folder",
                     str(workdir / "vis"), "--allow_synthetic_smpl"], workdir / "vis.log")
        for name in overlays:
            demo_png = (workdir / "out" / "overlay" / name).read_bytes()
            if (workdir / "vis" / name).read_bytes() != demo_png:
                raise AssertionError(f"visualize wrote another {name} than the demo")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"  demo ({record['card']}): {DEMO_FRAMES} frames, {forwards} f32 forwards of "
          f"{cfg.EVAL.BATCH_SIZE} clips x {cfg.EVAL.SEQLEN}: {fps} frames/s; the host "
          f"rasterizer {raster_s} s a frame; verts {record['pred_verts_max_abs_err']:.3e}, "
          f"theta {record['pred_theta_max_abs_err']:.3e} from the plain versions")
    print(json.dumps({"demo": record}))
    return record


def write_threedpw_raw(root: Path, seed: int = 19):
    """The 3DPW raw layout at the size of real sequence files: for each
    split THREEDPW_SEQS sequences of THREEDPW_PEOPLE people over
    THREEDPW_FRAMES frames (poses (T, 72), betas (10,), poses2d (T, 3, 18)
    in a 1080 x 1920 frame, campose_valid, cam_poses (T, 4, 4),
    img_frame_ids); the test split's frames link to the fixture JPEGs."""
    import pickle

    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    fixtures = sorted(FIXTURE_DIR.glob("frame_*.jpg"))
    T = THREEDPW_FRAMES
    for split in ("train", "validation", "test"):
        (root / "sequenceFiles" / split).mkdir(parents=True)
        for s in range(THREEDPW_SEQS):
            cam = np.tile(np.eye(4), (T, 1, 1))
            cam[:, :3, :3] = Rotation.random(T, random_state=rng).as_matrix()
            cam[:, :3, 3] = rng.randn(T, 3)
            centre = rng.uniform([300, 400], [800, 1500], (THREEDPW_PEOPLE, T, 1, 2))
            xy = centre.transpose(0, 1, 3, 2) + rng.randn(THREEDPW_PEOPLE, T, 2, 18) * 60
            p2d = np.concatenate([xy, rng.uniform(0.0, 1.0, (THREEDPW_PEOPLE, T, 1, 18))], axis=2)
            seq = {"poses": [rng.randn(T, 72) * 0.3 for _ in range(THREEDPW_PEOPLE)],
                   "betas": [rng.randn(10) * 0.5 for _ in range(THREEDPW_PEOPLE)],
                   "poses2d": list(p2d),
                   "campose_valid": [rng.rand(T) > 0.05 for _ in range(THREEDPW_PEOPLE)],
                   "cam_poses": cam, "img_frame_ids": np.arange(T)}
            name = f"{split}_{s:02d}"
            with open(root / "sequenceFiles" / split / f"{name}.pkl", "wb") as f:
                pickle.dump(seq, f)
            if split == "test":
                images = root / "imageFiles" / name
                images.mkdir(parents=True)
                for i in range(T):
                    (images / f"image_{i:05d}.jpg").symlink_to(fixtures[i % len(fixtures)])


def phase_preprocess(device):
    """``python -m maed_tpu_torch.data.preprocess.threedpw`` on the card over
    a synthetic raw layout (write_threedpw_raw: 4 people x 1200 frames a
    split); each DB's joints3D held against the same split read here through
    the skinning's plain version (1e-4 m), every other field equal; A's
    launches (one a person's sequence); the port's VideoDataset reads a
    window of the test DB. Prints the preprocessor's rate: a DB's frames
    over the seconds of its split."""
    from maed_tpu_torch.data.dataset import VideoDataset, read_pickled
    from maed_tpu_torch.data.preprocess import threedpw
    from maed_tpu_torch.data.transforms import build_eval_transforms
    from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_preprocess_"))
    try:
        write_threedpw_raw(workdir / "3dpw")
        text, launches = run_counted(
            workdir, "maed_tpu_torch.data.preprocess.threedpw",
            ["--inp_dir", str(workdir / "3dpw"), "--out_dir", str(workdir / "db"),
             "--allow_synthetic_smpl"], workdir / "threedpw.log")
        rates = [float(r) for r in re.findall(r"\(([0-9.]+) frames/s\)", text)]
        people = THREEDPW_SEQS * THREEDPW_PEOPLE
        if launches["skinning"] != 3 * people:
            raise AssertionError(f"3DPW: skinning launched {launches['skinning']} times, want "
                                 f"{3 * people} (a person's sequence each)")
        smpl = synthetic_smpl_model(NUM_VERTS, device=device)
        errs = {}
        for split, name in (("validation", "val"), ("train", "train"), ("test", "test")):
            got = read_pickled(str(workdir / "db" / f"3dpw_{name}_db.pt"))
            want = threedpw.read_data(str(workdir / "3dpw"), split, smpl, plain=True)
            if sorted(got) != sorted(want):
                raise AssertionError(f"3DPW {split}: keys {sorted(got)}")
            for key in want:
                if key == "joints3D":
                    errs[split] = float(np.abs(got[key] - want[key]).max())
                    if not errs[split] <= 1e-4:
                        raise AssertionError(f"3DPW {split} joints3D: {errs[split]} m from the "
                                             "plain version, beyond 1e-4")
                elif not np.array_equal(got[key], want[key]):
                    raise AssertionError(f"3DPW {split}: {key} differs from the plain read")
        ds = VideoDataset("3dpw", "test", build_eval_transforms(IMG, IMG), seqlen=0,
                          sample_pool=POOL, overlap=0, random_sample=False,
                          db_dir=str(workdir / "db"), verbose=False)
        item = ds[0]
        if item["images"].shape != (POOL, IMG, IMG, 3) or not np.isfinite(item["images"]).all():
            raise AssertionError(f"the test DB's first window: {item['images'].shape}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    record = dict(card=card_identity(), people_frames=3 * people * THREEDPW_FRAMES,
                  frames_per_s=rates, joints3d_max_abs_err=errs, windows=len(ds),
                  launches=launches)
    print(f"  3DPW ({record['card']}): {record['people_frames']} input frames of 3 splits, the "
          f"DBs' frames at {rates} frames/s a split; joints3D {errs} m from the plain version; "
          f"{len(ds)} test windows")
    print(json.dumps({"preprocess": record}))
    return record


def csrc_kernel_names() -> set:
    """The names of the __global__ functions of maed_tpu_torch/csrc."""
    names = set()
    for src in (ROOT / "maed_tpu_torch" / "csrc").glob("*.cu"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                src.read_text()))
    return names


def phase_accept(device):
    """``python -m maed_tpu_torch.tools.accept_synthetic all`` as a user runs
    it, at the JAX tool's defaults on the card (tools.accept_synthetic's
    functions, in this process, with the CLIs as subprocesses through
    COUNTED_CHILD): 6 + 2 videos of 96 frames at 64 px through the port's
    SMPL forward (kernel A) and JPEG encoder, the GT oracle through the
    eval protocol (every metric below 0.1 mm), then the eval CLI on the
    untrained init, the train CLI (1 block, 2 heads: head dim 384, the
    general spatial kernel; 6 epochs of 50 iterations) and the eval CLI on
    its model_best: trained PA-MPJPE below 0.7 x untrained. The train CLI
    runs with MAED_PROFILE_DIR over its first 3 steps: the Chrome trace
    must name the port's kernels; its logdir's event file must parse with
    the port's reader and hold the train tags and eval/pa-mpjpe."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.tools import accept_synthetic as acc
    from maed_tpu_torch.utils.summary import read_events

    torch.cuda.empty_cache()  # the CLIs need the card's memory too
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_accept_"))
    profile = workdir / "profile"
    saved = {k: os.environ.get(k) for k in ("MAED_PROFILE_DIR", "MAED_PROFILE_STEPS")}
    os.environ.update(MAED_PROFILE_DIR=str(profile), MAED_PROFILE_STEPS="3")
    try:
        t0 = time.perf_counter()
        kernels.reset_launches()
        acc.generate(str(workdir), device=device)
        t1 = time.perf_counter()
        oracle = acc.oracle(str(workdir), tol_mm=0.1, device=device)
        t2 = time.perf_counter()
        launches = dict(kernels.LAUNCHES)  # generate's and the oracle's forwards
        logs = []
        result = acc.train_and_eval(str(workdir), margin=0.7, device=device.type,
                                    launcher=[sys.executable, "-c", COUNTED_CHILD], logs=logs)
        t3 = time.perf_counter()
        for text in logs:  # each CLI's own counts, from 0 at its start to its end
            (line,) = [ln for ln in text.splitlines() if ln.startswith("LAUNCHES ")]
            for k, n in json.loads(line[len("LAUNCHES "):]).items():
                launches[k] += n
        (trace,) = profile.glob("maed_trace_*.json")
        events = json.loads(trace.read_text())["traceEvents"]
        ran = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        ours = sorted(k for k in csrc_kernel_names() if any(k in name for name in ran))
        annotated = {e.get("name") for e in events} & {"train_step", "data"}
        print(f"  the trace of the train CLI's first 3 steps: {len(ran)} kernels, the port's "
              f"{ours}; annotations {sorted(annotated)}")
        if "general_frames_kernel" not in ours or not any("skinning" in k for k in ours) \
                or annotated != {"train_step", "data"}:
            raise AssertionError(f"accept: the trace does not name the port's kernels: {ours}")

        (run,) = (workdir / "results").iterdir()
        (event_file,) = run.glob("events.out.tfevents.*")
        read = read_events(str(event_file))
        tags = {tag for e in read for tag, _ in e["scalars"]}
        if read[0].get("file_version") != "brain.Event:2" or not {
                "train_loss/loss", "train_loss/loss_kp_3d", "eval/pa-mpjpe"} <= tags:
            raise AssertionError(f"accept: the event file lacks the expected scalars: {tags}")
        if not launches["spatial_attention_general"] or not launches["skinning"]:
            raise AssertionError(f"accept: the general spatial kernel or A did not run: {launches}")
        record = dict(card=card_identity(), oracle_mm=oracle,
                      untrained_pa_mpjpe=result["untrained"]["pa-mpjpe"],
                      trained_pa_mpjpe=result["trained"]["pa-mpjpe"],
                      ratio=result["trained"]["pa-mpjpe"] / result["untrained"]["pa-mpjpe"],
                      generate_s=t1 - t0, oracle_s=t2 - t1, clis_s=t3 - t2,
                      event_scalars=sum(len(e["scalars"]) for e in read),
                      trace_kernels=ours, launches=launches)
        print(f"  accept ({record['card']}): oracle PA-MPJPE {oracle['pa-mpjpe']:.2e} mm, "
              f"untrained {record['untrained_pa_mpjpe']:.2f} -> trained "
              f"{record['trained_pa_mpjpe']:.2f} mm ({record['ratio']:.3f}x); generate "
              f"{t1 - t0:.1f} s, oracle {t2 - t1:.1f} s, the three CLIs {t3 - t2:.1f} s; "
              f"{record['event_scalars']} scalars in the event file")
        print(json.dumps({"accept": record}))
        return record
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(workdir, ignore_errors=True)


def phase_bench_train(device):
    """``python -m maed_tpu_torch.tools.bench_train`` as a user runs it, in
    this process (its ``main``): the timing mode at the flagship in bf16 (5
    timed steps) and at stage 1 (3), then ``--learn 20 --smoke`` in bf16 and
    f32 (1 block, 2 heads at 64 px: head dim 384, the general spatial and
    temporal kernels), whose losses must be finite. Prints ms a step,
    frames/s and the trajectories' head and tail; the launches of the whole
    phase, counted from 0."""
    from maed_tpu_torch import kernels
    from maed_tpu_torch.tools import bench_train

    record = {"card": card_identity()}
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_bench_train_"))
    try:
        kernels.reset_launches()
        record["flagship_bf16"] = bench_train.main(["--iters", "5"])
        torch.cuda.empty_cache()
        record["stage1_bf16"] = bench_train.main(["--stage1", "--iters", "3"])
        torch.cuda.empty_cache()
        for dt in ("bf16", "f32"):
            out = workdir / f"soak_{dt}.json"
            soak = bench_train.main(["--learn", "20", "--smoke", "--dtype", dt, "--out", str(out)])
            if not np.isfinite(soak["losses"]).all() or json.loads(out.read_text())["steps"] != 20:
                raise AssertionError(f"bench_train --smoke {dt}: {soak}")
            record[f"smoke_{dt}"] = {k: soak[k] for k in ("head_mean", "tail_mean", "ratio",
                                                          "wall_s")}
        launches = dict(kernels.LAUNCHES)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for name in ("spatial_attention_general", "temporal_attention_general", "spatial_attention",
                 "temporal_attention", "skinning"):
        if not launches[name]:
            raise AssertionError(f"bench_train: {name} was not launched: {launches}")
    record["launches"] = launches
    print(f"  bench_train ({record['card']}): flagship bf16 {record['flagship_bf16']['ms']:.1f} "
          f"ms a step ({record['flagship_bf16']['frames_per_s']:.0f} frames/s), stage 1 "
          f"{record['stage1_bf16']['ms']:.1f} ms ({record['stage1_bf16']['frames_per_s']:.0f} "
          f"frames/s); --smoke soaks " + ", ".join(
              f"{dt} {record[f'smoke_{dt}']['head_mean']:.4f} -> "
              f"{record[f'smoke_{dt}']['tail_mean']:.4f}" for dt in ("bf16", "f32")))
    print(json.dumps({"bench_train": record}))
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "maed_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: maed_tpu_torch not found beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from maed_tpu_torch import kernels

    device = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(card_identity())

    t0 = t_start = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    seconds = {}  # each phase's, host clock: the script must stay well inside its limit

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t0, 1)
        print(f"{phase.__name__}: {seconds[phase.__name__]} s")
        return out

    record = timed(phase_kernels, device)
    clips, jreg = make_requests(device)
    launches, outs, plains, eager_ms = timed(phase_serve, device, clips, jreg)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    try:
        served = timed(phase_export, device, workdir, clips, jreg, outs, eager_ms)
        wants, f32_launches = timed(phase_f32, device, clips, jreg, outs, plains)
        timed(phase_http, device, workdir, clips, outs, plains, wants, served)
        tp = timed(phase_tp, device, clips, jreg, plains, wants)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    del outs, plains, wants
    timed(phase_device_crop, device)
    eval_launches, coupling_f32_launches = timed(phase_eval, device)
    timed(phase_modes, device, clips[0], jreg)
    surface_f32 = timed(phase_surface, device)
    train_launches, train_f32_launches = timed(phase_train, device)
    timed(phase_ddp, device)
    timed(phase_trainer, device)
    stage1_step, stage1_eval = timed(phase_stage1, device)
    demo = timed(phase_demo, device)["launches"]
    preprocess = timed(phase_preprocess, device)["launches"]
    accept = timed(phase_accept, device)["launches"]
    bench = timed(phase_bench_train, device)["launches"]
    print(json.dumps({"phase_seconds": seconds, "card": card_identity(),
                      "total_s": round(time.perf_counter() - t_start, 1)}))

    src, jax_ops = "maed_tpu_torch/", "maed_tpu/ops/"
    kernels_line = [
        dict(name="skinning", route="cuda", source=src + "csrc/skinning.cu",
             replaces=jax_ops + "smpl_pallas.py:30",
             launches=launches["skinning"],
             launches_train=train_launches["skinning"],
             launches_served=served["launches"]["skinning"],
             launches_stage1_steps=stage1_step["skinning"],
             launches_stage1_eval=stage1_eval["skinning"],
             launches_demo=demo["skinning"],
             launches_preprocess=preprocess["skinning"],
             **record["skinning"]),
        dict(name="fast_layernorm", route="triton", source=src + "ops/layernorm.py",
             replaces=jax_ops + "layernorm.py:60",
             launches=launches["layernorm"],
             launches_train=train_launches["layernorm"],
             launches_served=served["launches"]["layernorm"],
             launches_demo=demo["layernorm"],
             **record["layernorm"]),
        dict(name="fused_ln_mlp", route="cuda", source=src + "csrc/ln_mlp.cu",
             replaces=jax_ops + "mlp.py:99",
             launches=launches["ln_mlp_fc1"], launches_fc2=launches["ln_mlp_fc2"],
             launches_train=train_launches["ln_mlp_fc1"],
             launches_served=served["launches"]["ln_mlp_fc1"],
             launches_demo=demo["ln_mlp_fc1"],
             **record["ln_mlp"]),
        dict(name="fused_ln_dense", route="cuda", source=src + "csrc/ln_mlp.cu",
             replaces=jax_ops + "mlp.py:157",
             launches=launches["ln_dense"],
             launches_train=train_launches["ln_dense"],
             launches_served=served["launches"]["ln_dense"],
             launches_demo=demo["ln_dense"],
             **record["ln_dense"]),
        # the bf16 pre-pass of C and D: LN(x) rounded, once a row
        dict(name="ln_rows", route="cuda", source=src + "csrc/ln_mlp.cu",
             replaces=f"{jax_ops}mlp.py:99, {jax_ops}mlp.py:157",
             launches=launches["ln_rows"],
             launches_train=train_launches["ln_rows"],
             launches_served=served["launches"]["ln_rows"],
             launches_demo=demo["ln_rows"],
             **record["ln_rows"]),
        # the tail's four bf16 launches: the means, the gate, the blend, the proj GEMM
        dict(name="fused_gate_proj", route="cuda", source=src + "csrc/ln_mlp.cu",
             replaces=jax_ops + "mlp.py:272",
             launches=launches["gate_proj"], launches_means=launches["gate_means"],
             launches_alpha=launches["gate_alpha"], launches_blend=launches["gate_blend"],
             launches_train=train_launches["gate_proj"],
             launches_served=served["launches"]["gate_proj"],
             launches_demo=demo["gate_proj"],
             **record["gate_proj"]),
        # the cluster kernel in bf16; the strided one takes f32 and larger frames
        dict(name="fused_groupnorm", route="cuda", source=src + "csrc/groupnorm.cu",
             replaces=jax_ops + "groupnorm.py:83",
             launches=launches["groupnorm"], launches_strided=launches["groupnorm_strided"],
             launches_train=train_launches["groupnorm"],
             launches_served=served["launches"]["groupnorm"],
             launches_demo=demo["groupnorm"],
             launches_demo_strided=demo["groupnorm_strided"],
             **record["groupnorm"]),
        dict(name="spatial_attention", route="cuda", source=src + "csrc/st_attention.cu",
             replaces=f"{jax_ops}attention.py:47, {jax_ops}st_attention.py:96",
             launches=launches["spatial_attention"],
             launches_train=train_launches["spatial_attention"],
             launches_served=served["launches"]["spatial_attention"],
             launches_demo=demo["spatial_attention"],
             **record["spatial"]),
        dict(name="temporal_attention", route="cuda", source=src + "csrc/st_attention.cu",
             replaces=f"{jax_ops}st_attention.py:132, {jax_ops}st_attention.py:229",
             launches=launches["temporal_attention"],
             launches_train=train_launches["temporal_attention"],
             launches_served=served["launches"]["temporal_attention"],
             launches_demo=demo["temporal_attention"],
             **record["temporal"]),
        # the one kernel whose launches are those of the eval protocol's run
        dict(name="fused_attention_blocked", route="cuda", source=src + "csrc/st_attention.cu",
             replaces=jax_ops + "attention.py:74",
             launches=eval_launches["attention_blocked"],
             launches_train=train_launches["attention_blocked"],
             launches_served=served["launches"]["attention_blocked"],
             launches_demo=demo["attention_blocked"],
             # f32 (the coupling mode's f32 protocol in phase_eval; no f32 parallel path)
             f32=record["attention_blocked_f32"],
             **record["attention_blocked"]),
        # the head dims the three above do not take (csrc/attention_general.cu):
        # launches in phase_accept's run (its CLIs included) and phase_bench_train's,
        # and through the 2-head models of phase_kernels (the blocked one's path)
        dict(name="spatial_attention_general", route="cuda",
             source=src + "csrc/attention_general.cu",
             replaces=f"{jax_ops}attention.py:47, {jax_ops}st_attention.py:96",
             launches=accept["spatial_attention_general"],
             launches_bench_train=bench["spatial_attention_general"],
             launches_model=record["general_model_launches"]["spatial_attention_general"],
             **record["spatial_general"]),
        dict(name="temporal_attention_general", route="cuda",
             source=src + "csrc/attention_general.cu",
             replaces=f"{jax_ops}st_attention.py:132, {jax_ops}st_attention.py:229",
             launches=bench["temporal_attention_general"],
             launches_accept=accept["temporal_attention_general"],
             launches_model=record["general_model_launches"]["temporal_attention_general"],
             **record["temporal_general"]),
        dict(name="fused_attention_blocked_general", route="cuda",
             source=src + "csrc/attention_general.cu",
             replaces=jax_ops + "attention.py:74",
             launches=record["general_model_launches"]["attention_blocked_general"],
             launches_accept=accept["attention_blocked_general"],
             launches_bench_train=bench["attention_blocked_general"],
             **record["attention_blocked_general"]),
    ]
    # the f32 forms (the eval CLI's, the demo's and the trainer's dtype):
    # launches in phase_f32's f32 forward, an f32 train step and the demo
    f32_forms = (
        ("fast_layernorm_f32", "triton", "ops/layernorm.py", "layernorm.py:60", "layernorm",
         "layernorm_f32"),
        ("fused_ln_mlp_f32", "cuda", "csrc/ln_mlp.cu", "mlp.py:99", "ln_mlp_fc1", "ln_mlp_f32"),
        ("fused_ln_dense_f32", "cuda", "csrc/ln_mlp.cu", "mlp.py:157", "ln_dense",
         "ln_dense_f32"),
        ("ln_rows_f32", "cuda", "csrc/ln_mlp.cu", "mlp.py:99, maed_tpu/ops/mlp.py:157",
         "ln_rows", "ln_rows_f32"),
        ("fused_gate_proj_f32", "cuda", "csrc/ln_mlp.cu", "mlp.py:272", "gate_proj",
         "gate_proj_f32"),
        # E's f32 branch means and gate product (launched inside fused_gate_proj)
        ("gate_means_f32", "cuda", "csrc/ln_mlp.cu", "mlp.py:272", "gate_means",
         "gate_means_f32"),
        ("gate_alpha_f32", "cuda", "csrc/ln_mlp.cu", "mlp.py:272", "gate_alpha",
         "gate_alpha_f32"),
        ("fused_groupnorm_f32", "cuda", "csrc/groupnorm.cu", "groupnorm.py:83",
         "groupnorm_strided", "groupnorm_f32"),
        ("spatial_attention_f32", "cuda", "csrc/st_attention.cu",
         "attention.py:47, maed_tpu/ops/st_attention.py:96", "spatial_attention", "spatial_f32"),
        ("temporal_attention_f32", "cuda", "csrc/st_attention.cu",
         "st_attention.py:132, maed_tpu/ops/st_attention.py:229", "temporal_attention",
         "temporal_f32"))
    for name, route, source, replaces, count, rec in f32_forms:
        kernels_line.append(dict(
            name=name, route=route, source=src + source, replaces=jax_ops + replaces,
            launches=f32_launches[count], launches_train=train_f32_launches[count],
            launches_demo=demo[count], launches_stock_vits=surface_f32[count], **record[rec]))
    # K in f32: launches in phase_eval's f32 coupling request
    kernels_line.append(dict(
        name="fused_attention_blocked_f32", route="cuda", source=src + "csrc/st_attention.cu",
        replaces=jax_ops + "attention.py:74",
        launches=coupling_f32_launches["attention_blocked"],
        launches_train=train_f32_launches["attention_blocked"],
        launches_demo=demo["attention_blocked"], **record["attention_blocked_f32"]))
    # tensor parallelism's row-parallel epilogue (RowPartial) of C's fc2 and E's
    # proj: launches in phase_tp's split forwards and f32 step on tp rank 1
    # (rank 0 runs C's and E's epilogues)
    tp_counts = tp["launches"]
    for kind, dt in (("bf16", "bfloat16"), ("f32", "float32")):
        kernels_line.append(dict(
            name="dense_row_partial" + ("" if kind == "bf16" else "_f32"), route="cuda",
            source=src + "csrc/ln_mlp.cu", replaces=f"{jax_ops}mlp.py:99, {jax_ops}mlp.py:272",
            launches=tp_counts[f"rank1_{dt}"]["ln_mlp_fc2_partial"],
            launches_proj=tp_counts[f"rank1_{dt}"]["gate_proj_partial"],
            launches_train=(tp["step"]["rank_launches"][1]["ln_mlp_fc2_partial"]
                            if kind == "f32" else 0),
            **tp["kernels"][kind]))
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:  # a rank of phase_ddp
        sys.exit(ddp_rank(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--tp-rank"]:  # a rank of phase_tp
        sys.exit(tp_rank(Path(sys.argv[2])))
    sys.exit(main())
