#!/usr/bin/env python3
"""Smoke run of the PyTorch port (maed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from maed_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship eval forward gives it, and times both.
3. Drives the eval forward the way a user would: ``build_eval_model`` for
   the released stage-2 MAED (6 blocks, 12 heads, KTD hidden 1024) in bf16
   with seeded random weights and the synthetic 6890-vertex SMPL body, then
   answers 3 requests of 8 clips x 16 frames x 224^2 uint8 with a (14, 6890)
   J14 regressor. The launch counts must show that every kernel ran.
4. Runs one f32 forward with the kernels and one with their plain versions,
   which must agree, and holds the bf16 answers to the f32 ones: through
   the kernels they may lie at most BF16_RATIO times as far from them as
   through the plain versions.

Any failed check raises. On success the last two lines are the kernels'
record and {"ok": true, "device": {...}}. Needs a CUDA card (and exits
non-zero without one) and the repository around this file. It drives one
card, the first visible one, and hides the others from itself.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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
# kernel launches per forward at depth 6: norm1 x 6 + the final norm; the
# MLP x 6, each call two launches; SMPL's skinning once
PER_FORWARD = {"layernorm": 7, "ln_mlp_fc1": 6, "ln_mlp_fc2": 6, "skinning": 1}
# The bf16 flagship's answers through the kernels may lie at most this many
# times as far from the f32 answer (max abs over the requests, verts and
# kp_3d) as its answers through the plain versions do. Both bf16 paths round
# at the same points but accumulate in another order, and the random
# weights' 6D-to-rotation step turns the difference into whole rotations,
# so an absolute bound cannot hold across seeds; the ratio does. Readings
# over weight seeds 0-4 came to at most 1.03 (verts) and 1.24 (kp_3d): PERF.md.
BF16_RATIO = 1.5


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after a warmup."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


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


def phase_kernels(device):
    """Each kernel against its plain version at the flagship shapes."""
    from maed_tpu_torch.ops import layernorm, mlp, skinning

    rng = np.random.RandomState(0)
    T = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    B, M, C, H = N_CLIPS * SEQLEN, N_CLIPS * SEQLEN * 197, 768, 3072
    record = {}

    # A: skinning, f32. Rigid joint transforms, weights normalized per vertex.
    v_posed = T(rng.randn(B, NUM_VERTS, 3) * 0.3)
    W = rng.rand(NUM_VERTS, 24) ** 4
    W = T(W / W.sum(axis=1, keepdims=True))
    q, _ = np.linalg.qr(rng.randn(B * 24, 3, 3))
    A = np.zeros((B * 24, 4, 4))
    A[:, :3, :3], A[:, :3, 3], A[:, 3, 3] = q, rng.randn(B * 24, 3) * 0.3, 1.0
    A = T(A.reshape(B, 24, 4, 4))
    args = (v_posed, W, A)
    print(f"kernel A skinning: v_posed {tuple(v_posed.shape)} f32")
    err = check_close("skinning f32", skinning.skinning(*args),
                      skinning.skinning_reference(*args), 1e-5)
    record["skinning"] = dict(
        max_abs_err=err, ms=time_ms(lambda: skinning.skinning(*args), 50),
        plain_ms=time_ms(lambda: skinning.skinning_reference(*args), 20))

    # B: layernorm, bf16 (the serving dtype) and f32.
    x = rng.randn(M, C) * 2 + 0.5
    scale, bias = T(rng.rand(C) + 0.5), T(rng.randn(C) * 0.1)
    print(f"kernel B layernorm: x {(M, C)}")
    for dt, atol, rtol in ((torch.float32, 1e-5, 0.0), (torch.bfloat16, 2e-2, 1e-2)):
        xd = T(x, dt)
        err = check_close(f"layernorm {dt}", layernorm.fast_layernorm(xd, scale, bias, 1e-6),
                          layernorm.layernorm_reference(xd, scale, bias, 1e-6), atol, rtol)
        if dt == torch.bfloat16:
            record["layernorm"] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: layernorm.fast_layernorm(xd, scale, bias, 1e-6), 50),
                plain_ms=time_ms(lambda: layernorm.layernorm_reference(xd, scale, bias, 1e-6), 20))

    # C: LN + MLP, bf16 and f32. Weights as nn.Linear stores them.
    x = rng.randn(M, C)
    w1, w2 = rng.randn(H, C) / np.sqrt(C), rng.randn(C, H) / np.sqrt(H)
    b1, b2 = T(rng.randn(H) * 0.1), T(rng.randn(C) * 0.1)
    print(f"kernel C ln_mlp: x {(M, C)}, H {H}")
    for dt, atol, rtol in ((torch.float32, 1e-4, 0.0), (torch.bfloat16, 5e-2, 2e-2)):
        margs = (T(x, dt), scale, bias, T(w1, dt), b1, T(w2, dt), b2, 1e-6)
        err = check_close(f"ln_mlp {dt}", mlp.fused_ln_mlp(*margs),
                          mlp.ln_mlp_reference(*margs), atol, rtol)
        ms = time_ms(lambda: mlp.fused_ln_mlp(*margs), 10)
        plain_ms = time_ms(lambda: mlp.ln_mlp_reference(*margs), 5)
        print(f"  ln_mlp {dt}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if dt == torch.bfloat16:
            record["ln_mlp"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    torch.cuda.synchronize()
    return record


def make_requests(device):
    rng = np.random.RandomState(1)
    clips = [torch.from_numpy(rng.randint(0, 256, (N_CLIPS, SEQLEN, IMG, IMG, 3),
                                          dtype=np.uint8)).to(device)
             for _ in range(REQUESTS)]
    jreg = rng.rand(14, NUM_VERTS)
    jreg = torch.from_numpy(jreg / jreg.sum(axis=1, keepdims=True)).to(device, torch.float32)
    return clips, jreg


def check_outputs(out):
    want = {"theta": (N_CLIPS, SEQLEN, 85), "verts": (N_CLIPS, SEQLEN, NUM_VERTS, 3),
            "kp_2d": (N_CLIPS, SEQLEN, 14, 2), "kp_3d": (N_CLIPS, SEQLEN, 14, 3),
            "rotmat": (N_CLIPS, SEQLEN, 24, 3, 3)}
    for key, shape in want.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)}, want {shape}")
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key}: non-finite values")


def build_flagship(device, dtype, seed=0):
    """The released stage-2 MAED through the port's entry point, with
    seeded random weights and the synthetic 6890-vertex body."""
    from maed_tpu_torch.core.builder import build_eval_model

    return build_eval_model(dtype=dtype, device=device, seed=seed, allow_synthetic_smpl=True)


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
    for name, per in PER_FORWARD.items():
        if launches[name] != per * REQUESTS:
            raise AssertionError(f"{name}: {launches[name]} launches, want "
                                 f"{per} per forward x {REQUESTS}")
    plains = [model(clip, smpl, J_regressor=jreg, plain=True) for clip in clips]
    print(f"bf16 forward, kernels vs plain over {REQUESTS} requests (no bound here; "
          "see the f32 phase): " + ", ".join(
              f"{k} {err:.3e}" for k, err in worst_err(outs, plains).items()))
    del model
    return launches, outs, plains


def phase_f32(device, clips, jreg, bf16_outs, bf16_plains):
    """One f32 forward through the kernels and one through their plain
    versions, TF32 off for both, which must agree. Then the bf16 answers
    through the kernels must lie about as close to the f32 plain answers as
    the bf16 answers through the plain versions do (BF16_RATIO)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, smpl = build_flagship(device, torch.float32)
    t0 = time.perf_counter()
    got = model(clips[0], smpl, J_regressor=jreg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    wants = [model(clip, smpl, J_regressor=jreg, plain=True) for clip in clips]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"f32 forward: kernels {(t1 - t0) * 1e3:.1f} ms, plain {(t2 - t1) * 1e3:.1f} ms "
          f"for {len(clips)} (first calls, host clock)")
    check_outputs(got)
    for key, atol in (("verts", 1e-4), ("kp_3d", 1e-4), ("theta", 1e-3)):
        check_close(f"f32 forward {key}, kernels vs plain", got[key], wants[0][key], atol)

    kern, plain = worst_err(bf16_outs, wants), worst_err(bf16_plains, wants)
    for key in ("verts", "kp_3d"):
        print(f"  bf16 {key} vs f32 plain: through the kernels {kern[key]:.3e}, through "
              f"the plain versions {plain[key]:.3e}, ratio {kern[key] / plain[key]:.3f} "
              f"(bound {BF16_RATIO})")
        if not kern[key] <= BF16_RATIO * plain[key]:
            raise AssertionError(f"bf16 {key}: the kernels' answer is {kern[key]:.3e} from "
                                 f"the f32 answer, beyond {BF16_RATIO} x {plain[key]:.3e}")
    print(f"  bf16 theta vs f32 plain (no bound: whole rotations): kernels "
          f"{kern['theta']:.3e}, plain {plain['theta']:.3e}")


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

    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    record = phase_kernels(device)
    clips, jreg = make_requests(device)
    launches, outs, plains = phase_serve(device, clips, jreg)
    phase_f32(device, clips, jreg, outs, plains)

    src = "maed_tpu_torch/"
    kernels_line = [
        dict(name="skinning", route="cuda", source=src + "csrc/skinning.cu",
             replaces="maed_tpu/ops/smpl_pallas.py:30",
             launches=launches["skinning"], **record["skinning"]),
        dict(name="fast_layernorm", route="triton", source=src + "ops/layernorm.py",
             replaces="maed_tpu/ops/layernorm.py:60",
             launches=launches["layernorm"], **record["layernorm"]),
        dict(name="fused_ln_mlp", route="cuda", source=src + "csrc/ln_mlp.cu",
             replaces="maed_tpu/ops/mlp.py:99",
             launches=launches["ln_mlp_fc1"], launches_fc2=launches["ln_mlp_fc2"],
             **record["ln_mlp"]),
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
