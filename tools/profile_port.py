"""Where the time of the port's flagship eval request goes on an NVIDIA GPU.

Answers chip_smoke.py's bf16 requests (the released stage-2 MAED through
``build_eval_model``, seeded random weights, synthetic 6890-vertex SMPL,
8 clips x 16 frames x 224^2 uint8 with a J14 regressor) and traces them with
``torch.profiler``: device time by kernel and by kind of kernel, and the
device's busy share of the traced window. ``--st-mode coupling`` (or another
attention mode) traces that model on the same requests instead: a request is
then one sub-clip forward of the eval protocol.

``--train`` traces the stage-2 train step instead (chip_smoke.py's
``phase_train`` set-up: ``build_train_model`` at full width, 3 + 4 clips of
16 frames and 7 images at 224^2, uint8, self-consistent targets), 3 steps in
f32 and 3 in bf16: ms a step, peak memory, the busy share, and device ms by
phase (the forward, the backward's recompute through the kernels' plain
versions, the rest of the backward, the optimizer) and by kind within each.
Imports nothing of JAX.

Usage: python tools/profile_port.py [--st-mode parallel] [--train] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (pins one card before torch starts)
import torch  # noqa: E402

# kind of kernel, by a piece of its name; first match wins. C's, D's and E's
# GEMM launches are told apart by their epilogue tag: BiasOnly is D,
# ProjResidual (bf16) and the f32 GEMM's GateBlend prologue E, BiasGelu and
# BiasResidual C. E's means, gate and blend kernels go with its GEMM (and an
# older tree's gate_alpha_kernel and wmma gate_proj_bf16_kernel). The LN
# pre-pass of C and D has a row of its own (C's launches of it are as many as
# D's on every path that runs D: 12 a forward, half of them C's).
KINDS = (
    ("ln pre-pass (kernels C, D)", ("ln_rows_kernel",)),
    ("ln_dense (kernel D)", ("biasonly",)),
    ("gate_proj (kernel E)", ("projresidual", "gateblend", "gate_means_kernel", "gate_alpha_",
                              "gate_blend_kernel", "gate_proj_bf16_kernel")),
    ("ln_mlp (kernel C)", ("biasgelu", "biasresidual")),
    ("groupnorm (kernel I)", ("groupnorm_cluster_kernel", "groupnorm_kernel")),
    ("blocked attention (kernel K)", ("blocked_attention",)),
    ("spatial attention (kernels F, J)", ("spatial_attention",)),
    ("temporal attention (kernels G, H)", ("temporal_attention",)),
    ("layernorm (kernel B)", ("layernorm_kernel",)),
    ("skinning (kernel A)", ("skinning",)),
    # cuDNN's convs (forward, data and weight gradients); an "xmma_gemm" with
    # none of these marks is a cuBLAS product
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "cublas", "nvjet", "sm90_", "ampere_")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("copy / cat / index", ("copy", "cat", "index", "gather", "scatter", "transpose")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
# kinds whose kernels are listed one by one, beside the top kernels
LISTED = ("gate_proj (kernel E)", "groupnorm (kernel I)", "elementwise")


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


# the phases of a train step, by the profiler's op that launched a kernel
# and its ancestors: the optimizer's step, the backward of the kernels'
# autograd Functions (the recompute through their plain versions and its
# gradient), the rest of the backward, and the forward (with the loss)
PHASES = (("optimizer", "Optimizer.step"),
          ("backward: the Functions' recompute", "autograd::engine::evaluate_function: _Recompute"),
          ("backward: the rest", "autograd::engine::evaluate_function"))


def phase_of(event) -> str:
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    for phase, prefix in PHASES:
        if any(name.startswith(prefix) for name in names):
            return phase
    return "forward"


def profile_train(device, dtype, steps=3) -> None:
    """``steps`` stage-2 train steps of the full-width model in ``dtype``,
    timed, then traced."""
    from maed_tpu_torch.core.builder import build_train_model
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    label = "f32" if dtype == torch.float32 else "bf16"
    model, smpl = build_train_model(dtype=dtype, device=device, seed=0, allow_synthetic_smpl=True)
    batch = chip_smoke.make_train_batch(smpl, device)
    optimizer = make_optimizer(chip_smoke.TrainRecipe, 500, model.parameters())
    step = make_train_step(model, optimizer, smpl, LossWeights(),
                           torch.Generator(device=device).manual_seed(7))

    def run():
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()

    step(*batch)  # warmup: Triton compiles here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        window_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / steps
    print(f"train {label}: {step_ms:.1f} ms a step (host clock, mean of {steps}, no profiler), "
          f"peak memory {peak / 2 ** 30:.2f} GiB; profiled {window_ms:.1f} ms a step, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / window_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / window_ms):.1f}%")
    by = defaultdict(float)          # (phase, kind) -> ms a step
    rows = defaultdict(lambda: [0.0, 0])  # (phase, kernel) -> ms a step, launches a step
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CPU or not event.kernels:
            continue
        phase = phase_of(event)
        for kernel in event.kernels:
            ms = kernel.duration / 1e3 / steps
            by[phase, kind_of(kernel.name)] += ms
            rows[phase, kernel.name][0] += ms
            rows[phase, kernel.name][1] += 1
    if busy_ms == 0:
        print("the profiler recorded no device time")
        return
    attributed = sum(by.values())
    print(f"  device ms a step by phase ({attributed:.1f} of {busy_ms:.1f} ms attributed to the "
          "op that launched them):")
    for phase in ["forward"] + [p for p, _ in PHASES]:
        total = sum(ms for (ph, _), ms in by.items() if ph == phase)
        print(f"  {total:9.2f} ms  {100 * total / busy_ms:5.1f}%  {phase}")
        for (ph, kind), ms in sorted(by.items(), key=lambda kv: -kv[1]):
            if ph == phase and ms >= 0.05:
                print(f"      {ms:9.2f} ms  {kind}")
    for phase in [p for p, _ in PHASES[1:]]:
        print(f"  the largest rows of {phase} (ms a step, launches a step):")
        top = sorted(((v[0], v[1] / steps, name) for (ph, name), v in rows.items()
                      if ph == phase), reverse=True)
        for ms, count, name in top[:12]:
            print(f"      {ms:9.3f} ms  x{count:<5.0f} {name[:110]}")
    del model, optimizer, step
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--st-mode", default="parallel", help="the model's attention mode")
    ap.add_argument("--train", action="store_true", help="trace the stage-2 train step")
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    if args.train:
        print(chip_smoke.card_identity())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        for dtype in (torch.float32, torch.bfloat16):
            profile_train(torch.device("cuda", 0), dtype)
        return 0

    print(chip_smoke.card_identity())
    device = torch.device("cuda", 0)
    model, smpl = chip_smoke.build_flagship(device, torch.bfloat16, st_mode=args.st_mode)
    clips, jreg = chip_smoke.make_requests(device)
    n = len(clips)

    def answer_all():
        for clip in clips:
            model(clip, smpl, J_regressor=jreg)
        torch.cuda.synchronize()

    answer_all()  # warmup
    t0 = time.perf_counter()
    answer_all()
    request_ms = (time.perf_counter() - t0) * 1e3 / n
    print(f"bf16 {args.st_mode} request, no profiler: {request_ms:.2f} ms (host clock, mean of {n})")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        answer_all()
        window_ms = (time.perf_counter() - t0) * 1e3

    # kernel rows only: the operator rows above them repeat their device time
    rows = [(ev.self_device_time_total / 1e3 / n, ev.count // n, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    per_request = window_ms / n
    print(f"profiled window: {per_request:.2f} ms per request; device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / per_request:.1f}%), idle "
          f"{100 * (1 - busy_ms / per_request):.1f}%")
    if not rows:
        print("the profiler recorded no device time")
        return 1
    by_kind = defaultdict(float)
    for ms, _, name in rows:
        by_kind[kind_of(name)] += ms
    print("device ms per request by kind:")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  {kind}")
    print("top kernels (device ms per request, launches per request):")
    for ms, count, name in rows[:25]:
        print(f"  {ms:9.3f} ms  x{count:<4d} {name[:110]}")
    for kind in LISTED:
        print(f"{kind}, every kernel (device ms per request, launches per request):")
        for ms, count, name in rows:
            if kind_of(name) == kind:
                print(f"  {ms:9.3f} ms  x{count:<4d} {name[:160]}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
        print(f"chrome trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
