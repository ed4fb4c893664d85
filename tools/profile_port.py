"""Where the time of the port's flagship eval request goes on an NVIDIA GPU.

Answers chip_smoke.py's bf16 requests (the released stage-2 MAED through
``build_eval_model``, seeded random weights, synthetic 6890-vertex SMPL,
8 clips x 16 frames x 224^2 uint8 with a J14 regressor) and traces them with
``torch.profiler``: device time by kernel and by kind of kernel, and the
device's busy share of the traced window. ``--st-mode coupling`` (or another
attention mode) traces that model on the same requests instead: a request is
then one sub-clip forward of the eval protocol. ``--dtype f32`` traces the
model in f32 with TF32 off, the eval forward as ``eval.py``, the demo and the
trainer's validation run it, and then times the eval protocol's window
batches (``Evaluator.run`` over chip_smoke.py's 13 windows of 128 frames:
the host clock from one window batch asked of the loader to the next).

``--general`` traces the attention kernels of csrc/attention_general.cu
instead, at chip_smoke.py's timed shapes (GENERAL_TIMED head dims at the
flagship's tokens), each call beside scaled_dot_product_attention on the same
inputs: device time by kernel, the rates it reaches against the card's peaks,
and its device time per work item on an SM.

``--train`` traces the stage-2 train step instead (chip_smoke.py's
``phase_train`` set-up: ``build_train_model`` at full width, 3 + 4 clips of
16 frames and 7 images at 224^2, uint8, self-consistent targets), 3 steps in
f32 and 3 in bf16: ms a step, peak memory, the busy share, and device ms by
phase (the forward, the backward's recompute through the kernels' plain
versions, the rest of the backward, the optimizer) and by kind within each.
Imports nothing of JAX.

Usage: python tools/profile_port.py [--st-mode parallel] [--dtype bf16|f32] [--train] [--general]
       [--trace trace.json]
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
# ProjResidual (and an older tree's f32 GateBlend prologue) E, BiasGelu and
# BiasResidual C. E's means, gate and blend kernels go with its GEMM (and an
# older tree's gate_alpha_kernel and wmma gate_proj_bf16_kernel). The LN
# pre-pass of C and D has a row of its own (C's launches of it are as many as
# D's on every path that runs D: 12 a forward, half of them C's).
KINDS = (
    ("general attention (F/J, G/H, K at other head dims)", ("general_",)),
    ("ln pre-pass (kernels C, D)", ("ln_rows_",)),
    ("ln_dense (kernel D)", ("biasonly",)),
    ("gate_proj (kernel E)", ("projresidual", "gateblend", "gate_means_", "gate_alpha_",
                              "gate_blend_", "gate_proj_bf16_kernel")),
    ("ln_mlp (kernel C)", ("biasgelu", "biasresidual")),
    ("groupnorm (kernel I)", ("groupnorm_cluster_kernel", "groupnorm_kernel")),
    ("blocked attention (kernel K)", ("blocked_attention", "blocked_f32")),
    ("spatial attention (kernels F, J)", ("spatial_attention", "spatial_f32")),
    ("temporal attention (kernels G, H)", ("temporal_attention", "temporal_f32")),
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


def device_us(fn, calls=3, tries=3) -> dict:
    """Device us a call of fn() by kernel name, from a torch.profiler trace
    of ``calls`` calls after a warmup; a trace that records no device time
    (CUPTI now and then delivers none) is taken again, up to ``tries``."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = {ev.key: ev.self_device_time_total / calls for ev in prof.key_averages()
                if ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0}
        if rows:
            return rows
    return {}


def profile_general(device) -> None:
    """The general attention kernels at GENERAL_TIMED's head dims and the
    flagship's tokens (128 frames x 197 tokens, 768 / d heads, d 80 in 16;
    blocked: 8 clips x 3152 tokens), f32 and bf16, where the dispatch takes
    them: each call's kernels and scaled_dot_product_attention's on the same
    inputs, device us a call; the call's operations (4 S^2 d a head) over the
    kernel's time against the dtype's peak, its bytes (q, k and v read once,
    the output written once) against HBM's rate; and its work items (the
    plan's: a warp's (frames), 128 or 64 query rows (rows, bf16 or f32), the
    plan's rows of a part (tiled)) with the kernel's time per item on an SM."""
    import numpy as np
    import torch.nn.functional as F

    from maed_tpu_torch.ops import attention, st_attention

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.RandomState(3)
    frames, N = chip_smoke.N_CLIPS * chip_smoke.SEQLEN, 197
    S_clip = chip_smoke.SEQLEN * N
    for d in chip_smoke.GENERAL_TIMED:
        heads, att = chip_smoke.general_heads(d), d ** -0.5
        qkv_np = rng.randn(frames, N, 3, heads, d)
        for dt, kind in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            is_bf16 = int(dt == torch.bfloat16)
            qkv = torch.from_numpy(qkv_np).to(device, dt)
            q4, k4, v4 = (a.transpose(1, 2) for a in qkv.unbind(2))
            q5, k5, v5 = (a.reshape(chip_smoke.N_CLIPS, chip_smoke.SEQLEN, N, heads, d)
                          .permute(0, 2, 3, 1, 4) for a in qkv.unbind(2))
            qb, kb, vb = (a.transpose(1, 2)
                          for a in qkv.view(chip_smoke.N_CLIPS, S_clip, 3, heads, d).unbind(2))
            forms = (  # name, S, batch items, online, kernel call, library call
                ("spatial", N, frames * heads, False,
                 lambda: st_attention.spatial_attention_btc(qkv, att),
                 lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=att)),
                ("temporal", chip_smoke.SEQLEN, chip_smoke.N_CLIPS * N * heads, False,
                 lambda: st_attention.temporal_attention_fused(qkv, chip_smoke.SEQLEN, att),
                 lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=att)),
                ("blocked", S_clip, chip_smoke.N_CLIPS * heads, True,
                 lambda: attention.fused_attention(qb, kb, vb, att),
                 lambda: F.scaled_dot_product_attention(qb, kb, vb, scale=att)))
            for name, S, batch, online, kernel, library in forms:
                if not st_attention.general_head_dim(d, is_bf16, temporal=name == "temporal"):
                    continue
                plan = st_attention.general_plan(S, d, is_bf16, online)
                if plan.kind == st_attention.FRAMES:
                    items = batch
                elif plan.kind == st_attention.ROWS:
                    items = batch * -(-S // (128 if is_bf16 else 64))
                else:
                    items = batch * -(-S // plan.width) * plan.parts
                flops = 4.0 * batch * S * S * d
                moved = 4 * batch * S * d * qkv.element_size()
                ours = device_us(kernel)
                lib = device_us(library)
                if not ours or not lib:
                    print(f"{name} d {d} {kind}: the profiler recorded no device time")
                    continue
                us = sum(ours.values())
                print(f"{name} d {d} {kind} ({heads} heads, S {S}, {plan}): kernel {us:.1f} us, "
                      f"{flops / us / 1e6:.1f} TFLOP/s "
                      f"({100 * flops / us / 1e6 / (chip_smoke.PEAK_FLOPS[kind] / 1e12):.1f}% of "
                      f"peak), {moved / us / 1e3:.0f} GB/s "
                      f"({100 * moved / us / 1e6 / (chip_smoke.HBM_BYTES_PER_S / 1e12):.1f}% of "
                      f"HBM); {items} items, {us * sms / items:.2f} us an item on an SM; "
                      f"scaled_dot_product_attention {sum(lib.values()):.1f} us")
                for key, t in sorted(ours.items(), key=lambda kv: -kv[1]):
                    print(f"    {t:9.1f} us  {key[:140]}")
                for key, t in sorted(lib.items(), key=lambda kv: -kv[1])[:3]:
                    print(f"    {t:9.1f} us  (library) {key[:130]}")
            del qkv, q4, k4, v4, q5, k5, v5, qb, kb, vb
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--st-mode", default="parallel", help="the model's attention mode")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                    help="the model's dtype (f32: TF32 off, then the eval protocol's window "
                         "batches)")
    ap.add_argument("--train", action="store_true", help="trace the stage-2 train step")
    ap.add_argument("--general", action="store_true",
                    help="trace the general attention kernels against the library's")
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1
    if args.general:
        print(chip_smoke.card_identity())
        profile_general(torch.device("cuda", 0))
        return 0
    if args.train:
        print(chip_smoke.card_identity())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        for dtype in (torch.float32, torch.bfloat16):
            profile_train(torch.device("cuda", 0), dtype)
        return 0

    print(chip_smoke.card_identity())
    device = torch.device("cuda", 0)
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model, smpl = chip_smoke.build_flagship(device, dtype, st_mode=args.st_mode)
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
    print(f"{args.dtype} {args.st_mode} request, no profiler: {request_ms:.2f} ms (host clock, "
          f"mean of {n})")

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
    if dtype == torch.float32:
        time_windows(model, smpl, device, args.st_mode)
    return 0


def time_windows(model, smpl, device, st_mode) -> None:
    """The eval protocol over chip_smoke.py's windows with ``model``: the
    host clock between the loader's window batches (the first batch's
    includes the evaluator's set-up)."""
    from maed_tpu_torch.core.evaluate import Evaluator

    batches, jreg = chip_smoke.make_windows(smpl, device)
    stamps = []
    t0 = time.perf_counter()
    Evaluator(smpl).run(lambda images, J_regressor: model(images, smpl, J_regressor=J_regressor),
                        chip_smoke.stamped(batches, stamps), seqlen=chip_smoke.SEQLEN, interp=1,
                        dataset_name="3dpw", J_regressor=jreg,
                        batch_size=chip_smoke.EVAL_BATCHES[0], verbose=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    forwards = len(batches) * (chip_smoke.POOL // chip_smoke.SEQLEN)
    print(f"f32 {st_mode} eval protocol ({sum(chip_smoke.EVAL_BATCHES)} windows x "
          f"{chip_smoke.POOL} frames, {forwards} sub-clip forwards): window batch s "
          + ", ".join(f"{b - a:.3f}" for a, b in zip(stamps, stamps[1:]))
          + f"; the whole run {total:.3f} s")


if __name__ == "__main__":
    sys.exit(main())
