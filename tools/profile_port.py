"""Where the time of the port's flagship eval request goes on an NVIDIA GPU.

Answers chip_smoke.py's bf16 requests (the released stage-2 MAED through
``build_eval_model``, seeded random weights, synthetic 6890-vertex SMPL,
8 clips x 16 frames x 224^2 uint8 with a J14 regressor) and traces them with
``torch.profiler``: device time by kernel and by kind of kernel, and the
device's busy share of the traced window. ``--st-mode coupling`` (or another
attention mode) traces that model on the same requests instead: a request is
then one sub-clip forward of the eval protocol. Imports nothing of JAX.

Usage: python tools/profile_port.py [--st-mode parallel] [--trace profile_port_trace.json]
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
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "winograd", "fprop")),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--st-mode", default="parallel", help="the model's attention mode")
    ap.add_argument("--trace", default="", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: needs a CUDA device", file=sys.stderr)
        return 1

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
