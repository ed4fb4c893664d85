"""What a ``torch.profiler`` trace of the traced segment says: the device's
busy time as the union of its operations' intervals (kernels, copies and
sets), the device time by operation, the idle gaps by what the host was
doing, the device time of each phase of a train step, and the device time of
the port's own kernels.

The phase split is ``tools/profile_port.py``'s (``PHASES``, ``phase_of``
over the profiler's op tree), copied. Its busy share summed the kernels'
self times; here the busy time is the union of the intervals, so that
overlapping operations count once.
"""

from __future__ import annotations

import re
from collections import defaultdict
from pathlib import Path

import torch

WINDOW = "bench.traced"
# the phases of a train step, by the op that launched a kernel and its
# ancestors: the optimizer's step, the backward of the kernels' autograd
# Functions (the recompute through their plain versions), the rest of the
# backward, and the forward with the loss
PHASES = (("optimizer", "Optimizer.step"),
          ("recompute", "autograd::engine::evaluate_function: _Recompute"),
          ("backward", "autograd::engine::evaluate_function"))
TRITON_KERNELS = ("layernorm_kernel",)
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")


def phase_of(event) -> str:
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    for phase, prefix in PHASES:
        if any(name.startswith(prefix) for name in names):
            return phase
    return "forward"


def port_kernel_pattern(csrc: Path) -> re.Pattern:
    """A pattern that finds the name of any of the port's kernels (every
    ``__global__`` function of its CUDA sources, and its Triton kernels) in a
    device operation's name."""
    names = set(TRITON_KERNELS)
    for src in sorted(csrc.glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    alt = "|".join(sorted(map(re.escape, names)))
    return re.compile(rf"(?<![A-Za-z0-9_])(?:{alt})(?![A-Za-z0-9_])")


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(prof, port_kernels: re.Pattern, items: int) -> dict:
    """The traced segment's summary; times in seconds."""
    events = list(prof.events())
    windows = [e for e in events if e.name == WINDOW and e.device_type == CPU]
    if not windows:
        raise RuntimeError(f"the trace holds no '{WINDOW}' range")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device = [e for e in events if e.device_type == CUDA and e.name != WINDOW
              and e.time_range.end > w0 and e.time_range.start < w1]
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device]
    merged = _union(spans)
    busy_us = sum(b - a for a, b in merged)
    by_op, port_us = defaultdict(float), 0.0
    for e, (a, b) in zip(device, spans):
        by_op[e.name] += b - a
        if port_kernels.search(e.name):
            port_us += b - a
    # the longest idle gaps, each named by the innermost host op running at its middle
    cpu = [e for e in events if e.device_type == CPU and e.name != WINDOW]
    gaps, last = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > last:
            gaps.append((a - last, (a + last) / 2))
        last = max(last, b)
    idle = []
    for length, mid in sorted(gaps, reverse=True)[:10]:
        inner = [e for e in cpu if e.time_range.start <= mid <= e.time_range.end]
        name = min(inner, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inner else "host outside any op"
        idle.append([name[:160], length / 1e6])
    phases = defaultdict(float)
    for e in cpu:
        for k in e.kernels:
            phases[phase_of(e)] += k.duration
    top = lambda d: [[name[:160], us / 1e6] for name, us in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "items": items,
            "device_ops": top(by_op), "idle_gaps": idle, "port_kernel_s": port_us / 1e6,
            "phase_s": {k: v / 1e6 for k, v in phases.items()}}


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)
