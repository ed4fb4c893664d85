#!/usr/bin/env python3
"""Time variants of the skinning kernel (A) at the flagship shape.

    python3 tools/skinning_variants.py [variant ...]

Edits a copy of ``csrc/skinning.cu`` as each variant says, in a temporary
directory outside the repository, builds each copy alone with nvcc (sm_90a,
all at once) into a library of its own, and times ``maed_skinning_f32`` on
the card at (128, 6890) f32 with chip_smoke.py's inputs (device time, the
calls queued behind a sleep, median of 9 x 50), with its max abs error
against the plain version and ptxas' register line. Variants:

- ``base``: the source as it is;
- ``two``: 2 vertices a thread, not 3;
- ``four64``: 4 vertices a thread, 64 threads a CTA;
- ``no_broadcast`` (a diagnostic: wrong values): the transforms come from a
  register, not from 72 shared-memory broadcasts a frame;
- ``one_joint`` (a diagnostic: wrong values): the blend over joint 0 alone,
  so what is left is the memory traffic and the loop around it;
- ``no_memory`` (a diagnostic: wrong values): no v_posed loads and no
  stores, so what is left is the arithmetic.

Default: all of them, ``base`` first and last. Prints the card and one
``VARIANT name {json}`` line each.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_SHAPE = "constexpr int kThreads = 128, kPerThread = 3,"
_A = "const float4 ajr = a[3 * j + r];"
_X = "x_r[p][0] = __ldg(x_g), x_r[p][1] = __ldg(x_g + 1), x_r[p][2] = __ldg(x_g + 2);"
_STORE = "        o_g[r] = t[p][4 * r] * x[p][0]"
# variant -> (text, replacement) edits of csrc/skinning.cu
VARIANTS = {
    "base": [],
    "two": [(_SHAPE, "constexpr int kThreads = 128, kPerThread = 2,")],
    "four64": [(_SHAPE, "constexpr int kThreads = 64, kPerThread = 4,")],
    "no_broadcast": [(_A, "const float4 ajr = make_float4(a[0].x + j, a[0].y + r, a[0].z, "
                          "a[0].w);")],
    "one_joint": [("for (int j = 0; j < kJoints; ++j) {  // the blend: T = sum_j w_j A_j[:3]",
                   "for (int j = 0; j < 1; ++j) {")],
    "no_memory": [(_X, "x_r[p][0] = 0.5f * v, x_r[p][1] = f, x_r[p][2] = 0.25f;"),
                  (_STORE, "        if (t[p][0] == 12345.f) o_g[r] = t[p][4 * r] * x[p][0]")],
}


def nvcc() -> str:
    return shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                       / "bin" / "nvcc")


def inputs(device):
    """chip_smoke.py's skinning inputs: rigid transforms, weights normalized per vertex."""
    import numpy as np
    import torch

    rng = np.random.RandomState(0)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, torch.float32)  # noqa: E731
    v_posed = T(rng.randn(128, 6890, 3) * 0.3)
    W = rng.rand(6890, 24) ** 4
    W = T(W / W.sum(axis=1, keepdims=True))
    rot, _ = np.linalg.qr(rng.randn(128 * 24, 3, 3))
    A = np.zeros((128 * 24, 4, 4))
    A[:, :3, :3], A[:, :3, 3], A[:, 3, 3] = rot, rng.randn(128 * 24, 3) * 0.3, 1.0
    return v_posed, W, T(A.reshape(128, 24, 4, 4))


def device_ms(fn, iters=50):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(9):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from maed_tpu_torch.ops.skinning import skinning_reference

    names = sys.argv[1:] or ["base", *(v for v in VARIANTS if v != "base"), "base"]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("skinning_variants: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    csrc = ROOT / "maed_tpu_torch" / "csrc"
    device = torch.device("cuda")
    args = inputs(device)
    want = skinning_reference(*args)
    out = torch.empty_like(want)
    failed = 0
    with tempfile.TemporaryDirectory(prefix="skinning_variants_") as dest:
        shutil.copy(csrc / "hopper.cuh", Path(dest) / "hopper.cuh")
        procs = {}
        for name in dict.fromkeys(names):
            text = (csrc / "skinning.cu").read_text()
            for old, new in VARIANTS[name]:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name}: expected once in skinning.cu: {old!r}")
                text = text.replace(old, new)
            (Path(dest) / f"{name}.cu").write_text(text)
            procs[name] = subprocess.Popen(
                [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-o", f"{dest}/{name}.so",
                 f"{dest}/{name}.cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs = {name: proc.communicate()[0] for name, proc in procs.items()}
        for name in names:
            if procs[name].returncode:
                print(f"variant {name} failed to build:\n{logs[name][-2000:]}")
                failed = 1
                continue
            fn = ctypes.CDLL(f"{dest}/{name}.so").maed_skinning_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [t.data_ptr() for t in (*args, out)]

            def call():
                if fn(*ptrs, 128, 6890, stream):
                    raise RuntimeError(f"variant {name}: launch failed")

            call()
            torch.cuda.synchronize()
            regs = [line.split(":", 1)[1].strip() for line in logs[name].splitlines()
                    if "registers" in line]
            record = dict(device_ms=device_ms(call), max_abs_err=(out - want).abs().max().item(),
                          ptxas=regs[-1] if regs else "")
            print(f"VARIANT {name} {json.dumps(record)}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
