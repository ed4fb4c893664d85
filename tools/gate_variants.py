#!/usr/bin/env python3
"""Time variants of E's f32 gate product and branch means (csrc/ln_mlp.cu).

    python3 tools/gate_variants.py [--parent DIR] [variant ...]

Copies ``csrc/ln_mlp.cu`` and its headers into a temporary directory outside
the repository once per variant, edits them as the variant says, builds each
copy alone into a shared library (all at once, one ``nvcc`` each) and calls
its ``maed_gate_alpha`` and ``maed_gate_means`` on the card: each output
against an f64 answer at every shape (BT 1, 7, 16, 128, 129 at the stock
widths), and the device time (the calls queued behind a sleep, median of 7 x
20) of one clip's gate (BT 16 at C 768, 1024, 1280), the flagship's (BT 128,
C 768) and the means at (BT, N, C) = (128, 197, 768), (16, 577, 1024) and
(16, 197, 1280), beside ``torch.addmm`` for the gate. The variants are timed
in order and then in reverse. Variants:

- ``base``: the sources as they are;
- ``noskip``: every warp of the gate multiplies, also one whose frames all
  lie past BT;
- ``ctas3``: three CTAs an SM (and as many more splits) at tiles of 32
  frames;
- ``bk64``: k-steps of 64 through a ring of 2 stages.

``--parent DIR``: also a tree's ``maed_tpu_torch/csrc`` as it is (``parent``).
Default: all four. Prints the card, the worst error and a table, and writes
``chiprun_out/gate_variants.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("ln_mlp.cu", "f32_layout.cuh", "hopper.cuh")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler",
         "-fPIC", "-shared")
# variant -> {source: [(text, replacement), ...]}
VARIANTS = {
    "base": {},
    "noskip": {"ln_mlp.cu": [("    if (!live) continue;\n", "")]},
    "ctas3": {"ln_mlp.cu": [("__launch_bounds__(kGaThreads, 2) gate_alpha_f32_kernel",
                             "__launch_bounds__(kGaThreads, TM == 1 ? 3 : 2) "
                             "gate_alpha_f32_kernel")],
              "f32_layout.cuh": [("int splits = 2 * sms / tiles;",
                                  "int splits = (p.tm == 1 ? 3 : 2) * sms / tiles;")]},
    "bk64": {"f32_layout.cuh": [("kGaBK = 32", "kGaBK = 64"), ("kGaStages = 4;", "kGaStages = 2;")]},
}
CHECKED = ((1, 100), (7, 1024), (16, 768), (16, 1024), (16, 1280), (128, 768), (129, 1280))
TIMED = ((16, 768), (16, 1024), (16, 1280), (128, 768))
MEANS = ((128, 197, 768), (16, 577, 1024), (16, 197, 1280), (7, 197, 100))


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str, src: Path, edits: dict, work: Path):
    """The variant's sources under work/name, built into lib.so."""
    d = work / name
    d.mkdir()
    for f in SOURCES:
        text = (src / f).read_text()
        for old, new in edits.get(f, []):
            if old not in text:
                raise SystemExit(f"{name}: {f} has no {old!r}")
            text = text.replace(old, new)
        (d / f).write_text(text)
    r = subprocess.run([nvcc(), *FLAGS, "-o", str(d / "lib.so"), str(d / "ln_mlp.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.maed_gate_alpha.argtypes = [I, P, P, P, P, I, I, P]
    lib.maed_gate_means.argtypes = [I, P, P, P, I, I, I, P]
    return lib


def device_ms(fn, iters=20):
    import torch

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


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="a tree whose csrc is timed as it is")
    ap.add_argument("variants", nargs="*", help=", ".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants or list(VARIANTS)
    if set(names) - set(VARIANTS):
        ap.error(f"variants are {', '.join(VARIANTS)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    jobs = {name: (ROOT / "maed_tpu_torch/csrc", VARIANTS[name]) for name in names}
    if args.parent:
        jobs = {"parent": (args.parent / "maed_tpu_torch/csrc", {}), **jobs}
    with tempfile.TemporaryDirectory(prefix="gate_variants_") as tmp:
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {n: pool.submit(build, n, s, e, Path(tmp)) for n, (s, e) in jobs.items()}
            libs = {n: f.result() for n, f in futures.items()}
        dev = torch.device("cuda")
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rng = np.random.RandomState(0)
        T = lambda a: torch.from_numpy(a).to(dev, torch.float32)  # noqa: E731
        gates, means = {}, {}
        for bt, c in CHECKED:
            m, b = T(rng.randn(bt, 2 * c)), T(rng.randn(2 * c) * 0.1)
            w = T(rng.randn(2 * c, 2 * c) / np.sqrt(2 * c))
            want = torch.softmax((m.double() @ w.double().T + b.double()).view(bt, c, 2), -1)
            gates[bt, c] = (m, w, b, torch.empty(bt, c, 2, device=dev), want)
        for bt, n, c in MEANS:
            ys, yt = T(rng.randn(bt, n, c)), T(rng.randn(bt, n, c))
            want = torch.cat([ys.double().mean(1), yt.double().mean(1)], 1)
            means[bt, n, c] = (ys, yt, torch.empty(bt, 2 * c, device=dev), want)

        def gate(lib, case):
            m, w, b, out, _ = case
            return lambda: lib.maed_gate_alpha(0, m.data_ptr(), w.data_ptr(), b.data_ptr(),
                                               out.data_ptr(), m.shape[0], out.shape[1], stream)

        def mean(lib, case):
            ys, yt, out, _ = case
            return lambda: lib.maed_gate_means(0, ys.data_ptr(), yt.data_ptr(), out.data_ptr(),
                                               *ys.shape, stream)

        errs = {}
        for name, lib in libs.items():
            for cases, call, what, got in ((gates, gate, "alpha", 3), (means, mean, "means", 2)):
                for key, case in cases.items():
                    if call(lib, case)():
                        raise SystemExit(f"{name} {what} {key}: launch failed")
                    torch.cuda.synchronize()
                    errs[f"{name} {what} {key}"] = (case[got].double() - case[-1]).abs().max().item()
        worst = max(errs, key=errs.get)
        print(f"worst error against f64: {errs[worst]:.3e} ({worst})")
        table = {}
        for name in [*libs, *reversed(libs)]:
            for bt, c in TIMED:
                table.setdefault(f"gate BT {bt} C {c}", {}).setdefault(name, []).append(
                    device_ms(gate(libs[name], gates[bt, c])))
            for key in MEANS[:3]:
                table.setdefault("means BT {} N {} C {}".format(*key), {}).setdefault(
                    name, []).append(device_ms(mean(libs[name], means[key])))
        for bt, c in TIMED:
            m, w, b, _, _ = gates[bt, c]
            table[f"gate BT {bt} C {c}"]["torch.addmm"] = [
                device_ms(lambda: torch.addmm(b, m, w.t()))]
    for row, cols in table.items():
        print(f"{row:24s}", "  ".join(f"{n} " + "/".join(f"{t:.4f}" for t in ts)
                                     for n, ts in cols.items()))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "gate_variants.json").write_text(json.dumps(
        {"card": card, "errors": errs, "ms": table}, indent=1))
    return 0 if errs[worst] <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main())
