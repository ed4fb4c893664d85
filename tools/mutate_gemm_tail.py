#!/usr/bin/env python3
"""Mutation check of the limits that hold kernels C and D, on the card.

    python3 tools/mutate_gemm_tail.py [dir]

Copies ``maed_tpu_torch`` into ``dir`` (outside the repository; without one,
a fresh temporary directory that is removed at the end) and breaks the bf16
dense GEMM of ``csrc/ln_mlp.cu`` (``dense_bf16_kernel``, the products of C
and D): its k-loop drops its last 64-wide k-step. It builds that copy and
holds ``fused_ln_mlp`` and ``fused_ln_dense`` against their plain versions
at the flagship shapes (M 25216, C 768, H 3072, qkv width 2304) and at the
card tests' ragged (100, 776, 176), with chip_smoke.py's limits: bf16 C 5e-2
abs + 2e-2 rel, D 2e-2 + 1e-2, f32 1e-4 for both. The mutant must fail both
bf16 limits at every shape and pass in f32 (other device code); the
unchanged sources must pass everything. Exits 1 if a check came out the
other way.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LINE = "steps = (K + kDnBK - 1) / kDnBK;"
MUTANT = "steps = (K + kDnBK - 1) / kDnBK - 1;"  # K > 64 at every shape below
LIMITS = {("C", "bf16"): (5e-2, 2e-2), ("D", "bf16"): (2e-2, 1e-2),
          ("C", "f32"): (1e-4, 0.0), ("D", "f32"): (1e-4, 0.0)}
# (M, C, H): H is C's hidden width and D's output width is 3C
SHAPES = ((25216, 768, 3072), (100, 776, 176))

CHECK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from maed_tpu_torch.ops import mlp
shapes, limits = eval(sys.argv[2]), eval(sys.argv[3])
dev = torch.device("cuda")
for M, C, H in shapes:
    rng = np.random.RandomState(M + C)
    T = lambda a, dt=torch.float32: torch.from_numpy(a).to(dev, dt)
    x, w1, w2, wq = rng.randn(M, C), rng.randn(H, C) / np.sqrt(C), rng.randn(C, H) / np.sqrt(H), \
        rng.randn(3 * C, C) / np.sqrt(C)
    s, b, b1, b2, bq = T(rng.rand(C) + 0.5), T(rng.randn(C) * 0.1), T(rng.randn(H) * 0.1), \
        T(rng.randn(C) * 0.1), T(rng.randn(3 * C) * 0.1)
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        xd = T(x, dt)
        cases = {"C": ((xd, s, b, T(w1, dt), b1, T(w2, dt), b2, 1e-6),
                       mlp.fused_ln_mlp, mlp.ln_mlp_reference),
                 "D": ((xd, s, b, T(wq, dt), bq, 1e-6), mlp.fused_ln_dense, mlp.ln_dense_reference)}
        for kernel, (args, fused, plain) in cases.items():
            got, want = fused(*args).float(), plain(*args).float()
            err = (got - want).abs()
            atol, rtol = limits[kernel, name]
            over = (err - (atol + rtol * want.abs())).max().item() > 0
            print(f"RESULT {kernel} {M} {C} {name} {int(over)} {err.max().item():.3e}")
"""


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHECK, str(tree), repr(SHAPES), repr(LIMITS)],
                         capture_output=True, text=True, timeout=1200)
    if out.returncode:
        raise SystemExit(f"the check failed to run in {tree}:\n{out.stdout}\n{out.stderr}")
    results = {}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT"):
            _, kernel, M, C, name, fails, err = line.split()
            results[kernel, int(M), int(C), name] = bool(int(fails))
            print(f"  {kernel} M {M} C {C} {name}: max abs err {err}: "
                  f"{'FAILS' if int(fails) else 'passes'} {LIMITS[kernel, name]}")
    return results


def check(tree: Path) -> int:
    """Break the copy at ``tree``, then hold both it and the sources to the limits."""
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "maed_tpu_torch", tree / "maed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source = tree / "maed_tpu_torch" / "csrc" / "ln_mlp.cu"
    text = source.read_text()
    if text.count(LINE) != 1:
        raise SystemExit(f"expected the GEMM's k-step count once in {source}: {LINE}")
    source.write_text(text.replace(LINE, MUTANT))

    print("the bf16 GEMM's last k-step dropped:")
    mutant = run(tree)
    print("the sources as they are:")
    clean = run(ROOT)
    ok = len(mutant) == len(clean) == 4 * len(SHAPES)
    for (kernel, M, C, name), fails in mutant.items():
        if fails != (name == "bf16"):
            print(f"mutant {kernel} M {M} C {C} {name}: {'failed' if fails else 'passed'}, "
                  "expected the other")
            ok = False
    for key, fails in clean.items():
        if fails:
            print(f"unchanged {key}: failed")
            ok = False
    print("mutation check", "ok" if ok else "NOT ok")
    return 0 if ok else 1


def main() -> int:
    if len(sys.argv) > 1:
        dest = Path(sys.argv[1]).resolve()
        if ROOT in dest.parents or dest == ROOT:
            raise SystemExit("give a directory outside the repository")
        return check(dest / "mutant")
    with tempfile.TemporaryDirectory(prefix="mutate_gemm_") as dest:
        return check(Path(dest) / "mutant")


if __name__ == "__main__":
    sys.exit(main())
