#!/usr/bin/env python3
"""Mutation check of the limits that hold kernels E and I in bf16, on the card.

    python3 tools/mutate_gate_norm.py [dir]

Copies ``maed_tpu_torch`` twice into ``dir`` (outside the repository;
without one, a fresh temporary directory that is removed at the end) and
breaks each copy in one place:

- ``groupnorm``: the bf16 cluster GroupNorm (``groupnorm_cluster_kernel`` of
  ``csrc/groupnorm.cu``) leaves the last cluster member's partial moments out
  of every frame's sums;
- ``gate``: E's gate product (``gate_alpha_bf16_kernel`` of
  ``csrc/ln_mlp.cu``) drops its last 128-wide k-step.

It builds each copy and holds, at the flagship shapes and with
chip_smoke.py's limits, GroupNorm at the stem norm (128 x 112 x 112 x 64,
ReLU) and at a stage-1 norm3 (128 x 56 x 56 x 256, with and without the
residual and its ReLU): bf16 2e-2 abs + 1e-2 rel, f32 1e-4; and
``fused_gate_proj`` at (128, 197, 768): alpha 4e-3 (f32 1e-6), the output
3e-2 + 2e-2 rel (f32 1e-4). Each mutant must fail its kernel's bf16 limits
at every shape and pass in f32 (other kernels); the unchanged sources must
pass everything. Exits 1 if a check came out the other way.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# kernel -> (source, line, mutant line)
MUTANTS = {
    "groupnorm": ("groupnorm.cu", "for (int r = 0; r < ranks; ++r) {",
                  "for (int r = 0; r < ranks - 1; ++r) {"),  # every stem site has 2 or more
    "gate": ("ln_mlp.cu", "const int steps = (K + kGtK - 1) / kGtK;",
             "const int steps = (K + kGtK - 1) / kGtK - 1;"),  # K = 1536: 12 steps
}
LIMITS = {("groupnorm", "bf16"): (2e-2, 1e-2), ("groupnorm", "f32"): (1e-4, 0.0),
          ("gate", "bf16"): (3e-2, 2e-2), ("gate", "f32"): (1e-4, 0.0),
          ("alpha", "bf16"): (4e-3, 0.0), ("alpha", "f32"): (1e-6, 0.0)}

CHECK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from maed_tpu_torch.ops import groupnorm, mlp
limits = eval(sys.argv[2])
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)

def result(what, shape, name, got, want):
    atol, rtol = limits[what, name]
    err = (got.float() - want.float()).abs()
    over = (err - (atol + rtol * want.float().abs())).max().item() > 0
    print(f"RESULT {what} {shape} {name} {int(over)} {err.max().item():.3e}")

for side, ch, relu, with_res in ((112, 64, True, False), (56, 256, False, False),
                                 (56, 256, True, True)):
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = (torch.randn(128, side, side, ch, device=dev, generator=gen) * 2 + 0.5).to(dt)
        res = torch.randn(x.shape, device=dev, generator=gen).to(dt) if with_res else None
        s = torch.rand(ch, device=dev, generator=gen) + 0.5
        b = torch.randn(ch, device=dev, generator=gen) * 0.1
        args = (x, s, b, 32, 1e-5, relu, res)
        shape = f"{side}x{side}x{ch}" + ("+residual" if with_res else "")
        result("groupnorm", shape, name, groupnorm.fused_groupnorm(*args),
               groupnorm.groupnorm_reference(*args))
        del x, res, args
rng = np.random.RandomState(0)
B, N, C = 128, 197, 768
ys, yt, xr = (rng.randn(B, N, C) for _ in range(3))
wts, wp = rng.randn(2 * C, 2 * C) / np.sqrt(2 * C), rng.randn(C, C) / np.sqrt(C)
bts = torch.from_numpy(rng.randn(2 * C) * 0.1).to(dev, torch.float32)
bp = torch.from_numpy(rng.randn(C) * 0.1).to(dev, torch.float32)
for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    T = lambda a: torch.from_numpy(a).to(dev, dt)
    args = (T(ys), T(yt), T(xr), T(wts), bts, T(wp), bp)
    (got, alpha), (want, want_alpha) = mlp.fused_gate_proj(*args), mlp.gate_proj_reference(*args)
    result("alpha", "128x197x768", name, alpha, want_alpha)
    result("gate", "128x197x768", name, got, want)
"""


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHECK, str(tree), repr(LIMITS)],
                         capture_output=True, text=True, timeout=1200)
    if out.returncode:
        raise SystemExit(f"the check failed to run in {tree}:\n{out.stdout}\n{out.stderr}")
    results = {}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT"):
            _, what, shape, name, fails, err = line.split()
            results[what, shape, name] = bool(int(fails))
            print(f"  {what} {shape} {name}: max abs err {err}: "
                  f"{'FAILS' if int(fails) else 'passes'} {LIMITS[what, name]}")
    return results


def check(dest: Path) -> int:
    """Break a copy at ``dest`` for each kernel, then hold the copies and
    the sources to the limits."""
    ok = True
    for kernel, (source, line, mutant) in MUTANTS.items():
        tree = dest / kernel
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "maed_tpu_torch", tree / "maed_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = tree / "maed_tpu_torch" / "csrc" / source
        text = path.read_text()
        if text.count(line) != 1:
            raise SystemExit(f"expected once in {path}: {line}")
        path.write_text(text.replace(line, mutant))
        print(f"mutant {kernel}: {mutant}")
        results = run(tree)
        held = [k for k in results if k[0] == kernel or (kernel == "gate" and k[0] == "alpha")]
        if not held or not any(results[k] for k in held if k[2] == "bf16"):
            print(f"mutant {kernel}: passed every bf16 limit, expected to fail")
            ok = False
        for key in held:
            if key[2] == "f32" and results[key]:
                print(f"mutant {kernel} {key}: failed in f32, expected to pass")
                ok = False
        if kernel == "groupnorm" and not all(results[k] for k in held if k[2] == "bf16"):
            print("mutant groupnorm: a bf16 site passed, expected all to fail")
            ok = False
    print("the sources as they are:")
    clean = run(ROOT)
    for key, fails in clean.items():
        if fails:
            print(f"unchanged {key}: failed")
            ok = False
    print("mutation check", "ok" if ok and clean else "NOT ok")
    return 0 if ok and clean else 1


def main() -> int:
    if len(sys.argv) > 1:
        dest = Path(sys.argv[1]).resolve()
        if ROOT in dest.parents or dest == ROOT:
            raise SystemExit("give a directory outside the repository")
        return check(dest)
    with tempfile.TemporaryDirectory(prefix="mutate_gate_norm_") as dest:
        return check(Path(dest))


if __name__ == "__main__":
    sys.exit(main())
