#!/usr/bin/env python3
"""Mutation check of the blocked attention kernel's bf16 limit, on the card.

    python3 tools/mutate_blocked_tail.py /some/empty/dir

Copies ``maed_tpu_torch`` into the given directory (outside the repository),
makes the bf16 kernel's key loop of ``csrc/st_attention.cu`` drop its last,
partial tile of keys, builds that copy and holds ``fused_attention`` against
``attention_blocked_reference`` at the shapes chip_smoke.py and the card tests
use. The limit in force (2e-3 abs + 1e-2 rel) must fail at every S that is not
a multiple of 64 keys; the line of each shape also says what the looser 1e-2
abs + 1e-2 rel would have said. f32 runs other device code and must still
pass. Then the same checks on the unchanged sources, which must all pass.
Exits 1 if a check came out the other way.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOOP = "const int tiles = (S + kMmaKeys - 1) / kMmaKeys;"
MUTANT = "const int tiles = S / kMmaKeys;"
LIMITS = {"bf16": (2e-3, 1e-2), "f32": (2e-5, 0.0)}
LOOSE = (1e-2, 1e-2)
# (B, h, S, d): the coupling shape of the flagship, and the card tests' lengths
SHAPES = ((8, 12, 3152, 64), (2, 3, 1576, 32), (2, 12, 1025, 32), (2, 3, 1088, 64))

CHECK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from maed_tpu_torch.ops import attention
shapes, limits, loose = eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4])
for B, h, S, d in shapes:
    rng = np.random.RandomState(S)
    qkv = torch.from_numpy(rng.randn(3, B, h, S, d)).cuda()
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = qkv.to(dt)
        got = attention.fused_attention(q, k, v).float()
        want = attention.attention_blocked_reference(q, k, v, d ** -0.5).float()
        err = (got - want).abs()
        over = lambda lim: ((err - (lim[0] + lim[1] * want.abs())).max().item() > 0)
        print(f"RESULT {S} {name} {int(over(limits[name]))} {int(over(loose))} "
              f"{err.max().item():.3e} {want.abs().mean().item():.3e}")
"""


def run(tree: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHECK, str(tree), repr(SHAPES), repr(LIMITS),
                          repr(LOOSE)], capture_output=True, text=True, timeout=1200)
    if out.returncode:
        raise SystemExit(f"the check failed to run in {tree}:\n{out.stdout}\n{out.stderr}")
    results = {}
    for line in out.stdout.splitlines():
        if line.startswith("RESULT"):
            _, S, name, fails, fails_loose, err, mean = line.split()
            results[int(S), name] = bool(int(fails)), bool(int(fails_loose))
            print(f"  S {S} {name}: max abs err {err} (mean |out| {mean}): "
                  f"{'FAILS' if int(fails) else 'passes'} {LIMITS[name]}, "
                  f"{'fails' if int(fails_loose) else 'passes'} {LOOSE}")
    return results


def main() -> int:
    dest = Path(sys.argv[1]).resolve()
    if ROOT in dest.parents or dest == ROOT:
        raise SystemExit("give a directory outside the repository")
    tree = dest / "mutant"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "maed_tpu_torch", tree / "maed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source = tree / "maed_tpu_torch" / "csrc" / "st_attention.cu"
    text = source.read_text()
    if text.count(LOOP) != 1:
        raise SystemExit(f"expected the key loop's bound once in {source}")
    source.write_text(text.replace(LOOP, MUTANT))

    print("the last key tile dropped in the bf16 kernel:")
    mutant = run(tree)
    print("the sources as they are:")
    clean = run(ROOT)
    ok = True
    for (S, name), (fails, _) in mutant.items():
        want = name == "bf16" and S % 64 != 0
        if fails != want:
            print(f"mutant S {S} {name}: {'failed' if fails else 'passed'}, expected the other")
            ok = False
    for (S, name), (fails, _) in clean.items():
        if fails:
            print(f"unchanged S {S} {name}: failed")
            ok = False
    print("mutation check", "ok" if ok else "NOT ok")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
