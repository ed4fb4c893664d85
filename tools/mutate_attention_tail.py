#!/usr/bin/env python3
"""Mutation check of the bf16 limits of the two attention kernels, on the card.

    python3 tools/mutate_attention_tail.py [dir]

Copies ``maed_tpu_torch`` into ``dir`` (outside the repository; without one,
a fresh temporary directory that is removed at the end) and breaks the ragged end of both bf16 kernels of ``csrc/st_attention.cu``:

- blocked (kernel K): the key loop drops its last, partial 128-key tile;
- spatial (kernels F/J): the score width is S rounded down to whole 8-key
  groups instead of up, so the keys of the last partial group drop (192-196
  at S 197, 576 at S 577).

It builds that copy and holds ``fused_attention`` against the plain version
of the kernel it reaches (``attention_blocked_reference`` past 1024 tokens,
``_xla_attention`` below) at the shapes chip_smoke.py and the card tests use.
The limits in force (blocked 2e-3 abs + 1e-2 rel, spatial 1e-2 + 1e-2) must
fail at every S whose last tile or 8-key group is partial, and pass at the
others; the line of each shape also says what 1e-2 abs + 1e-2 rel would have
said. f32 runs other device code and must still pass. Then the same checks on
the unchanged sources, which must all pass. Exits 1 if a check came out the
other way.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (kernel, line of csrc/st_attention.cu, its mutant)
MUTATIONS = (
    ("blocked", "return (S + kBkTile - 1) / kBkTile;", "return S / kBkTile;"),  # key_tiles
    ("spatial", "const int width = (S + 7) / 8 * 8;", "const int width = S / 8 * 8;"),
)
KEY_TILE = 128  # csrc/st_attention.cu kBkTile
LIMITS = {("blocked", "bf16"): (2e-3, 1e-2), ("blocked", "f32"): (2e-5, 0.0),
          ("spatial", "bf16"): (1e-2, 1e-2), ("spatial", "f32"): (1e-5, 0.0)}
LOOSE = (1e-2, 1e-2)
# (kernel, B, h, S, d): the flagship's coupling and spatial shapes, and the
# card tests' lengths (1088: a multiple of 64 but not of 128; 1152: 9 tiles)
SHAPES = (("blocked", 8, 12, 3152, 64), ("blocked", 2, 3, 1576, 32), ("blocked", 2, 12, 1025, 32),
          ("blocked", 2, 3, 1088, 64), ("blocked", 2, 3, 1152, 64),
          ("spatial", 16, 12, 197, 64), ("spatial", 4, 12, 577, 64))

CHECK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from maed_tpu_torch.ops import attention
shapes, limits, loose = eval(sys.argv[2]), eval(sys.argv[3]), eval(sys.argv[4])
for kernel, B, h, S, d in shapes:
    rng = np.random.RandomState(S)
    qkv = torch.from_numpy(rng.randn(3, B, h, S, d)).cuda()
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = qkv.to(dt)
        got = attention.fused_attention(q, k, v).float()
        plain = (attention.attention_blocked_reference if kernel == "blocked"
                 else attention._xla_attention)
        want = plain(q, k, v, d ** -0.5).float()
        err = (got - want).abs()
        over = lambda lim: ((err - (lim[0] + lim[1] * want.abs())).max().item() > 0)
        print(f"RESULT {kernel} {S} {name} {int(over(limits[kernel, name]))} {int(over(loose))} "
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
            _, kernel, S, name, fails, fails_loose, err, mean = line.split()
            results[kernel, int(S), name] = bool(int(fails))
            print(f"  {kernel} S {S} {name}: max abs err {err} (mean |out| {mean}): "
                  f"{'FAILS' if int(fails) else 'passes'} {LIMITS[kernel, name]}, "
                  f"{'fails' if int(fails_loose) else 'passes'} {LOOSE}")
    return results


def caught(kernel: str, S: int) -> bool:
    """Whether the mutant of ``kernel`` must fail the bf16 limit at S."""
    return S % KEY_TILE != 0 if kernel == "blocked" else S % 8 != 0


def main() -> int:
    if len(sys.argv) > 1:
        dest = Path(sys.argv[1]).resolve()
        if ROOT in dest.parents or dest == ROOT:
            raise SystemExit("give a directory outside the repository")
        return check(dest / "mutant")
    with tempfile.TemporaryDirectory(prefix="mutate_attention_") as dest:
        return check(Path(dest) / "mutant")


def check(tree: Path) -> int:
    """Break the copy at ``tree``, then hold both it and the sources to the limits."""
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "maed_tpu_torch", tree / "maed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    source = tree / "maed_tpu_torch" / "csrc" / "st_attention.cu"
    text = source.read_text()
    for kernel, line, mutant in MUTATIONS:
        if text.count(line) != 1:
            raise SystemExit(f"expected the {kernel} kernel's line once in {source}: {line}")
        text = text.replace(line, mutant)
    source.write_text(text)

    print("the ragged ends broken (blocked: last key tile dropped; spatial: score width "
          "rounded down):")
    mutant = run(tree)
    print("the sources as they are:")
    clean = run(ROOT)
    ok = len(mutant) == len(clean) == 2 * len(SHAPES)
    for (kernel, S, name), fails in mutant.items():
        want = name == "bf16" and caught(kernel, S)
        if fails != want:
            print(f"mutant {kernel} S {S} {name}: {'failed' if fails else 'passed'}, "
                  "expected the other")
            ok = False
    for (kernel, S, name), fails in clean.items():
        if fails:
            print(f"unchanged {kernel} S {S} {name}: failed")
            ok = False
    print("mutation check", "ok" if ok else "NOT ok")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
