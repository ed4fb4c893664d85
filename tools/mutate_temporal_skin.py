#!/usr/bin/env python3
"""Mutation check of the limits that hold kernels G/H (bf16) and A, on the card.

    python3 tools/mutate_temporal_skin.py [dir]

Copies ``maed_tpu_torch`` twice into ``dir`` (outside the repository;
without one, a fresh temporary directory that is removed at the end) and
breaks each copy in one place:

- ``temporal``: the bf16 temporal attention (``temporal_head`` of
  ``csrc/st_attention.cu``) leaves out its last key frame;
- ``skinning``: the skinning (``skinning_frames_kernel`` of
  ``csrc/skinning.cu``) leaves out joint 23 of the blend.

It builds each copy and holds it, with chip_smoke.py's limits, at
chip_smoke.py's shapes: the temporal attention on a (128, 197, 3, 12, 64)
projection at 16 frames in both layouts, on the ``temporal`` mode's
(128, 1, 3, 12, 64) and at 32 frames on (64, 5, 3, 3, 24) (bf16 1e-2 abs +
1e-2 rel, f32 1e-5), and the skinning at (128, 6890) (f32 1e-5). Then it runs
the card tests of both kernels (``test_temporal_attention_kernel``,
``test_skinning_kernel`` of tests/test_torch_port_cuda.py) against the copy.
The temporal mutant must fail every bf16 limit and pass in f32 (the f32
kernel is another); the skinning mutant must fail; each must fail its card
tests. The unchanged sources must pass everything. Exits 1 if a check came
out the other way.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# kernel -> (source, line, mutant line, the card test that must fail)
MUTANTS = {
    "temporal": ("st_attention.cu", "const int keys = a.T;", "const int keys = a.T - 1;",
                 "test_temporal_attention_kernel"),
    "skinning": ("skinning.cu",
                 "for (int j = 0; j < kJoints; ++j) {  // the blend: T = sum_j w_j A_j[:3]",
                 "for (int j = 0; j < kJoints - 1; ++j) {  // joint 23 left out",
                 "test_skinning_kernel"),
}
LIMITS = {"bf16": (1e-2, 1e-2), "f32": (1e-5, 0.0)}

CHECK = r"""
import sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from maed_tpu_torch.ops import skinning, st_attention
limits = eval(sys.argv[2])
dev = torch.device("cuda")

def result(what, shape, name, got, want):
    atol, rtol = limits[name]
    err = (got.float() - want.float()).abs()
    over = (err - (atol + rtol * want.float().abs())).max().item() > 0
    print(f"RESULT {what} {shape} {name} {int(over)} {err.max().item():.3e}")

rng = np.random.RandomState(0)
qkv_np = rng.randn(128, 197, 3, 12, 64)
cases = (("128x197x12x64", qkv_np, 16),
         ("128x1x12x64", qkv_np.mean(axis=1, keepdims=True) * np.sqrt(197), 16),
         ("64x5x3x24,T32", rng.randn(64, 5, 3, 3, 24), 32))
for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
    for shape, a, frames in cases:
        qkv = torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        scale = qkv.shape[-1] ** -0.5
        result("temporal", shape + ",btc", name,
               st_attention.temporal_attention_fused(qkv, frames, scale),
               st_attention.temporal_reference_btc(qkv, frames, scale))
        result("temporal", shape + ",head-leading", name,
               st_attention.temporal_attention(qkv, frames, scale),
               st_attention.temporal_reference(qkv, frames, scale))
v_posed = rng.randn(128, 6890, 3) * 0.3
W = rng.rand(6890, 24) ** 4
W /= W.sum(axis=1, keepdims=True)
rot, _ = np.linalg.qr(rng.randn(128 * 24, 3, 3))
A = np.zeros((128 * 24, 4, 4))
A[:, :3, :3], A[:, :3, 3], A[:, 3, 3] = rot, rng.randn(128 * 24, 3) * 0.3, 1.0
args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.float32)
        for a in (v_posed, W, A.reshape(128, 24, 4, 4))]
result("skinning", "128x6890", "f32", skinning.skinning(*args), skinning.skinning_reference(*args))
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
                  f"{'FAILS' if int(fails) else 'passes'} {LIMITS[name]}")
    return results


def card_tests(tree: Path, tests: str) -> bool:
    """Run the card tests ``tests`` (a -k expression) against the package at
    ``tree``; True if they all pass."""
    out = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
                          "no:cacheprovider", "tests/test_torch_port_cuda.py", "-k", tests],
                         cwd=tree, capture_output=True, text=True, timeout=1200)
    print("  card tests -k '" + tests + "': " + (out.stdout.strip().splitlines() or ["?"])[-1])
    return out.returncode == 0


def copy_tree(tree: Path, source: str, line: str, mutant: str) -> None:
    """The package, its card tests and the pytest settings at ``tree``, with
    ``line`` of ``csrc/<source>`` replaced by ``mutant``."""
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "maed_tpu_torch", tree / "maed_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    (tree / "tests").mkdir()
    for name in ("test_torch_port_cuda.py", "torch_port_common.py"):
        shutil.copy(ROOT / "tests" / name, tree / "tests" / name)
    shutil.copy(ROOT / "pyproject.toml", tree / "pyproject.toml")  # the cuda marker
    path = tree / "maed_tpu_torch" / "csrc" / source
    text = path.read_text()
    if text.count(line) != 1:
        raise SystemExit(f"expected once in {path}: {line}")
    path.write_text(text.replace(line, mutant))


def check(dest: Path) -> int:
    """Break a copy at ``dest`` for each kernel, then hold the copies and
    the sources to the limits and the card tests."""
    ok = True
    for kernel, (source, line, mutant, test) in MUTANTS.items():
        tree = dest / kernel
        copy_tree(tree, source, line, mutant)
        print(f"mutant {kernel}: {mutant}")
        results = run(tree)
        held = [k for k in results if k[0] == kernel]
        for key in held:
            if results[key] != (key[2] == "bf16" or kernel == "skinning"):
                print(f"mutant {kernel} {key}: {'failed' if results[key] else 'passed'}, "
                      "expected the other")
                ok = False
        if not held:
            print(f"mutant {kernel}: no result")
            ok = False
        if card_tests(tree, test):
            print(f"mutant {kernel}: the card tests passed, expected to fail")
            ok = False
    print("the sources as they are:")
    tree = ROOT
    clean = run(tree)
    for key, fails in clean.items():
        if fails:
            print(f"unchanged {key}: failed")
            ok = False
    if not card_tests(tree, " or ".join(test for *_, test in MUTANTS.values())):
        print("unchanged: the card tests failed")
        ok = False
    print("mutation check", "ok" if ok and clean else "NOT ok")
    return 0 if ok and clean else 1


def main() -> int:
    if len(sys.argv) > 1:
        dest = Path(sys.argv[1]).resolve()
        if ROOT in dest.parents or dest == ROOT:
            raise SystemExit("give a directory outside the repository")
        return check(dest)
    with tempfile.TemporaryDirectory(prefix="mutate_temporal_skin_") as dest:
        return check(Path(dest))


if __name__ == "__main__":
    sys.exit(main())
