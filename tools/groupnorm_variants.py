#!/usr/bin/env python3
"""Time variants of the bf16 cluster GroupNorm (kernel I) at the stem's sites.

    python3 tools/groupnorm_variants.py [variant ...]

Copies ``maed_tpu_torch`` into a temporary directory outside the repository
once per variant, edits ``csrc/groupnorm.cu`` as the variant says, builds the
copy and times ``fused_groupnorm`` on the card at the stem's 12 kinds of site
(128 frames channels-last, bf16, the cluster each site gets; device time,
the calls queued behind a sleep, median of 7 x 50), with each site's max abs
error against the plain version and the 52-launch forward's sum. Variants:

- ``base``: the sources as they are;
- ``chunks16``, ``chunks4``: 16 or 4 bulk copies a CTA and frame, not 8;
- ``unroll8``: 8 chunks a thread in flight in the apply pass without a
  residual too;
- ``local`` (a diagnostic: wrong moments): each CTA normalises with its own
  share's moments, without the exchange through the cluster;
- ``nobarrier`` (a diagnostic: wrong moments): ``local`` without any
  cluster barrier either.

Default: all of them, ``base`` first and last. Prints the card and one
``VARIANT name {json}`` line each.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_EXCHANGE = "    cluster_arrive();  // every member's part_s is written ...\n    cluster_wait();\n"
_GATHER = "all_s[i] = ld_cluster_f32(smem_u32(part_s + i % (2 * G)), i / (2 * G));"
# variant -> (text, replacement) edits of csrc/groupnorm.cu
VARIANTS = {
    "base": [],
    "chunks16": [("constexpr int kClChunks = 8; ", "constexpr int kClChunks = 16; ")],
    "chunks4": [("constexpr int kClChunks = 8; ", "constexpr int kClChunks = 4; ")],
    "unroll8": [("constexpr int kClUnroll = kRes ? 8 : 4;", "constexpr int kClUnroll = 8;")],
    "local": [(_EXCHANGE, "    __syncthreads();\n"), (_GATHER, "all_s[i] = part_s[i % (2 * G)];")],
    "nobarrier": [
        (_EXCHANGE, "    __syncthreads();\n"), (_GATHER, "all_s[i] = part_s[i % (2 * G)];"),
        ("    cluster_arrive();  // done with the others' part_s: waited for before it is "
         "written again\n", ""),
        ("    if (it > 0) cluster_wait();\n", ""),
        ("  cluster_wait();  // no member leaves while another may still read its part_s\n", "")],
}

RUN = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
from maed_tpu_torch.ops import groupnorm
dev, bf = torch.device("cuda"), torch.bfloat16

def device_ms(fn, iters=50):
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

# (side, channels, ReLU, residual, launches a forward), as chip_smoke.GROUPNORM_SITES
sites = ((112, 64, True, False, 1), (56, 64, True, False, 6), (56, 256, False, False, 1),
         (56, 256, True, True, 3), (56, 128, True, False, 1), (28, 128, True, False, 7),
         (28, 512, False, False, 1), (28, 512, True, True, 4), (28, 256, True, False, 1),
         (14, 256, True, False, 17), (14, 1024, False, False, 1), (14, 1024, True, True, 9))
gen = torch.Generator(device=dev).manual_seed(0)
out, forward = {}, 0.0
for side, ch, relu, with_res, per in sites:
    x = (torch.randn(128, side, side, ch, device=dev, generator=gen) * 2 + 0.5).to(bf)
    r = torch.randn(x.shape, device=dev, generator=gen).to(bf) if with_res else None
    s = torch.rand(ch, device=dev, generator=gen) + 0.5
    b = torch.randn(ch, device=dev, generator=gen) * 0.1
    args = (x, s, b, 32, 1e-5, relu, r)
    err = (groupnorm.fused_groupnorm(*args).float()
           - groupnorm.groupnorm_reference(*args).float()).abs().max().item()
    ms = device_ms(lambda: groupnorm.fused_groupnorm(*args))
    out[f"{side}x{ch}" + ("+res" if with_res else "")] = [ms, err]
    forward += ms * per
out["forward"] = forward
print("VARIANT " + json.dumps(out))
"""


def main() -> int:
    names = sys.argv[1:] or ["base", *(v for v in VARIANTS if v != "base"), "base"]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    failed = 0
    with tempfile.TemporaryDirectory(prefix="groupnorm_variants_") as dest:
        for i, name in enumerate(names):
            tree = Path(dest) / f"{i}_{name}"
            shutil.copytree(ROOT / "maed_tpu_torch", tree / "maed_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            source = tree / "maed_tpu_torch" / "csrc" / "groupnorm.cu"
            text = source.read_text()
            for old, new in VARIANTS[name]:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name}: expected once in {source}: {old!r}")
                text = text.replace(old, new)
            source.write_text(text)
            proc = subprocess.run([sys.executable, "-c", RUN, str(tree)], capture_output=True,
                                  text=True, timeout=900)
            lines = [line for line in proc.stdout.splitlines() if line.startswith("VARIANT ")]
            if proc.returncode or not lines:
                print(f"variant {name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
                failed = 1
                continue
            print(f"VARIANT {name} {lines[0][len('VARIANT '):]}", flush=True)
    return failed


if __name__ == "__main__":
    sys.exit(main())
