"""The readings that a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... [--controls 3]
        [--seconds 2] [--out readings.jsonl]

For every seed it runs the cell as ``run.py`` does (set-up from the seed,
a window of ``--seconds`` at the cell's own load, the check against the
plain reference) and prints the program's compared numbers. For the first
``--controls`` seeds it also prints the control's: for a bf16 cell the
reference computed in float8 (``Precision('fp8')``) in the program's place
on the same sampled requests; for an f32 training cell the reference with
TF32 on, and the fault of a step that leaves half of the batch out (the
reference on the rest). A step that leaves its state unchanged reads 1 on
``update`` by construction and needs no run. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import os
    build = ROOT / "maed_tpu_torch" / "kernels" / "_build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TRITON_HOME"] = str(build / "triton_home")
    import torch

    from benchmark.harness import check, drive

    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        cell = drive.load_cell(bench, args.workload)
        t0 = time.perf_counter()
        run = drive.Run(cell, seed, device, t0)
        run.setup()
        run.window(args.seconds)
        run.free_program()
        lines = [{"who": "program", "numbers": run.reference_numbers()}]
        if cell.mix["kind"] == "train":
            lines[0]["worst"] = check.worst_leaves(run.first_steps, run.reference_steps())
            lines[0]["losses"] = [run.first_steps["losses"], run.reference_steps()["losses"]]
        if n < args.controls:
            if cell.mix["kind"] == "infer":
                fp8 = lambda pool_i: run.reference_outputs(pool_i, "fp8")  # noqa: E731
                lines.append({"who": "control_fp8", "numbers": run.reference_numbers(fp8)})
            else:
                ref = run.reference_steps()
                for who, kw in (("control_tf32", {"tf32": True}),
                                ("fault_half_batch", {"half_batch": True})):
                    lines.append({"who": who, "numbers": check.train_gaps(
                        run.reference_steps(**kw), ref)})
        for line in lines:
            line.update(workload=args.workload, seed=seed, setup_s=run.obs.setup_s,
                        items=run.obs.items, seconds=time.perf_counter() - t0)
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
