"""Host-clock time of the eager bf16 flagship request, for comparing two
checkouts of the port on one card.

    PYTHONPATH=<checkout> python <this file> [--requests 20] [--st-mode parallel]

It imports ``maed_tpu_torch`` from wherever the path finds it (so run by
path, it times the checkout named on PYTHONPATH), builds the released
stage-2 MAED in bf16 with seeded random weights and the synthetic body
(``core.builder.build_eval_model``), and answers the requests of
chip_smoke.py::phase_serve (8 clips x 16 frames x 224^2 uint8, a J14
regressor): each timed on the host's clock from the call to
``torch.cuda.synchronize()``, after a warmup, and also to the call's return
(the host's work of enqueueing the request, which ends before the card's
when the host keeps ahead). Prints one JSON line with every request's ms,
their medians and the card's name and power limit.
Run checkouts in the order a b b a in one call to compare them.

``--dispatch N`` also times the host's side of one kernel call: N calls of
``fast_layernorm`` (the public entry point, through whatever dispatch the
checkout has) and N of its launch function ``_layernorm_kernel`` alone, on
a (64, 768) bf16 tensor whose kernel takes ~2 us on the card, so that the
host's time is what is measured; us a call of each.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--st-mode", default="parallel")
    ap.add_argument("--dispatch", type=int, default=0)
    args = ap.parse_args(argv)

    import maed_tpu_torch
    from maed_tpu_torch import kernels
    from maed_tpu_torch.core.builder import build_eval_model

    device = torch.device("cuda", 0)
    kernels.build()
    model, smpl = build_eval_model(st_mode=args.st_mode, dtype=torch.bfloat16, device=device,
                                   seed=0, allow_synthetic_smpl=True)
    rng = np.random.RandomState(1)
    clips = torch.from_numpy(rng.randint(0, 256, (8, 16, 224, 224, 3), dtype=np.uint8)).to(device)
    jreg = rng.rand(14, 6890)
    jreg = torch.from_numpy(jreg / jreg.sum(axis=1, keepdims=True)).to(device, torch.float32)
    for _ in range(3):
        model(clips, smpl, J_regressor=jreg)
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        model(clips, smpl, J_regressor=jreg)
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dispatch = {}
    if args.dispatch:
        from maed_tpu_torch.ops import layernorm

        x = torch.randn(64, 768, device=device).to(torch.bfloat16)
        w, b = torch.ones(768, device=device), torch.zeros(768, device=device)
        with torch.inference_mode():
            for name, fn in (("entry_point_us", layernorm.fast_layernorm),
                             ("launch_us", layernorm._layernorm_kernel)):
                for _ in range(100):
                    fn(x, w, b, 1e-6)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.dispatch):
                    fn(x, w, b, 1e-6)
                torch.cuda.synchronize()
                dispatch[name] = (time.perf_counter() - t0) / args.dispatch * 1e6
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"package": maed_tpu_torch.__file__, "st_mode": args.st_mode,
                      "request_ms": times, "median_ms": statistics.median(times),
                      "host_ms": host, "median_host_ms": statistics.median(host),
                      **dispatch, "card": card}), flush=True)


if __name__ == "__main__":
    main()
