"""The train step on the card: the counterpart of the JAX package's
``tools/bench_train.py``.

Timing mode (the default) times ``parallel.train_step``'s step, built as
``core.builder.build_train_model`` builds the model, over the stage-2
composition of the released recipe (3 2D clips + 4 3D clips of 16 frames at
224^2 and 7 images a step: both forwards, the loss, the backward, the Adam
update) or with ``--stage1`` over stage 1's (128 images through the
ResNet-50 + KTD). It prints ms a step and frames/s (``utils.timing.timeit``)
beside the card's name and power limit; ``--trace DIR`` captures the timed
loop (``utils.profiling``, a Chrome trace).

``--learn N`` is a learning soak instead: N steps over ``--n_batches`` fixed
batches whose targets come from the SMPL forward itself (smooth pose tracks
-> the 49-joint bank -> weak-perspective projection: the JAX tool's
``RandomState`` draws), the loss trajectory to ``--out`` as JSON with the
JAX tool's keys, and the assertion that the last decile's mean loss is
below 0.8 x the first's. ``--smoke`` runs it at 1 block, 2 heads (head dim
384) and 64 px, and skips the assertion.

    python -m maed_tpu_torch.tools.bench_train [--stage1] [--remat] [--dtype bf16|f32] \
        [--iters 10] [--u8] [--trace DIR] [--device cuda|cpu]
    python -m maed_tpu_torch.tools.bench_train --learn 300 --out soak.json [--dtype f32]
    python -m maed_tpu_torch.tools.bench_train --learn 20 --smoke [--device cpu]

``--cost`` and ``--donate`` are XLA's (the compiled step's cost analysis,
buffer donation) and are refused. This is a tool, not the port's benchmark.
It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REFUSED = {
    "cost": "--cost prints XLA's cost analysis of the compiled step; the port runs the step "
            "eagerly and has no compiled executable to analyse (trace it with --trace DIR)",
    "donate": "--donate donates the state's buffers to XLA; torch.optim already updates the "
              "parameters and moments in place",
}


class SoakOptim:
    """The JAX tool's optimizer settings (``make_optimizer``'s keys)."""
    LR, WD, WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES = 5e-5, 0.0, 2, 0.1, [30]
    OPTIM, MOMENTUM = "adam", 0.9


def composition(stage1: bool, smoke: bool):
    """(2D clips, 3D clips, images, frames a clip, pixels) of a step."""
    if smoke:
        return 1, 2, 2, 4, 64
    if stage1:
        return 0, 0, 128, 16, 224
    return 3, 4, 7, 16, 224


def consistent_targets(rng, smpl, n, T, device):
    """Self-consistent (theta, kp_3d, kp_2d) of n x T frames: smooth pose
    tracks and shapes from ``rng`` (the JAX tool's draws), their joints
    through the SMPL forward and the weak-perspective projection."""
    import torch

    from maed_tpu_torch.ops.geometry import weak_perspective_projection
    from maed_tpu_torch.ops.smpl import smpl_forward

    anchors = rng.randn(n, 4, 72).astype(np.float32) * 0.4
    t = np.linspace(0, 3, T)
    i0 = np.minimum(t.astype(int), 2)
    w = (0.5 - 0.5 * np.cos(np.pi * (t - i0)))[None, :, None].astype(np.float32)
    pose = (1 - w) * anchors[:, i0] + w * anchors[:, i0 + 1]  # (n, T, 72)
    shape = np.repeat(rng.randn(n, 1, 10).astype(np.float32) * 0.3, T, axis=1)
    cam = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, T, 1))
    with torch.inference_mode():
        joints = smpl_forward(smpl, torch.from_numpy(shape.reshape(-1, 10)).to(device),
                              pose_axis_angle=torch.from_numpy(pose.reshape(-1, 72)).to(device)
                              )["joints"].reshape(n, T, 49, 3)
        kp2d = weak_perspective_projection(joints, torch.from_numpy(cam).to(device))
    joints, kp2d = joints.cpu().numpy(), kp2d.cpu().numpy()
    conf = np.ones((n, T, 49, 1), np.float32)
    return {
        "theta": np.concatenate([cam, pose, shape], axis=-1),
        "kp_3d": np.concatenate([joints, conf], axis=-1),
        "kp_2d": np.concatenate([kp2d, conf], axis=-1),
    }


def _tensors(tree, device):
    import torch

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def learn_batch(seed, smpl, n2d, n3d, nimg, T, res, device):
    """One fixed soak batch (vid_batch, img_batch) on ``device``."""
    rng = np.random.RandomState(seed)
    vid = None  # stage 1 has no video half
    if n2d + n3d:
        tgt3 = consistent_targets(rng, smpl, n3d, T, device)
        tgt2 = consistent_targets(rng, smpl, n2d, T, device)
        vid = {
            "images": rng.randn(n2d + n3d, T, res, res, 3).astype(np.float32),
            "target_2d": {"kp_2d": tgt2["kp_2d"]},
            "target_3d": {"kp_2d": tgt3["kp_2d"], "kp_3d": tgt3["kp_3d"],
                          "theta": tgt3["theta"], "w_smpl": np.ones((n3d, T), np.float32)},
        }
    tgti = consistent_targets(rng, smpl, nimg, 1, device)
    img = {
        "image": rng.randn(nimg, res, res, 3).astype(np.float32),
        "kp_2d": tgti["kp_2d"][:, 0],
        "kp_3d": tgti["kp_3d"][:, 0],
        "theta": tgti["theta"][:, 0],
        "w_smpl": np.ones((nimg,), np.float32),
    }
    return _tensors(vid, device), _tensors(img, device)


def timing_batch(rng, n2d, n3d, nimg, T, res, u8, device):
    """The timing mode's batch: random frames (uint8 with ``u8``, else
    float noise) and random targets, as the JAX tool draws them."""
    def frames(*shape):
        if u8:
            return rng.randint(0, 256, shape).astype(np.uint8)
        return rng.randn(*shape).astype(np.float32)

    vid = None if n2d + n3d == 0 else {
        "images": frames(n2d + n3d, T, res, res, 3),
        "target_2d": {"kp_2d": rng.rand(n2d, T, 49, 3).astype(np.float32)},
        "target_3d": {
            "kp_2d": rng.rand(n3d, T, 49, 3).astype(np.float32),
            "kp_3d": rng.rand(n3d, T, 49, 4).astype(np.float32),
            "theta": rng.rand(n3d, T, 85).astype(np.float32),
            "w_smpl": np.ones((n3d, T), np.float32),
        },
    }
    img = {
        "image": frames(nimg, res, res, 3),
        "kp_2d": rng.rand(nimg, 49, 3).astype(np.float32),
        "kp_3d": rng.rand(nimg, 49, 4).astype(np.float32),
        "theta": rng.rand(nimg, 85).astype(np.float32),
        "w_smpl": np.ones((nimg,), np.float32),
    }
    return _tensors(vid, device), _tensors(img, device)


def build_step(args, device):
    """(step, smpl): the model, Adam and the step, as the trainer builds them."""
    import torch

    from maed_tpu_torch.core.builder import build_train_model
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if args.smoke:
        kw = dict(num_blocks=1, num_heads=2, hidden_dim=64, img_size=64)
    elif args.stage1:
        kw = dict(encoder="cnn")
    else:
        kw = dict(remat=args.remat)
    model, smpl = build_train_model(dtype=dtype, device=device, seed=0,
                                    allow_synthetic_smpl=True, **kw)
    optimizer = make_optimizer(SoakOptim, 500, model.parameters())
    generator = torch.Generator(device=device).manual_seed(0)
    return make_train_step(model, optimizer, smpl, LossWeights(), generator), smpl


def learning_soak(args, step, smpl, device):
    """N steps over the fixed batches; the trajectory's dict (JSON to --out)."""
    n2d, n3d, nimg, T, res = composition(args.stage1, args.smoke)
    batches = [learn_batch(1000 + k, smpl, n2d, n3d, nimg, T, res, device)
               for k in range(args.n_batches)]
    print(f"[learn] {args.learn} steps over {args.n_batches} fixed batches, "
          f"dtype={args.dtype}", file=sys.stderr)
    losses = []  # on the device; read once at the end
    t0 = time.perf_counter()
    for i in range(args.learn):
        vid, img = batches[i % len(batches)]
        losses.append(step(vid, img)["loss"])
        if (i + 1) % 50 == 0:
            print(f"[learn] step {i + 1}: loss {float(losses[-1]):.4f}", file=sys.stderr)
    losses = [float(x) for x in losses]
    dt = time.perf_counter() - t0
    k = max(1, args.learn // 10)
    head, tail = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    result = {"dtype": args.dtype, "steps": args.learn, "n_batches": args.n_batches,
              "donate": False, "head_mean": head, "tail_mean": tail, "ratio": tail / head,
              "wall_s": dt, "losses": losses}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(f"[learn] loss {head:.4f} -> {tail:.4f} (ratio {tail / head:.3f}) in {dt:.1f} s")
    if args.smoke:
        print("[learn] smoke mode: the wiring runs; no sustained decrease is asked of it")
        return result
    if not tail < 0.8 * head:
        raise AssertionError(
            f"no sustained learning at flagship scale: first-decile mean {head:.4f} -> "
            f"last-decile mean {tail:.4f} (need < 0.8x)")
    print("[learn] PASS: sustained loss decrease at flagship scale")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--stage1", action="store_true",
                    help="stage 1's step: 128 images a step through the ResNet-50 + KTD")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each ViT block in the backward")
    ap.add_argument("--cost", action="store_true", help="refused: " + REFUSED["cost"])
    ap.add_argument("--donate", action="store_true", help="refused: " + REFUSED["donate"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--learn", type=int, default=0,
                    help="N steps of the learning soak instead of timing (0: timing)")
    ap.add_argument("--out", default="", help="--learn: the trajectory's JSON")
    ap.add_argument("--n_batches", type=int, default=4,
                    help="--learn: fixed batches cycled through")
    ap.add_argument("--smoke", action="store_true",
                    help="1 block, 2 heads, 64 px; --learn skips its assertion")
    ap.add_argument("--trace", default="", help="a Chrome trace of the timed loop, into DIR")
    ap.add_argument("--u8", action="store_true", help="uint8 frames on the device")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for flag, why in REFUSED.items():
        if getattr(args, flag):
            ap.error(why)

    import torch

    from maed_tpu_torch.utils import profiling
    from maed_tpu_torch.utils.timing import card_identity, sync, timeit

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_train: no CUDA device (pass --device cpu to run on the CPU)")
    device = torch.device(args.device)
    card = card_identity() if device.type == "cuda" else "cpu"
    print(f"device {device} ({card}), torch {torch.__version__}, dtype={args.dtype} "
          f"remat={args.remat} stage1={args.stage1} smoke={args.smoke}", file=sys.stderr)
    step, smpl = build_step(args, device)
    if args.learn:
        return learning_soak(args, step, smpl, device)

    n2d, n3d, nimg, T, res = composition(args.stage1, args.smoke)
    vid, img = timing_batch(np.random.RandomState(0), n2d, n3d, nimg, T, res, args.u8, device)
    sync(step(vid, img))  # the first step: every kernel built and every buffer allocated
    if args.trace:
        profiling.start_trace(args.trace)
    try:
        dt = timeit(step, (vid, img), iters=args.iters, warmup=0)
    finally:
        if args.trace:
            print(f"trace: {profiling.stop_trace()}", file=sys.stderr)
    loss = float(step(vid, img)["loss"])
    frames = (n2d + n3d) * T + nimg
    print(f"train step {dt * 1e3:.1f} ms -> {frames / dt:.0f} frames/s (loss {loss:.3f}; "
          f"{card})")
    return {"ms": dt * 1e3, "frames_per_s": frames / dt, "card": card}


if __name__ == "__main__":
    main()
