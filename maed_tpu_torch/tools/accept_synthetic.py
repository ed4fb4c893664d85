"""Closed-loop synthetic acceptance of the port: the counterpart of the JAX
package's ``tools/accept_synthetic.py``.

A fully synthetic loop that crosses every convention boundary at once (crop
camera, weak perspective, pelvis centring, the joint bank, theta slicing,
the windowing of the eval protocol):

1. ``generate``: smooth SMPL pose tracks (the JAX tool's ``RandomState``
   draws, so the tracks and DBs are its own), their 49 joints through the
   port's SMPL forward (kernel A on the card) and weak-perspective
   projection, frames of depth-ordered coloured joint disks (``utils.vis``:
   cv2's disks and HSV palette reproduced) written as JPEG at quality 95
   (``utils.image_io.write_jpeg``: the port decodes JPEG only), the
   ``synacc_{train,val}_db.pt`` DBs (``data.dataset.save_db``) and
   ``accept.yaml`` (``core.config``: the JAX tool's keys and values, tiny or
   ``--flagship``).
2. ``oracle``: GT-perfect predictions through the whole eval protocol
   (``VideoDataset(seqlen=0)`` -> ``ShardedLoader`` -> ``Evaluator.run``):
   the frames are swapped for their DB row indices, and the forward gathers
   the GT pose and shape and pushes them through the real head path
   (rot6d -> SMPL -> joint bank -> projection, ``models.heads``). Every
   metric must come out below ``--tol_mm``.
3. ``train``: the port's CLIs as subprocesses in ``--out``: ``python -m
   maed_tpu_torch.eval`` on the untrained init, ``python -m
   maed_tpu_torch.train``, then the eval CLI on ``model_best.pth.tar``; the
   trained PA-MPJPE must be below ``--margin`` x the untrained one.
   ``accept_result.json`` holds the JAX tool's keys.

    python -m maed_tpu_torch.tools.accept_synthetic {generate,oracle,train,all} \
        --out DIR [--device cuda|cpu] [--flagship] [--videos 6] [--frames 96] \
        [--size 64] [--seed 0] [--margin 0.7] [--tol_mm 0.1]

It runs on the card unless ``--device cpu`` is given (the CLIs then get
``DEVICE cpu``), and fails when no card is visible. Its numbers, with the
card's name and power limit, are in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import subprocess
import sys
import time

import numpy as np

DATASET = "synacc"
REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
DB_KEYS = ("vid_name", "img_name", "frame_id", "bbox", "joints2D", "joints3D", "pose", "shape")


# --------------------------------------------------------------------------- #
# generation
# --------------------------------------------------------------------------- #

def smooth_pose_tracks(rng, n_frames, n_anchors=6, amp=0.5, orient_amp=0.4):
    """(T, 72) axis-angle tracks: cosine-eased interpolation between random
    anchor poses around the rest pose (the JAX tool's draws, in its order)."""
    anchors = rng.randn(n_anchors, 72).astype(np.float64) * amp
    anchors[:, :3] = rng.randn(n_anchors, 3) * orient_amp
    seg = max(1, n_frames // (n_anchors - 1))
    ts = np.arange(n_frames, dtype=np.float64)
    i0 = np.minimum((ts // seg).astype(int), n_anchors - 2)
    frac = (ts - i0 * seg) / seg
    w = 0.5 - 0.5 * np.cos(np.pi * np.clip(frac, 0, 1))
    pose = (1 - w)[:, None] * anchors[i0] + w[:, None] * anchors[i0 + 1]
    return pose.astype(np.float32)


def joint_palette(n):
    """n distinct BGR colours: the HSV wheel at two value levels, converted
    as cv2.cvtColor(..., COLOR_HSV2BGR) does (``utils.vis.hsv_to_bgr_u8``)."""
    from maed_tpu_torch.utils.vis import hsv_to_bgr_u8

    hsv = np.zeros((1, n, 3), np.uint8)
    hsv[0, :, 0] = (np.arange(n) * 180 // max(n, 1)).astype(np.uint8)
    hsv[0, :, 1] = 255
    hsv[0, :, 2] = np.where(np.arange(n) % 2 == 0, 255, 160).astype(np.uint8)
    return hsv_to_bgr_u8(hsv)[0]


def render_frame(kp_px, depth, size, palette, radius):
    """One (size, size, 3) BGR frame: grey, the joints' filled disks drawn
    far to near (cv2.circle's pixels, ``utils.vis.draw_disk``)."""
    from maed_tpu_torch.utils.vis import draw_disk

    frame = np.full((size, size, 3), 80, np.uint8)
    for j in np.argsort(-depth):  # far to near: the near one wins
        x, y = kp_px[j]
        if -radius <= x < size + radius and -radius <= y < size + radius:
            draw_disk(frame, (int(round(x)), int(round(y))), radius, palette[j].tolist())
    return frame


def generate(out, n_videos=6, frames_per_video=96, size=64, seed=0, val_videos=2,
             flagship=False, device="cuda"):
    """Write synacc_{train,val}_db.pt, the JPEG frames and accept.yaml."""
    import torch

    from maed_tpu_torch.data.dataset import save_db
    from maed_tpu_torch.ops.geometry import weak_perspective_projection
    from maed_tpu_torch.ops.smpl import smpl_forward
    from maed_tpu_torch.utils.image_io import write_jpeg
    from maed_tpu_torch.utils.smpl_io import find_smpl_model

    rng = np.random.RandomState(seed)
    smpl = find_smpl_model(device=device)  # the synthetic body (seed 0) without the files

    img_dir = osp.join(out, "imgs")
    db_dir = osp.join(out, "data", "database")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(db_dir, exist_ok=True)

    palette = joint_palette(49)
    radius = max(2, size // 24)
    dbs = {split: {k: [] for k in DB_KEYS} for split in ("train", "val")}
    for v in range(n_videos + val_videos):
        db = dbs["val" if v >= n_videos else "train"]
        pose = smooth_pose_tracks(rng, frames_per_video)
        with torch.inference_mode():
            pose_t = torch.from_numpy(pose).to(device)
            joints_t = smpl_forward(smpl, torch.zeros(len(pose), 10, device=device),
                                    pose_axis_angle=pose_t)["joints"]   # (T, 49, 3)
            cam = torch.tensor([1.0, 0.0, 0.0], device=device).expand(len(pose), 3)
            kp_norm = weak_perspective_projection(joints_t, cam, img_res=float(size))
        joints, kp_norm = joints_t.cpu().numpy(), kp_norm.cpu().numpy()
        kp_px = (kp_norm + 1.0) * 0.5 * size

        for t in range(frames_per_video):
            frame = render_frame(kp_px[t], joints[t, :, 2], size, palette, radius)
            path = osp.join(img_dir, f"v{v:02d}_{t:04d}.jpg")
            write_jpeg(path, np.ascontiguousarray(frame[..., ::-1]))  # BGR -> RGB
            db["vid_name"].append(f"v{v:02d}")
            db["img_name"].append(path)
            db["frame_id"].append(t)
            db["bbox"].append([size / 2, size / 2, size * 0.8, size * 0.8])
            db["joints2D"].append(np.concatenate([kp_px[t], np.ones((49, 1), np.float32)], 1))
            db["joints3D"].append(np.concatenate([joints[t], np.ones((49, 1), np.float32)], 1))
            db["pose"].append(pose[t])
            db["shape"].append(np.zeros(10, np.float32))

    for split, db in dbs.items():
        db = {k: np.asarray(v) for k, v in db.items()}
        db["vid_name"] = db["vid_name"].astype(str)
        save_db(db, osp.join(db_dir, f"{DATASET}_{split}_db.pt"))
        print(f"[generate] {split}: {len(db['img_name'])} frames "
              f"({n_videos if split == 'train' else val_videos} videos)")

    write_cfg(out, size, flagship=flagship)
    return out


def write_cfg(out, size, flagship=False):
    """accept.yaml: the tiny 1-block, 2-head, 64 px configuration, or with
    ``flagship`` the released model (6 x 768 ste-parallel + KTD, seqlen 16)
    sized for a short run; the JAX tool's keys and values."""
    from maed_tpu_torch.core.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.NUM_WORKERS = 0
    cfg.SEED_VALUE = 0
    cfg.SAVE_FREQ = 2
    cfg.OUTPUT_DIR = osp.join(out, "results")
    cfg.DATASET.WIDTH = cfg.DATASET.HEIGHT = size
    cfg.DATASET.RANDOM_SAMPLE = True
    cfg.DATASET.RANDOM_START = False
    cfg.DATASET.COLOR_JITTER = 0.0
    cfg.DATASET.ERASE_PROB = 0.0
    cfg.DATASET.RANDOM_FLIP = 0.0    # a flip remaps the joint bank: the check is
    cfg.DATASET.ROT_JITTER = 0.0     # about conventions, not augmentation
    cfg.DATASET.SIZE_JITTER = 0.0
    cfg.DATASET.RANDOM_CROP_P = 0.0
    cfg.TRAIN.DATASETS_2D = []
    cfg.TRAIN.DATASETS_3D = [DATASET]
    cfg.TRAIN.DATASETS_IMG = []
    cfg.TRAIN.DATASET_EVAL = DATASET
    cfg.TRAIN.BATCH_SIZE_3D = 4
    cfg.TRAIN.END_EPOCH = 6
    cfg.TRAIN.NUM_ITERS_PER_EPOCH = 50
    cfg.TRAIN.OPTIM.WARMUP_EPOCH = 1
    cfg.TRAIN.OPTIM.MILESTONES = [5]
    cfg.EVAL.BATCH_SIZE = 4
    cfg.EVAL.INTERPOLATION = 1
    if flagship:
        # the released stage-2 model is ste-parallel; the config default is vanilla
        cfg.MODEL.ENCODER.SPA_TEMP_MODE = "parallel"
        cfg.DATASET.SEQLEN = 16
        cfg.DATASET.SAMPLE_POOL = 32
        cfg.EVAL.SEQLEN = 16
        cfg.EVAL.SAMPLE_POOL = 32
        cfg.TRAIN.OPTIM.LR = 1e-4
    else:
        cfg.DATASET.SEQLEN = 4
        cfg.DATASET.SAMPLE_POOL = 8
        cfg.TRAIN.OPTIM.LR = 3e-4
        cfg.MODEL.ENCODER.NUM_BLOCKS = 1
        cfg.MODEL.ENCODER.NUM_HEADS = 2
        cfg.MODEL.DECODER.HIDDEN_DIM = 64
        cfg.EVAL.SEQLEN = 4
        cfg.EVAL.SAMPLE_POOL = 16
    path = osp.join(out, "accept.yaml")
    with open(path, "w") as f:
        f.write(cfg.dump())
    return path


# --------------------------------------------------------------------------- #
# the GT oracle through the whole eval protocol
# --------------------------------------------------------------------------- #

class IndexEncodedLoader:
    """The eval loader with every target kept and 'images' swapped for an
    (N, P, 1, 1, 3) float32 array carrying each frame's DB row, from the
    dataset's chunk table: the Evaluator strides, merges and de-duplicates
    them as it does real frames."""

    def __init__(self, loader, dataset):
        self.loader = loader
        self.dataset = dataset

    def __iter__(self):
        for target in self.loader:
            idx = np.stack([np.asarray(self.dataset.vid_indices[int(i)])
                            for i in np.asarray(target["index"]).reshape(-1)])  # (N, P)
            enc = np.zeros(idx.shape + (1, 1, 3), np.float32)
            enc[..., 0, 0, 0] = idx
            out = dict(target)
            out["images"] = enc
            yield out


def oracle(out, tol_mm=0.1, device="cuda"):
    """GT-perfect predictions through the eval protocol; every metric must
    come out below ``tol_mm``. Returns the metrics (mm)."""
    import torch

    from maed_tpu_torch.core.config import update_cfg
    from maed_tpu_torch.core.evaluate import Evaluator
    from maed_tpu_torch.data.dataset import VideoDataset, load_db
    from maed_tpu_torch.data.loaders import ShardedLoader
    from maed_tpu_torch.data.transforms import build_eval_transforms
    from maed_tpu_torch.models.heads import regressor_output
    from maed_tpu_torch.ops.geometry import rodrigues
    from maed_tpu_torch.utils.smpl_io import find_smpl_model

    cfg = update_cfg(osp.join(out, "accept.yaml"))
    db_dir = osp.join(out, "data", "database")
    smpl = find_smpl_model(device=device)
    db = load_db(DATASET, "val", db_dir)
    dataset = VideoDataset(
        DATASET, "val", build_eval_transforms(cfg.DATASET.WIDTH, cfg.DATASET.HEIGHT),
        seqlen=0, sample_pool=cfg.EVAL.SAMPLE_POOL, overlap=0,
        random_sample=False, random_start=False, db_dir=db_dir)
    loader = ShardedLoader(dataset, cfg.EVAL.BATCH_SIZE, shuffle=False, drop_last=False)

    pose_tab = torch.as_tensor(np.asarray(db["pose"], np.float32), device=device)
    shape_tab = torch.as_tensor(np.asarray(db["shape"], np.float32), device=device)
    cam = torch.tensor([1.0, 0.0, 0.0], device=device)

    def gt_apply(images, J_regressor=None):
        N, T = images.shape[:2]
        idx = images[:, :, 0, 0, 0].long().reshape(-1)
        pose, shape = pose_tab[idx], shape_tab[idx]
        rotmat = rodrigues(pose.reshape(-1, 24, 3))                # (NT, 24, 3, 3)
        pose6d = rotmat[..., :, :2].reshape(N * T, 24 * 6)         # (3, 2) row-major
        outs = regressor_output(smpl, pose6d, shape, cam.expand(N * T, 3),
                                J_regressor=J_regressor)
        return {k: outs[k].reshape(N, T, *outs[k].shape[1:])
                for k in ("theta", "verts", "kp_2d", "kp_3d", "rotmat")}

    with torch.inference_mode():
        eval_dict, num_pred = Evaluator(smpl).run(
            gt_apply, IndexEncodedLoader(loader, dataset), seqlen=cfg.EVAL.SEQLEN,
            interp=cfg.EVAL.INTERPOLATION, dataset_name=DATASET,
            batch_size=cfg.EVAL.BATCH_SIZE)
    print(f"[oracle] {num_pred} poses: {eval_dict}")
    for k in ("mpjpe", "pa-mpjpe", "pve", "accel_err"):
        if not eval_dict[k] < tol_mm:
            raise AssertionError(
                f"GT oracle {k} = {eval_dict[k]:.4f} mm >= {tol_mm} mm: a cross-component "
                "convention (crop camera / pelvis / joint bank / theta slicing / windowing) "
                "is broken")
    print(f"[oracle] PASS: the protocol is self-consistent below {tol_mm} mm")
    return eval_dict


# --------------------------------------------------------------------------- #
# train with the CLIs, eval trained against untrained
# --------------------------------------------------------------------------- #

def run_cli(out, module, args, device="cuda", launcher=None, timeout=3600, logs=None):
    """``python -m <module> --cfg <out>/accept.yaml <args>
    --allow_synthetic_smpl`` in ``out`` (``DEVICE cpu`` appended for the
    CPU); ``launcher`` replaces ``[python, '-m']``. Returns its stdout and
    appends it to ``logs``; raises with its output's tail if it fails."""
    cmd = [*(launcher or [sys.executable, "-m"]), module, "--cfg", osp.join(out, "accept.yaml"),
           *args, "--allow_synthetic_smpl"]
    if device == "cpu":
        cmd += ["DEVICE", "cpu"]
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=out, env=env, capture_output=True, text=True, timeout=timeout)
    print(f"[train] {module} {' '.join(args)}: exit {r.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if logs is not None:
        logs.append(r.stdout)
    if r.returncode != 0:
        raise RuntimeError(f"{module} failed rc={r.returncode}:\n{r.stdout[-2000:]}\n"
                           f"{r.stderr[-4000:]}")
    return r.stdout


def run_eval_cli(out, checkpoint="", **kw):
    """The eval CLI on the val DB; its five metrics (mm) from its output."""
    args = ["--eval_ds", DATASET, "--eval_set", "val"]
    if checkpoint:
        args += ["--checkpoint", checkpoint]
    stdout = run_cli(out, "maed_tpu_torch.eval", args, **kw)
    sys.stdout.write(stdout[-2000:])
    m = {k.lower(): float(v) for k, v in re.findall(r"([A-Z_\-]+): ([0-9.]+),", stdout)}
    if "pa-mpjpe" not in m:
        raise RuntimeError(f"the eval CLI printed no PA-MPJPE:\n{stdout[-2000:]}")
    return m


def train_and_eval(out, margin=0.7, device="cuda", launcher=None, logs=None):
    """Eval untrained, train, eval model_best; trained PA-MPJPE must be
    below ``margin`` x untrained. Writes and returns accept_result.json's
    dict."""
    kw = dict(device=device, launcher=launcher, logs=logs)
    print("[train] evaluating the untrained init ...")
    untrained = run_eval_cli(out, **kw)
    print("[train] python -m maed_tpu_torch.train on the synthetic 3D dataset ...")
    run_cli(out, "maed_tpu_torch.train", [], timeout=7200, **kw)
    results_dir = osp.join(out, "results")
    runs = sorted((osp.join(results_dir, d) for d in os.listdir(results_dir)),
                  key=os.path.getmtime)
    best = osp.join(runs[-1], "model_best.pth.tar")
    if not osp.isfile(best):
        raise RuntimeError(f"the train CLI wrote no model_best.pth.tar under {runs[-1]}")
    print("[train] evaluating the trained model_best ...")
    trained = run_eval_cli(out, checkpoint=best, **kw)

    result = {"untrained": untrained, "trained": trained, "margin": margin,
              "pass": trained["pa-mpjpe"] < untrained["pa-mpjpe"] * margin}
    with open(osp.join(out, "accept_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(f"[train] untrained PA-MPJPE {untrained['pa-mpjpe']:.2f} mm -> trained "
          f"{trained['pa-mpjpe']:.2f} mm ({'PASS' if result['pass'] else 'FAIL'} at {margin}x)")
    if not result["pass"]:
        raise AssertionError(f"trained PA-MPJPE {trained['pa-mpjpe']:.2f} did not beat "
                             f"{margin}x untrained {untrained['pa-mpjpe']:.2f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phase", choices=["generate", "oracle", "train", "all"])
    ap.add_argument("--out", default="synacc")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--videos", type=int, default=6)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--margin", type=float, default=0.7)
    ap.add_argument("--tol_mm", type=float, default=0.1)
    ap.add_argument("--flagship", action="store_true",
                    help="accept.yaml holds the released model (6 x 768 ste-parallel + KTD, "
                         "seqlen 16); pair with --size 224")
    args = ap.parse_args(argv)

    import torch

    from maed_tpu_torch.utils.timing import card_identity

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("accept_synthetic: no CUDA device (pass --device cpu to run on "
                             "the CPU)")
        print(f"[accept] card: {card_identity()}")
    out = osp.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    if args.phase in ("generate", "all"):
        generate(out, n_videos=args.videos, frames_per_video=args.frames, size=args.size,
                 seed=args.seed, flagship=args.flagship, device=args.device)
    if args.phase in ("oracle", "all"):
        oracle(out, tol_mm=args.tol_mm, device=args.device)
    if args.phase in ("train", "all"):
        train_and_eval(out, margin=args.margin, device=args.device)
    print(f"[accept] {args.phase} done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
