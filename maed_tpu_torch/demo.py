"""In-the-wild demo of the port: a video (or a folder of JPEG frames) ->
per-frame SMPL predictions -> rendered overlays, on the card.

    python -m maed_tpu_torch.demo --image_folder frames/ \
        --cfg configs/config_stage2.yaml --checkpoint ckpt.pth.tar \
        --bbox_file boxes.npy --output_folder demo_out --render

Port of the JAX package's ``demo.py``. The model is the config's, built by
``core.builder.build_eval_model`` in f32 (the eval protocol's dtype) with
the checkpoint's weights (the port's ``.pth.tar`` or the reference-layout
export of a JAX run; seeded random weights without one), and runs on the
card unless the config says ``DEVICE cpu``. The frames go through the
port's ``VideoDataset`` / ``ShardedLoader`` and the windowed
``Evaluator.inference``, which writes ``<output_folder>/inference.pkl`` in
the schema ``python -m maed_tpu_torch.visualize`` reads; ``--render`` does
that here, into ``<output_folder>/overlay`` (and an mp4 where ffmpeg is).

Person localization, in priority order:
  --bbox_file     per-frame (cx, cy, w, h) boxes, .npy (N, 4)
  --staf_dir      run the OpenPose STAF tracker (utils/pose_tracker.py) and
                  smooth its keypoint track into boxes (utils/smooth_bbox.py)
  (default)       a centered square box per frame

The port decodes JPEG frames only: an ``--image_folder`` that holds other
frames is refused at start-up, and ``--vid_file`` is cut into JPEG frames
by ffmpeg.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import time

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def collect_frames(args) -> list:
    """The frames' paths, in order; every one a JPEG."""
    from maed_tpu_torch.utils.image_io import JPEG_RULE, is_jpeg

    if args.image_folder:
        paths = sorted(
            osp.join(args.image_folder, n) for n in os.listdir(args.image_folder)
            if n.lower().endswith(IMG_EXTS)
        )
        if not paths:
            raise SystemExit(f"no images found in {args.image_folder}")
        others = [p for p in paths if not is_jpeg(p)]
        if others:
            raise SystemExit(f"{len(others)} of the {len(paths)} frames in {args.image_folder} "
                             f"are not JPEG ({others[0]}, ...): {JPEG_RULE}")
        return paths
    from maed_tpu_torch.utils.demo_utils import video_to_images

    frames_dir = osp.join(args.output_folder, "frames")
    if osp.isdir(frames_dir):  # stale frames from a previous (longer) run
        shutil.rmtree(frames_dir)
    folder = video_to_images(args.vid_file, frames_dir)
    return sorted(osp.join(folder, n) for n in os.listdir(folder))


def resolve_bboxes(args, paths) -> np.ndarray:
    if args.bbox_file:
        bboxes = np.asarray(np.load(args.bbox_file), np.float32)
        if bboxes.shape != (len(paths), 4):
            raise SystemExit(
                f"--bbox_file shape {bboxes.shape} != ({len(paths)}, 4)")
        return bboxes
    if args.staf_dir:
        if not args.vid_file:
            raise SystemExit("--staf_dir tracking needs --vid_file "
                             "(the tracker consumes the video directly)")
        from maed_tpu_torch.utils.pose_tracker import run_posetracker
        from maed_tpu_torch.utils.smooth_bbox import get_all_bbox_params, smooth_bbox_params

        tracks = run_posetracker(args.vid_file, args.staf_dir, display=False)
        if not tracks:
            raise SystemExit("pose tracker found no people")
        # largest track -> smoothed square boxes, placed by the track's
        # VIDEO frame ids (detections can start late / have gaps)
        pid = max(tracks, key=lambda p: len(tracks[p]["frames"]))
        frames = np.asarray(tracks[pid]["frames"])
        bbox_params, start, end = get_all_bbox_params(
            tracks[pid]["joints2d"], vis_thresh=0.3)
        if end <= start:
            raise SystemExit("pose track has no frames with >=2 confident "
                             "keypoints — supply --bbox_file instead")
        bbox_params = smooth_bbox_params(bbox_params)
        boxes = np.zeros((len(paths), 4), np.float32)
        have = np.zeros(len(paths), bool)
        for r in range(start, end):  # row r detects video frame frames[r]
            f = int(frames[r])
            if 0 <= f < len(paths):
                cx, cy, size = bbox_params[r - start]
                boxes[f] = (cx, cy, size, size)
                have[f] = True
        if not have.any():
            raise SystemExit("pose track frames lie outside the video")
        tracked = np.where(have)[0]
        for i in np.where(~have)[0]:  # nearest tracked box for gaps/edges
            boxes[i] = boxes[tracked[np.abs(tracked - i).argmin()]]
        return boxes
    # centered square fallback, its size from the first frame's header
    from maed_tpu_torch.utils.image_io import image_size

    h, w = image_size(paths[0])
    side = min(h, w)
    box = np.array([w / 2.0, h / 2.0, side, side], np.float32)
    return np.tile(box, (len(paths), 1))


def infer(model, smpl, cfg, paths, bboxes, plain: bool = False):
    """The demo's windowed inference of ``model`` over the frames at
    ``paths`` with their boxes: an ``Evaluator`` holding the predictions.
    ``plain`` runs the model through the kernels' plain versions."""
    from maed_tpu_torch.core.evaluate import Evaluator
    from maed_tpu_torch.data.dataset import VideoDataset
    from maed_tpu_torch.data.loaders import ShardedLoader
    from maed_tpu_torch.data.transforms import build_eval_transforms
    from maed_tpu_torch.ops.image import apply_device_preproc

    d = cfg.DATASET
    db = {
        "vid_name": np.array(["demo"] * len(paths)),
        "img_name": np.array(paths),
        "frame_id": np.arange(len(paths)),
        "bbox": bboxes,
    }
    dataset = VideoDataset(
        "demo", "test",
        # single-video footage has uniform frame sizes: the DEVICE_CROP pack
        # (raw frames and their affines, cropped on the card) applies cleanly
        build_eval_transforms(d.WIDTH, d.HEIGHT, device_normalize=bool(d.DEVICE_PREPROC),
                              device_crop=bool(d.DEVICE_CROP)),
        seqlen=0, sample_pool=cfg.EVAL.SAMPLE_POOL, overlap=0,
        random_sample=False, random_start=False, db=db, verbose=False,
    )
    loader = ShardedLoader(dataset, cfg.EVAL.BATCH_SIZE, shuffle=False, drop_last=False)

    def forward(images, J_regressor=None):
        images = apply_device_preproc(images, d.HEIGHT, d.WIDTH)
        return model(images, smpl, J_regressor=J_regressor, plain=plain)

    evaluator = Evaluator(smpl)
    evaluator.inference(
        forward, loader, seqlen=cfg.EVAL.SEQLEN, interp=cfg.EVAL.INTERPOLATION,
        dataset_name="demo", batch_size=cfg.EVAL.BATCH_SIZE,
        allow_missing_regressor=True,  # 'demo' has no eval protocol
    )
    return evaluator


def main(argv=None):
    # the heavy imports inside main: loader workers started from a
    # forkserver import the main module
    import torch

    from maed_tpu_torch.core.builder import (build_eval_model, configure_backends, device_of,
                                             load_weights, model_config)
    from maed_tpu_torch.core.config import get_cfg_defaults, update_cfg

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--vid_file", default="")
    src.add_argument("--image_folder", default="")
    ap.add_argument("--cfg", default="")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--bbox_file", default="",
                    help=".npy of per-frame (cx, cy, w, h) person boxes")
    ap.add_argument("--staf_dir", default="",
                    help="OpenPose STAF build dir for automatic tracking")
    ap.add_argument("--output_folder", default="demo_output")
    ap.add_argument("--render", action="store_true",
                    help="render mesh overlays (+ mp4 when ffmpeg exists)")
    ap.add_argument("--alpha", type=float, default=0.8)
    ap.add_argument("--allow_synthetic_smpl", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.output_folder, exist_ok=True)
    paths = collect_frames(args)
    bboxes = resolve_bboxes(args, paths)
    print(f"{len(paths)} frames")

    cfg = update_cfg(args.cfg) if args.cfg else get_cfg_defaults()
    device = device_of(cfg)
    configure_backends(cfg)
    model, smpl = build_eval_model(
        **model_config(cfg), dtype=torch.float32, device=device,
        state_dict=load_weights(args.checkpoint) if args.checkpoint else None,
        allow_synthetic_smpl=args.allow_synthetic_smpl)

    t0 = time.perf_counter()
    evaluator = infer(model, smpl, cfg, paths, bboxes)
    seconds = time.perf_counter() - t0
    print(f"inference: {len(paths)} frames in {seconds:.3f} s "
          f"({len(paths) / seconds:.2f} frames/s, decode and crop included)")
    evaluator.save_result(args.output_folder)
    print(f"wrote {osp.join(args.output_folder, 'inference.pkl')}")

    if args.render:
        from maed_tpu_torch.utils.demo_utils import images_to_video
        from maed_tpu_torch.visualize import render_inference_pkl

        frames_dir = osp.join(args.output_folder, "overlay")
        render_inference_pkl(
            osp.join(args.output_folder, "inference.pkl"), frames_dir,
            alpha=args.alpha, allow_synthetic_smpl=args.allow_synthetic_smpl,
        )
        if shutil.which("ffmpeg") is not None:
            # rendered names aren't a %06d sequence: re-sequence for the muxer
            seq = osp.join(args.output_folder, "overlay_seq")
            if osp.isdir(seq):
                shutil.rmtree(seq)
            os.makedirs(seq)
            for i, n in enumerate(sorted(os.listdir(frames_dir)), start=1):
                shutil.copy(osp.join(frames_dir, n), osp.join(seq, f"{i:06d}.png"))
            out_vid = osp.join(args.output_folder, "demo_overlay.mp4")
            images_to_video(seq, out_vid, pattern="%06d.png")
            print(f"wrote {out_vid}")
        else:
            print("ffmpeg not available — overlay frames only")


if __name__ == "__main__":
    main()
