"""PoseTrack preprocessor: per-track annotation json -> DB.

    python -m maed_tpu_torch.data.preprocess.posetrack --inp_dir data/posetrack \
        --out_dir data/database

Port of ``maed_tpu/data/preprocess/posetrack.py`` (json and numpy,
unchanged): per-person tracks with >= 8 annotated frames, 0.8x square
bboxes, keypoints to the spin 49 format. The DB is written with joblib
where it is installed, else as a plain pickle.
"""

from __future__ import annotations

import argparse
import glob
import json
import os.path as osp

import numpy as np

from maed_tpu_torch.data.keypoints import convert_kps

POSETRACK_ORIGINAL_NAMES = [
    "nose", "head_bottom", "head_top", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

MIN_FRAMES = 8


def read_data(folder: str, set_name: str):
    dataset = {"img_name": [], "joints2D": [], "bbox": [], "vid_name": []}

    files = sorted(glob.glob(
        osp.join(folder, "posetrack_data/annotations", set_name, "*.json")
    ))
    for fname in files:
        with open(fname) as f:
            anns = json.load(f)
        images = [im for im in anns["images"] if im["is_labeled"]]
        frame2img = {im["frame_id"]: im["file_name"] for im in images}

        cat_kp_names = anns["categories"][0]["keypoints"]
        idxs = [cat_kp_names.index(n) for n in POSETRACK_ORIGINAL_NAMES
                if n in cat_kp_names]

        track_ids = sorted({a["track_id"] for a in anns["annotations"]})
        for p_id in track_ids:
            rows = []
            for a in anns["annotations"]:
                if a["track_id"] != p_id:
                    continue
                kps = np.asarray(a["keypoints"], np.float64).reshape(17, 3)[idxs]
                if np.count_nonzero(kps) == 0:
                    continue
                bb = list(a["bbox"])
                if bb[2] == 0 or bb[3] == 0 or a["image_id"] not in frame2img:
                    continue
                # visibility := 1 everywhere except exactly-zero locations
                kps[:, 2] = 1.0
                kps[(kps[:, 0] == 0) & (kps[:, 1] == 0), 2] = 0.0
                # tlwh -> square (cx, cy, side*0.8)
                cx, cy = bb[0] + bb[2] / 2, bb[1] + bb[3] / 2
                side = (bb[2] if bb[3] == 0 or bb[2] / max(bb[3], 1e-6) > 1 else bb[3]) * 0.8
                rows.append((kps, np.array([cx, cy, side, side]),
                             osp.join(folder, frame2img[a["image_id"]])))
            if len(rows) < MIN_FRAMES:
                continue
            kp_2d = np.stack([r[0] for r in rows])
            bbox = np.stack([r[1] for r in rows])
            paths = np.array([r[2] for r in rows])

            dataset["vid_name"].append(np.array([f"{fname}_{p_id}"] * len(rows)))
            dataset["img_name"].append(paths)
            dataset["joints2D"].append(convert_kps(kp_2d, src="posetrack", dst="spin"))
            dataset["bbox"].append(bbox)

    for k in dataset:
        dataset[k] = np.concatenate(dataset[k])
    return dataset


def main(argv=None):
    from maed_tpu_torch.core import config as cfg_mod
    from maed_tpu_torch.data.dataset import save_db

    parser = argparse.ArgumentParser()
    parser.add_argument("--inp_dir", type=str, default=cfg_mod.POSETRACK_DIR)
    parser.add_argument("--out_dir", type=str, default=cfg_mod.DB_DIR)
    args = parser.parse_args(argv)

    db = read_data(args.inp_dir, "train")
    save_db(db, osp.join(args.out_dir, "posetrack_train_db.pt"))
    print(f"wrote posetrack_train_db.pt: {len(db['img_name'])} frames")


if __name__ == "__main__":
    main()
