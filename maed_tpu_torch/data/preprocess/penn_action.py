"""PennAction preprocessor: .mat labels -> DB.

    python -m maed_tpu_torch.data.preprocess.penn_action --inp_dir data/penn_action \
        --out_dir data/database

Port of ``maed_tpu/data/preprocess/penn_action.py`` (``scipy.io.loadmat``
and numpy, unchanged): 13 joints -> the 14-slot common layout with the
headtop moved to slot 13, square bboxes from the visible keypoints' bounds.
The DB is written with joblib where it is installed, else as a plain pickle.
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np

from maed_tpu_torch.data.keypoints import convert_kps, get_perm_idxs


def kp_bound_bbox(kp: np.ndarray) -> np.ndarray:
    """Square bbox (cx, cy, w, h) around visible keypoints of one frame."""
    vis = kp[:, 2] > 0
    if not vis.any():
        return np.zeros(4)
    x, y = kp[vis, 0], kp[vis, 1]
    l, r, u, d = x.min(), x.max(), y.min(), y.max()
    w, h = r - l, d - u
    side = w if h == 0 or w / max(h, 1e-6) > 1 else h
    return np.array([(l + r) * 0.5, (u + d) * 0.5, side, side])


def read_data(folder: str):
    from scipy.io import loadmat

    dataset = {"img_name": [], "joints2D": [], "bbox": [], "vid_name": []}
    perm_idxs = get_perm_idxs("pennaction", "common")

    for fname in sorted(glob.glob(osp.join(folder, "labels", "*.mat"))):
        mat = loadmat(fname)
        nframes = int(mat["nframes"][0][0])
        imgs = sorted(glob.glob(
            osp.join(folder, "frames", osp.basename(fname).split(".")[0], "*.jpg")
        ))

        kp = np.zeros((nframes, 13, 3))
        kp[:, :, 0] = mat["x"]
        kp[:, :, 1] = mat["y"]
        kp[:, :, 2] = mat["visibility"]
        kp = kp[:, perm_idxs, :]

        # 13 -> 14-slot common layout: headtop moves from slot 12 to slot 13,
        # slot 12 (neck) stays empty
        kp14 = np.zeros((nframes, 14, 3))
        kp14[:, :12] = kp[:, :-1]
        kp14[:, 13] = kp[:, 12]

        bbox = np.stack([kp_bound_bbox(fr) for fr in kp14])

        dataset["vid_name"].append(np.array([fname] * nframes))
        dataset["img_name"].append(np.array(imgs))
        dataset["joints2D"].append(kp14)
        dataset["bbox"].append(bbox)

    for k in dataset:
        dataset[k] = np.concatenate(dataset[k])
    dataset["joints2D"] = convert_kps(dataset["joints2D"], src="common", dst="spin")
    return dataset


def main(argv=None):
    from maed_tpu_torch.core import config as cfg_mod
    from maed_tpu_torch.data.dataset import save_db

    parser = argparse.ArgumentParser()
    parser.add_argument("--inp_dir", type=str, default=cfg_mod.PENNACTION_DIR)
    parser.add_argument("--out_dir", type=str, default=cfg_mod.DB_DIR)
    args = parser.parse_args(argv)

    db = read_data(args.inp_dir)
    save_db(db, osp.join(args.out_dir, "pennaction_train_db.pt"))
    print(f"wrote pennaction_train_db.pt: {len(db['img_name'])} frames")


if __name__ == "__main__":
    main()
