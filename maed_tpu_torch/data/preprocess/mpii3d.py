"""MPI-INF-3DHP preprocessor: annot.mat (train) / annot_data.mat (test) ->
DBs.

    python -m maed_tpu_torch.data.preprocess.mpii3d --inp_dir data/mpi_inf_3dhp \
        --out_dir data/database [--test]

Port of ``maed_tpu/data/preprocess/mpii3d.py`` (numpy, unchanged): the
28-joint train and 17-joint test annotations to the spin 49 format, root
centred at joint 39, bboxes from the 2D keypoints' bounds, tracks split
where a keypoint leaves the frame, the valid mask over J14 + hip, spine and
head. ``scipy.io`` and ``h5py`` are imported in the functions that read
``.mat`` files (``h5py`` for the test set's v7.3 files: where it is absent
:func:`read_test_data` raises and names it). A test frame's size comes from
its JPEG header (``utils/image_io.py``), where the JAX package decodes the
whole frame with cv2. The DBs are written with joblib where it is
installed, else as plain pickles.
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp

import numpy as np

from maed_tpu_torch.data.keypoints import convert_kps


def bbox_from_kp2d(kp_2d: np.ndarray) -> np.ndarray:
    """Square 1.1x bbox (cx, cy, w, h) around nonzero keypoints."""
    pts = kp_2d[~np.all(kp_2d == 0, axis=1)]
    ul = pts[:, :2].min(axis=0)
    lr = pts[:, :2].max(axis=0)
    w, h = lr - ul
    c = ul + np.array([w, h]) / 2
    side = (w if h == 0 or w / max(h, 1e-9) > 1 else h) * 1.1
    return np.array([c[0], c[1], side, side])


def _valid_mask(n: int) -> np.ndarray:
    valid = np.zeros([n, 49, 1])
    valid[:, 25:39, :] = 1
    valid[:, (39, 41, 43), :] = 1
    return valid


def read_data_train(dataset_path, user_list, seq_list, vid_list):
    import scipy.io as sio

    h = w = 2048
    dataset = {k: [] for k in (
        "vid_name", "frame_id", "joints3D", "joints2D", "bbox", "img_name",
    )}

    for user_i in user_list:
        for seq_i in seq_list:
            seq_path = osp.join(dataset_path, f"S{user_i}", f"Seq{seq_i}")
            annot_file = osp.join(seq_path, "annot.mat")
            annot2 = sio.loadmat(annot_file)["annot2"]
            annot3 = sio.loadmat(annot_file)["annot3"]
            for vid_i in vid_list:
                imgs_path = osp.join(seq_path, f"video_{vid_i}")
                if not os.path.isdir(imgs_path):
                    continue
                img_list = sorted(glob.glob(osp.join(imgs_path, "*.jpg")))
                vid_uniq_id = f"subj{user_i}_seq{seq_i}_vid{vid_i}_seg0"
                for i, img_i in enumerate(img_list):
                    j2d_raw = np.reshape(annot2[vid_i][0][i], (1, 28, 2))
                    j2d_raw = np.append(j2d_raw, np.ones((1, 28, 1)), axis=2)
                    j2d = convert_kps(j2d_raw, "mpii3d", "spin").reshape(-1, 3)

                    j3d_raw = np.reshape(annot3[vid_i][0][i], (1, 28, 3)) / 1000
                    j3d = convert_kps(j3d_raw, "mpii3d", "spin").reshape(-1, 3)
                    j3d = j3d - j3d[39]  # root-center at the pelvis slot

                    ok = (
                        (j2d[:, 0] >= 0) & (j2d[:, 0] < w)
                        & (j2d[:, 1] >= 0) & (j2d[:, 1] < h)
                    )
                    if ok.sum() < j2d.shape[0]:
                        # out-of-frame joints break the track into a new segment
                        last = int(dataset["vid_name"][-1].split("_")[-1][3:]) if dataset["vid_name"] else 0
                        vid_uniq_id = "_".join(vid_uniq_id.split("_")[:-1]) + f"_seg{last + 1}"
                        continue

                    dataset["vid_name"].append(vid_uniq_id)
                    dataset["frame_id"].append(osp.basename(img_i).split(".")[0])
                    dataset["img_name"].append(img_i)
                    dataset["joints2D"].append(j2d)
                    dataset["joints3D"].append(j3d)
                    dataset["bbox"].append(bbox_from_kp2d(j2d))

    for k in dataset:
        dataset[k] = np.array(dataset[k])
    dataset["joints3D"] = np.concatenate(
        [dataset["joints3D"], _valid_mask(len(dataset["joints3D"]))], axis=-1
    )
    return dataset


def read_test_data(dataset_path):
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("read_test_data reads MPI-INF-3DHP's v7.3 annot_data.mat files "
                           "with h5py, which is not installed") from e

    from maed_tpu_torch.utils.image_io import image_size

    dataset = {k: [] for k in (
        "vid_name", "frame_id", "joints3D", "joints2D", "bbox", "img_name",
        "valid_i",
    )}

    for user_i in range(1, 7):
        seq_path = osp.join(dataset_path, "mpi_inf_3dhp_test_set", f"TS{user_i}")
        with h5py.File(osp.join(seq_path, "annot_data.mat"), "r") as m:
            annot2 = np.array(m["annot2"])
            annot3 = np.array(m["univ_annot3"])
            valid = np.array(m["valid_frame"])

        vid_uniq_id = f"subj{user_i}_seg0"
        for frame_i, valid_i in enumerate(valid):
            img_i = osp.join(
                "mpi_inf_3dhp_test_set", f"TS{user_i}", "imageSequence",
                f"img_{frame_i + 1:06d}.jpg",
            )
            j2d_raw = np.append(
                annot2[frame_i, 0][None], np.ones((1, 17, 1)), axis=2
            )
            j2d = convert_kps(j2d_raw, "mpii3d_test", "spin").reshape(-1, 3)
            j3d = convert_kps(
                np.reshape(annot3[frame_i, 0], (1, 17, 3)) / 1000,
                "mpii3d_test", "spin",
            ).reshape(-1, 3)
            j3d = j3d - j3d[39]

            img_file = osp.join(dataset_path, img_i)
            if not osp.isfile(img_file):
                continue
            h, w = image_size(img_file)
            ok = (
                (j2d[:, 0] >= 0) & (j2d[:, 0] < w)
                & (j2d[:, 1] >= 0) & (j2d[:, 1] < h)
            )
            if ok.sum() < j2d.shape[0]:
                last = int(dataset["vid_name"][-1].split("_")[-1][3:]) if dataset["vid_name"] else 0
                vid_uniq_id = "_".join(vid_uniq_id.split("_")[:-1]) + f"_seg{last + 1}"
                continue

            dataset["vid_name"].append(vid_uniq_id)
            dataset["frame_id"].append(osp.basename(img_file).split(".")[0])
            dataset["img_name"].append(img_file)
            dataset["joints2D"].append(j2d)
            dataset["joints3D"].append(j3d)
            dataset["bbox"].append(bbox_from_kp2d(j2d))
            dataset["valid_i"].append(valid_i)

    for k in dataset:
        dataset[k] = np.array(dataset[k])
    dataset["joints3D"] = np.concatenate(
        [dataset["joints3D"], _valid_mask(len(dataset["joints3D"]))], axis=-1
    )
    return dataset


def main(argv=None):
    from maed_tpu_torch.core import config as cfg_mod
    from maed_tpu_torch.data.dataset import save_db

    parser = argparse.ArgumentParser()
    parser.add_argument("--inp_dir", type=str, default=cfg_mod.MPII3D_DIR)
    parser.add_argument("--out_dir", type=str, default=cfg_mod.DB_DIR)
    parser.add_argument("--sub", nargs="+", type=int, default=[1, 2, 3, 4, 5, 6, 7, 8])
    parser.add_argument("--seq", nargs="+", type=int, default=[1, 2])
    parser.add_argument("--vid", nargs="+", type=int, default=list(range(9)))
    parser.add_argument("--test", action="store_true", help="build the test DB too")
    args = parser.parse_args(argv)

    db = read_data_train(args.inp_dir, args.sub, args.seq, args.vid)
    save_db(db, osp.join(args.out_dir, "mpii3d_train_db.pt"))
    print(f"wrote mpii3d_train_db.pt: {len(db['img_name'])} frames")
    if args.test:
        db = read_test_data(args.inp_dir)
        save_db(db, osp.join(args.out_dir, "mpii3d_val_db.pt"))
        print(f"wrote mpii3d_val_db.pt: {len(db['img_name'])} frames")


if __name__ == "__main__":
    main()
