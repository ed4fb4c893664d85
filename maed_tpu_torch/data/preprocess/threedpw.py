"""3DPW preprocessor: sequenceFiles pkl -> DBs (train / validation / test).

    python -m maed_tpu_torch.data.preprocess.threedpw --inp_dir data/3dpw \
        --out_dir data/database [--allow_synthetic_smpl] [--device cpu]

Port of ``maed_tpu/data/preprocess/threedpw.py``: each frame's global orient
is rotated into the camera's frame (Rc @ R, in f32 without TF32), the GT 3D
joints come from the SMPL forward of each person's whole sequence on the
card, through the skinning kernel (the H36M J14 regressor's joints for the
test and validation sets where ``J_regressor_h36m.npy`` is found, its
product on the card too), the boxes from median and gaussian smoothed 2D
pose tracks; frames with 6 or fewer visible keypoints are dropped and the
keypoints converted to the 49-joint spin format. The DBs are written with
joblib where it is installed, else as plain pickles.

Unlike the JAX package, which falls back to the synthetic body with a
warning and writes meaningless ``joints3D``, this refuses to run without the
SMPL files unless ``--allow_synthetic_smpl`` is given, as the port's eval
and demo CLIs do.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle
import time

import numpy as np
import torch

VIS_THRESH = 0.3
MIN_KP = 6
# frames a SMPL forward: a 3DPW sequence (up to ~1900 frames) in one, its
# vertices ~160 MB in f32
FRAMES_A_FORWARD = 2048


def align_global_orient_to_camera(pose_aa: np.ndarray, cam_poses: np.ndarray,
                                  device: torch.device | str = "cpu") -> np.ndarray:
    """Rotate each frame's global orient into the camera frame: R <- Rc @ R,
    in f32 on ``device``. The 3x3 product is summed elementwise, so TF32
    never rounds it."""
    from maed_tpu_torch.ops.geometry import rodrigues, rotmat_to_aa

    R = rodrigues(torch.as_tensor(np.asarray(pose_aa)[:, :3], dtype=torch.float32, device=device))
    Rc = torch.as_tensor(np.asarray(cam_poses)[:, :3, :3], dtype=torch.float32, device=device)
    Rs = (Rc[:, :, :, None] * R[:, None, :, :]).sum(dim=2)
    out = np.array(pose_aa, np.float32, copy=True)
    out[:, :3] = rotmat_to_aa(Rs).cpu().numpy()
    return out


def bbox_from_smooth_track(j2d: np.ndarray):
    """Square 1.1x bboxes from smoothed keypoint tracks; returns
    (bbox (T', 4), start, end)."""
    from maed_tpu_torch.utils.smooth_bbox import get_all_bbox_params, smooth_bbox_params

    params, t0, t1 = get_all_bbox_params(j2d, vis_thresh=VIS_THRESH)
    params = smooth_bbox_params(params, sigma=8.0)
    if len(params) == 0:
        return np.zeros((0, 4)), t0, t1
    # params[:, 2] stores the square side (see smooth_bbox); 1.1x margin
    side = params[:, 2] * 1.1
    bbox = np.stack([params[:, 0], params[:, 1], side, side], axis=1)
    return bbox, t0, t1


def sequence_joints(smpl_model, shape: np.ndarray, pose: np.ndarray, J_regressor=None,
                    plain: bool = False) -> np.ndarray:
    """The 3D joints of a person's sequence on the body's device, in chunks
    of FRAMES_A_FORWARD frames: the 49-joint bank, or with ``J_regressor``
    (17, V) the H36M J14 joints of the vertices. ``plain`` takes the
    skinning's plain version."""
    from maed_tpu_torch.ops.joints import H36M_TO_J14
    from maed_tpu_torch.ops.smpl import smpl_forward

    device = smpl_model.v_template.device
    out = []
    for s in range(0, len(pose), FRAMES_A_FORWARD):
        chunk = slice(s, s + FRAMES_A_FORWARD)
        betas = torch.as_tensor(shape[chunk], dtype=torch.float32, device=device)
        theta = torch.as_tensor(pose[chunk], dtype=torch.float32, device=device)
        res = smpl_forward(smpl_model, betas, pose_axis_angle=theta, plain=plain)
        if J_regressor is not None:
            j3d = torch.einsum("jv,tvk->tjk", J_regressor, res["vertices"])[:, H36M_TO_J14]
        else:
            j3d = res["joints"]
        out.append(j3d.cpu().numpy())
    return np.concatenate(out)


def read_data(folder: str, set_name: str, smpl_model=None, data_dir: str = "data/smpl_data",
              plain: bool = False):
    """The DB of one 3DPW split. The body is ``smpl_model``, or the SMPL
    files of ``data_dir`` on the card; every computation runs on the body's
    device. ``plain`` takes the skinning's plain version."""
    from maed_tpu_torch.data.keypoints import convert_kps, get_perm_idxs
    from maed_tpu_torch.utils.smpl_io import find_smpl_model

    if smpl_model is None:
        smpl_model = find_smpl_model(data_dir, allow_synthetic=False)
    device = smpl_model.v_template.device
    J_regressor = None
    if set_name in ("test", "validation"):
        jr_path = osp.join(data_dir, "J_regressor_h36m.npy")
        if osp.isfile(jr_path):
            J_regressor = torch.as_tensor(np.load(jr_path), dtype=torch.float32, device=device)

    dataset = {k: [] for k in (
        "vid_name", "frame_id", "joints3D", "joints2D", "shape", "pose",
        "bbox", "img_name", "valid",
    )}

    seq_dir = osp.join(folder, "sequenceFiles", set_name)
    sequences = sorted(x.split(".")[0] for x in os.listdir(seq_dir))

    for seq in sequences:
        with open(osp.join(seq_dir, seq + ".pkl"), "rb") as f:
            data = pickle.load(f, encoding="latin1")
        img_dir = osp.join(folder, "imageFiles", seq)
        num_people = len(data["poses"])
        num_frames = len(data["img_frame_ids"])

        for p_id in range(num_people):
            pose = np.asarray(data["poses"][p_id], np.float32)
            shape = np.tile(np.asarray(data["betas"][p_id][:10], np.float32), (len(pose), 1))
            j2d = np.asarray(data["poses2d"][p_id]).transpose(0, 2, 1)
            campose_valid = np.asarray(data["campose_valid"][p_id])

            pose = align_global_orient_to_camera(pose, np.asarray(data["cam_poses"]), device)
            j3d = sequence_joints(smpl_model, shape, pose, J_regressor, plain=plain)

            bbox, t0, t1 = bbox_from_smooth_track(j2d)
            if t1 <= t0:
                continue

            j2d[:, :, 2] = (j2d[:, :, 2] > VIS_THRESH).astype(np.float32)
            perm = get_perm_idxs("3dpw", "common") + [0, 0]  # no neck/headtop
            j2d = j2d[:, perm]
            j2d[:, 12:, 2] = 0.0

            img_paths = np.array(
                [osp.join(img_dir, f"image_{i:05d}.jpg") for i in range(num_frames)]
            )
            sl = slice(t0, t1)
            dataset["vid_name"].append(np.array([f"{seq}_{p_id}"] * num_frames)[sl])
            dataset["frame_id"].append(np.arange(num_frames)[sl])
            dataset["img_name"].append(img_paths[sl])
            dataset["joints3D"].append(j3d[sl])
            dataset["joints2D"].append(j2d[sl])
            dataset["shape"].append(shape[sl])
            dataset["pose"].append(pose[sl])
            dataset["bbox"].append(bbox)
            dataset["valid"].append(campose_valid[sl])

    for k in dataset:
        dataset[k] = np.concatenate(dataset[k])

    keep = np.where((dataset["joints2D"][:, :, 2] > VIS_THRESH).sum(-1) > MIN_KP)[0]
    for k in dataset:
        dataset[k] = dataset[k][keep]

    dataset["joints2D"] = convert_kps(dataset["joints2D"], src="common", dst="spin")
    valid = np.zeros([len(dataset["joints3D"]), 49, 1])
    valid[:, 25:39, :] = 1
    if set_name != "train":
        dataset["joints3D"] = convert_kps(dataset["joints3D"], src="common", dst="spin")
    dataset["joints3D"] = np.concatenate([dataset["joints3D"], valid], axis=-1)
    return dataset


def main(argv=None):
    from types import SimpleNamespace

    from maed_tpu_torch.core import config as cfg_mod
    from maed_tpu_torch.core.builder import device_of
    from maed_tpu_torch.data.dataset import save_db
    from maed_tpu_torch.utils.smpl_io import find_smpl_model

    parser = argparse.ArgumentParser()
    parser.add_argument("--inp_dir", type=str, default=cfg_mod.THREEDPW_DIR)
    parser.add_argument("--out_dir", type=str, default=cfg_mod.DB_DIR)
    parser.add_argument("--smpl_dir", type=str, default=cfg_mod.DATA_DIR)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (the default: the card, which must be present) or 'cpu'")
    parser.add_argument("--allow_synthetic_smpl", action="store_true",
                        help="build the DBs with a RANDOM body model when the SMPL files are "
                        "missing (smoke runs only: every joints3D is meaningless)")
    args = parser.parse_args(argv)

    device = device_of(SimpleNamespace(DEVICE=args.device))
    torch.backends.cuda.matmul.allow_tf32 = False  # the joints are f32 arithmetic
    smpl = find_smpl_model(args.smpl_dir, allow_synthetic=args.allow_synthetic_smpl,
                           device=device)
    os.makedirs(args.out_dir, exist_ok=True)
    for set_name, out_name in (
        ("validation", "3dpw_val_db.pt"),
        ("train", "3dpw_train_db.pt"),
        ("test", "3dpw_test_db.pt"),
    ):
        t0 = time.perf_counter()
        db = read_data(args.inp_dir, set_name, smpl, data_dir=args.smpl_dir)
        seconds = time.perf_counter() - t0
        save_db(db, osp.join(args.out_dir, out_name))
        n = len(db["img_name"])
        print(f"wrote {out_name}: {n} frames in {seconds:.3f} s ({n / seconds:.1f} frames/s)")


if __name__ == "__main__":
    main()
