"""Datasets over preprocessed DBs (video clips and single images).

Port of ``maed_tpu/data/dataset.py`` (the original MAED's
``lib/dataset/dataset_video.py`` and ``dataset_image.py``). Frames decode
through the port's native library (libjpeg, or nvJPEG on a machine without
it), never cv2; poses stored as rotation matrices convert through the port's
``ops/geometry.py::rotmat_to_aa`` on a CPU tensor; a DB is read with joblib
where it is installed and as a plain pickle otherwise.

DB layout: a dict with per-frame arrays keyed by 'vid_name', 'img_name',
'joints2D' (T, 49, 3), 'joints3D' (T, 49, 4), 'pose' (T, 72), 'shape'
(T, 10), 'bbox' (T, 4), 'frame_id', 'valid_i'. Samples come out as numpy
dicts in NHWC; batching/stacking happens in loaders.py.
"""

from __future__ import annotations

import os.path as osp
import pickle

import numpy as np

from maed_tpu_torch import native
from maed_tpu_torch.core import config as cfg_mod
from maed_tpu_torch.data.chunks import gen_sample_index, split_into_chunks


def read_img(path: str) -> np.ndarray:
    """RGB uint8 HWC, decoded by the native library (JPEG only)."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise IOError(f"File error: {path}") from e
    try:
        return native.decode(blob)
    except IOError as e:
        raise IOError(f"File error: {path}: {e} (the port decodes JPEG frames only)") from e


def read_pickled(path: str):
    """A file written by ``joblib.dump`` or ``pickle.dump``: read by joblib
    where it is installed (it also reads plain pickles), else as a plain
    pickle, with a message that says what to do where that cannot work."""
    try:
        import joblib
    except ImportError:
        joblib = None
    if joblib is not None:
        return joblib.load(path)
    with open(path, "rb") as f:
        try:
            return pickle.load(f)
        except ModuleNotFoundError as e:
            if e.name and e.name.split(".")[0] == "joblib":
                raise RuntimeError(
                    f"{path} was written by joblib.dump and joblib is not installed: "
                    "install joblib, or rewrite it as a plain pickle "
                    "(pickle.dump(joblib.load(path), f)) where joblib is") from e
            raise
        except pickle.UnpicklingError as e:
            raise RuntimeError(
                f"{path} is not a plain pickle (a compressed joblib file?) and joblib "
                "is not installed to read it") from e


def save_db(db: dict, path: str) -> None:
    """Write a DB (or any dict of arrays) with joblib where it is installed,
    as the JAX package's preprocessors do, else as a plain pickle; both
    :func:`read_pickled` and ``joblib.load`` read either."""
    try:
        import joblib
    except ImportError:
        with open(path, "wb") as f:
            pickle.dump(db, f, protocol=pickle.HIGHEST_PROTOCOL)
    else:
        joblib.dump(db, path)


def load_db(dataset_name: str, set_name: str, db_dir: str | None = None):
    """The DB ``<db_dir>/<dataset>_<set>_db.pt`` (:func:`read_pickled`)."""
    db_file = osp.join(db_dir or cfg_mod.DB_DIR, f"{dataset_name}_{set_name}_db.pt")
    if not osp.isfile(db_file):
        raise ValueError(f"{db_file} does not exist")
    return read_pickled(db_file)


class VideoDataset:
    """Chunked video clips with 3 frame-sampling modes.

    Each item: {'images' (T,H,W,3) f32, 'kp_2d' (T,49,3), 'kp_3d' (T,49,4),
    'theta' (T,85), 'w_smpl' (T,), 'bbox' (T,4), 'valid' (P,) bool (eval),
    'paths', 'instance_id', 'index'}.
    """

    def __init__(
        self,
        dataset_name: str,
        set: str,
        transforms,
        seqlen: int = 0,
        overlap: float = 0.0,
        sample_pool: int = 64,
        random_sample: bool = True,
        random_start: bool = False,
        pad: bool = True,
        db_dir: str | None = None,
        verbose: bool = True,
        db: dict | None = None,
    ):
        self.dataset_name = dataset_name
        self.set = set
        self.transforms = transforms

        assert seqlen > 0 or sample_pool > 0
        self.seqlen = seqlen if seqlen > 0 else sample_pool
        self.sample_pool = sample_pool if sample_pool > 0 else seqlen
        self.sample_freq = self.sample_pool // self.seqlen

        self.overlap = overlap
        self.stride = max(int(self.sample_pool * (1 - overlap)), 1) if overlap < 1 else int(overlap)

        self.random_sample = random_sample
        self.random_start = random_start
        assert not (self.random_sample and self.random_start)

        self.db = db if db is not None else load_db(dataset_name, set, db_dir)
        self.vid_indices = split_into_chunks(
            np.asarray(self.db["vid_name"]), self.sample_pool, self.stride, pad
        )
        if verbose:
            print(f"{dataset_name} - overlap {self.overlap}, {len(self)} chunks, "
                  f"JPEG decoder {native.decoder()}")

    def __len__(self):
        return len(self.vid_indices)

    def __getitem__(self, index, rng: np.random.RandomState | None = None):
        rng = rng or np.random.RandomState()
        is_train = self.set == "train"
        target = {}

        full_sample_idx = self.vid_indices[index]
        sample_idx = gen_sample_index(
            full_sample_idx, self.seqlen, self.sample_freq,
            self.random_sample, self.random_start, rng,
        )

        kp_2d = (
            np.asarray(self.db["joints2D"])[sample_idx]
            if "joints2D" in self.db else np.zeros([self.seqlen, 49, 3])
        )
        kp_3d = (
            np.asarray(self.db["joints3D"])[sample_idx]
            if "joints3D" in self.db else np.zeros([self.seqlen, 49, 4])
        )

        if "pose" in self.db:
            pose = np.asarray(self.db["pose"])[sample_idx]
            shape = np.asarray(self.db["shape"])[sample_idx]
            w_smpl = np.ones(self.seqlen, np.float32)
        else:
            pose = np.zeros((self.seqlen, 72))
            shape = np.zeros((self.seqlen, 10))
            w_smpl = np.zeros(self.seqlen, np.float32)
        cam = np.concatenate(
            [np.ones((self.seqlen, 1)), np.zeros((self.seqlen, 2))], axis=1
        )
        target["w_smpl"] = w_smpl

        if self.dataset_name != "insta":
            bbox = np.asarray(self.db["bbox"])[sample_idx]
            if not is_train:
                target["bbox"] = bbox.astype(np.float32)

        image_paths = np.asarray(self.db["img_name"])[sample_idx]
        paths = [str(p) for p in image_paths]
        if getattr(self.transforms, "wants_jpeg_bytes", False) and all(
            p.lower().endswith((".jpg", ".jpeg")) for p in paths
        ):
            # hand raw JPEG bytes to the transform: decode happens inside the
            # native thread pool fused with the crop (see
            # transforms.FusedCropNormalize / native.clip_decode_crop_normalize)
            images = []
            for p in paths:
                with open(p, "rb") as f:
                    images.append(f.read())
        else:
            images = [read_img(p) for p in paths]
        if not is_train:
            target["paths"] = paths

        raw = {
            "clip": images,
            "kp_2d": kp_2d,
            "kp_3d": kp_3d,
            "pose": pose,
            "shape": shape,
            "cam": cam,
        }
        if self.dataset_name != "insta":
            raw["bbox"] = bbox
        out = self.transforms(raw, rng)

        clip = np.asarray(out["clip"])
        # uint8 clips ride to the device as-is (DEVICE_PREPROC: the model
        # normalizes on the device and the host ships 1/4 the bytes)
        target["images"] = clip if clip.dtype == np.uint8 else clip.astype(np.float32)
        if "trans" in out:
            # DEVICE_CROP pack: raw frames and their affines; the crop runs on
            # the device (the forward calls ops.image.apply_device_preproc)
            target["trans"] = np.asarray(out["trans"], np.float32)
        target["kp_2d"] = np.asarray(out["kp_2d"], np.float32)
        target["kp_3d"] = np.asarray(out["kp_3d"], np.float32)
        target["theta"] = np.concatenate(
            [np.asarray(out["cam"], np.float32),
             np.asarray(out["pose"], np.float32).reshape(self.seqlen, 72),
             np.asarray(out["shape"], np.float32)], axis=1,
        )

        if not is_train:
            if self.dataset_name in ("3dpw", "h36m", "mpii3d"):
                vn = np.asarray(self.db["vid_name"])[sample_idx]
                fi = np.asarray(self.db["frame_id"])[sample_idx]
                target["instance_id"] = [f"{v}/{f}" for v, f in zip(vn, fi)]
            valid = np.asarray(full_sample_idx)
            valid = valid - np.roll(valid, 1)
            valid = valid > 0
            valid[0] = True
            target["valid"] = valid

        target["index"] = np.array([index])
        return target


class ImageDataset:
    """Single-image DB samples: {'image' (H,W,3), 'kp_2d' (49,3),
    'kp_3d' (49,4), 'theta' (85,), 'w_smpl' ()}."""

    def __init__(self, dataset_name, set, transforms, db_dir=None, verbose=True,
                 subsample: int = 1, db: dict | None = None):
        self.dataset_name = dataset_name
        self.set = set
        self.transforms = transforms
        self.db = db if db is not None else load_db(dataset_name, set, db_dir)
        self.indices = np.arange(len(np.asarray(self.db["img_name"])))[::subsample]
        if verbose:
            print(f"{dataset_name} - {len(self)} images, JPEG decoder {native.decoder()}")

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, index, rng: np.random.RandomState | None = None):
        rng = rng or np.random.RandomState()
        i = self.indices[index]

        kp_2d = (
            np.asarray(self.db["joints2D"])[i]
            if "joints2D" in self.db else np.zeros([49, 3])
        )
        kp_3d = (
            np.asarray(self.db["joints3D"])[i]
            if "joints3D" in self.db else np.zeros([49, 4])
        )
        if "pose" in self.db:
            pose = np.asarray(self.db["pose"])[i]
            if pose.size == 24 * 9:  # stored as rotation matrices
                import torch

                from maed_tpu_torch.ops.geometry import rotmat_to_aa

                rot = torch.from_numpy(np.asarray(pose, np.float32).reshape(24, 3, 3))
                pose = rotmat_to_aa(rot).numpy().reshape(72)
            shape = np.asarray(self.db["shape"])[i]
            w_smpl = np.float32(1.0)
        else:
            pose = np.zeros(72)
            shape = np.zeros(10)
            w_smpl = np.float32(0.0)
        cam = np.array([1.0, 0.0, 0.0])

        image = read_img(str(np.asarray(self.db["img_name"])[i]))
        bbox = np.asarray(self.db["bbox"])[i]

        raw = {
            "clip": [image],
            "kp_2d": kp_2d[None],
            "kp_3d": kp_3d[None],
            "pose": pose[None],
            "shape": shape[None],
            "cam": cam[None],
            "bbox": bbox[None],
        }
        out = self.transforms(raw, rng)

        img0 = np.asarray(out["clip"][0])
        return {
            "image": img0 if img0.dtype == np.uint8 else img0.astype(np.float32),
            "kp_2d": np.asarray(out["kp_2d"], np.float32)[0],
            "kp_3d": np.asarray(out["kp_3d"], np.float32)[0],
            "theta": np.concatenate(
                [np.asarray(out["cam"], np.float32)[0],
                 np.asarray(out["pose"], np.float32).reshape(1, 72)[0],
                 np.asarray(out["shape"], np.float32)[0]]
            ),
            "w_smpl": w_smpl,
            "index": np.array([index]),
        }
