"""SMPL model files, and a synthetic body for runs without them.

Port of ``maed_tpu/utils/smpl_io.py``, returning the port's
:class:`~maed_tpu_torch.ops.smpl.SMPLModel` on a given device. It is a copy
and not an import because ``maed_tpu/utils/smpl_io.py`` imports
``maed_tpu.ops.smpl``, which imports JAX. :func:`synthetic_smpl_model` draws
the same numpy random numbers in the same order as the JAX package's, so for
a given seed the two synthetic bodies are identical.
"""

from __future__ import annotations

import os.path as osp
import pickle
import sys

import numpy as np
import torch

from maed_tpu_torch.ops.smpl import NUM_JOINTS, SMPLModel, make_model


def _to_np(x):
    """Convert chumpy arrays / scipy sparse / plain arrays to dense numpy."""
    if hasattr(x, "r"):  # chumpy
        return np.asarray(x.r)
    if hasattr(x, "todense"):  # scipy sparse
        return np.asarray(x.todense())
    return np.asarray(x)


class _ChumpyUnpickler(pickle.Unpickler):
    """Unpickle SMPL files without the chumpy package installed.

    SMPL pickles reference chumpy.ch.Ch objects; a minimal stub whose
    __setstate__ captures the underlying ndarray takes their place.
    """

    class _ChStub:
        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            for key in ("x", "a", "v"):
                if key in self.__dict__ and isinstance(self.__dict__[key], np.ndarray):
                    return self.__dict__[key]
            for v in self.__dict__.values():
                if isinstance(v, np.ndarray):
                    return v
            raise ValueError("chumpy stub: no ndarray payload found")

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return self._ChStub
        return super().find_class(module, name)


def load_smpl_pickle(path: str):
    with open(path, "rb") as f:
        return _ChumpyUnpickler(f, encoding="latin1").load()


def load_smpl_model(model_dir: str, gender: str = "NEUTRAL",
                    device: torch.device | str = "cuda") -> SMPLModel:
    """Load SMPL_<GENDER>.pkl + J_regressor_extra.npy from model_dir."""
    data = load_smpl_pickle(osp.join(model_dir, f"SMPL_{gender.upper()}.pkl"))
    extra = np.load(osp.join(model_dir, "J_regressor_extra.npy"))
    return make_model(
        v_template=_to_np(data["v_template"]),
        shapedirs=_to_np(data["shapedirs"]),
        posedirs_raw=_to_np(data["posedirs"]),
        J_regressor=_to_np(data["J_regressor"]),
        lbs_weights=_to_np(data["weights"]),
        J_regressor_extra=extra,
        faces=_to_np(data["f"]),
        device=device,
    )


def synthetic_smpl_model(num_verts: int = 400, seed: int = 0,
                         device: torch.device | str = "cuda") -> SMPLModel:
    """A random-but-valid SMPL-shaped model for runs without the SMPL files.

    Every tensor has the real model's meaning and shape structure; the
    kinematic tree is the real SMPL tree. Vertex keypoint ids are drawn
    inside [0, num_verts).
    """
    rng = np.random.RandomState(seed)
    V = num_verts
    v_template = rng.randn(V, 3).astype(np.float32) * 0.3
    shapedirs = rng.randn(V, 3, 10).astype(np.float32) * 0.03
    posedirs_raw = rng.randn(V, 3, 9 * (NUM_JOINTS - 1)).astype(np.float32) * 0.01
    J_regressor = np.abs(rng.rand(NUM_JOINTS, V)).astype(np.float32)
    J_regressor /= J_regressor.sum(axis=1, keepdims=True)
    lbs_weights = np.abs(rng.rand(V, NUM_JOINTS)).astype(np.float32) ** 4
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)
    J_regressor_extra = np.abs(rng.rand(9, V)).astype(np.float32)
    J_regressor_extra /= J_regressor_extra.sum(axis=1, keepdims=True)
    vertex_joint_ids = rng.choice(V, size=21, replace=V < 21)
    # a valid (if meaningless) triangulation so rendering paths are drivable
    idx = np.arange(V, dtype=np.int32)
    faces = np.stack([idx, np.roll(idx, 1), np.roll(idx, 2)], axis=1)
    return make_model(
        faces=faces,
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs_raw=posedirs_raw,
        J_regressor=J_regressor,
        lbs_weights=lbs_weights,
        J_regressor_extra=J_regressor_extra,
        vertex_joint_ids=vertex_joint_ids,
        device=device,
    )


def find_smpl_model(data_dir: str = "data/smpl_data", allow_synthetic: bool = True,
                    device: torch.device | str = "cuda") -> SMPLModel:
    """Load the real model if present; otherwise fall back to a synthetic one.

    The fallback is loud (a warning on stderr) and refusable
    (``allow_synthetic=False`` raises), so a real checkpoint pointed at a
    host without data/smpl_data/ cannot silently give meaningless metrics.
    """
    pkl = osp.join(data_dir, "SMPL_NEUTRAL.pkl")
    if osp.isfile(pkl) and osp.isfile(osp.join(data_dir, "J_regressor_extra.npy")):
        return load_smpl_model(data_dir, device=device)
    if not allow_synthetic:
        raise FileNotFoundError(
            f"SMPL body model not found under '{data_dir}' "
            "(need SMPL_NEUTRAL.pkl + J_regressor_extra.npy). Place the SMPL "
            "files there, or allow the synthetic fallback to run with a RANDOM "
            "body model (smoke tests only: every metric is meaningless)."
        )
    print(
        f"WARNING: SMPL body model not found under '{data_dir}' — falling "
        "back to a SYNTHETIC (random) body model. Vertices, 3D joints and "
        "every metric derived from them are MEANINGLESS. Place the real "
        "SMPL_NEUTRAL.pkl + J_regressor_extra.npy there for real runs.",
        file=sys.stderr,
    )
    return synthetic_smpl_model(num_verts=6890, device=device)
