"""The iterative (SPIN/HMR-style) decoder: three residual refinements of the
SMPL parameters from the mean pose.

Port of ``maed_tpu/models/spin.py``. Each step concatenates the feature with
the current pose (6D), shape and camera, runs fc1 -> dropout -> fc2 ->
dropout, and adds the outputs of ``decpose``, ``decshape`` and ``deccam``.
The dropout masks (rate 0.5, as in the JAX package) come from the training
forward's generator. SMPL then runs through ``models.heads.regressor_output``
(kernel A on the card) in promote(dtype, f32).

The starting point is ``smpl_mean_params.npz`` of the data directory when
the file exists, read when the decoder is built; without it, the JAX
package's fallback: identity 6D rotations, zero shape, camera (0.9, 0, 0).
The means are a non-persistent buffer, so the state_dict holds the learned
weights only, as the JAX package's converter writes them.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch
from torch import nn

from maed_tpu_torch.models.heads import regressor_output
from maed_tpu_torch.models.layers import Dropout, dense
from maed_tpu_torch.ops.smpl import SMPLModel

NPOSE, NSHAPE, NCAM = 144, 10, 3
N_ITER = 3  # refinement steps


def load_mean_params(data_dir: str = "data/smpl_data") -> np.ndarray:
    """The mean (pose6d (144,), shape (10,), cam (3,)) as one vector of 157:
    from ``<data_dir>/smpl_mean_params.npz`` (its values rounded to f32), or
    the JAX package's fallback when the file is absent. f64, as the JAX
    package keeps the values (Python floats: the fallback's camera is 0.9,
    not its f32 rounding); the forward rounds them to its dtype."""
    path = osp.join(data_dir, "smpl_mean_params.npz")
    if osp.isfile(path):
        with np.load(path) as d:
            parts = [np.asarray(d[k], np.float32).ravel() for k in ("pose", "shape", "cam")]
    else:
        parts = [np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), 24),
                 np.zeros(NSHAPE, np.float32), np.array([0.9, 0.0, 0.0])]
    return np.concatenate(parts).astype(np.float64)


class IterativeRegressor(nn.Module):
    def __init__(self, feat_dim: int = 2048, hidden_dim: int = 1024, drop: float = 0.5,
                 data_dir: str = "data/smpl_data", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(feat_dim + NPOSE + NSHAPE + NCAM, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.decpose = nn.Linear(hidden_dim, NPOSE)
        self.decshape = nn.Linear(hidden_dim, NSHAPE)
        self.deccam = nn.Linear(hidden_dim, NCAM)
        self.drop1, self.drop2 = Dropout(drop), Dropout(drop)
        self.mean_params = load_mean_params(data_dir)
        self.register_buffer("init_params", torch.empty(len(self.mean_params),
                                                        dtype=torch.float64), persistent=False)
        self.reset_mean_params_()

    def reset_mean_params_(self) -> None:
        """Fill the buffer of the mean parameters (after ``to_empty``, which
        leaves it uninitialized)."""
        if self.init_params.device.type != "meta":
            with torch.no_grad():
                self.init_params.copy_(torch.from_numpy(self.mean_params))

    def forward(self, x: torch.Tensor, smpl_model: SMPLModel,
                J_regressor: torch.Tensor | None = None, plain: bool = False,
                train: bool = False, generator: torch.Generator | None = None):
        dt, nt = self.dtype, x.shape[0]
        init = self.init_params.to(x.dtype).expand(nt, -1)
        pose, shape, cam = init.split((NPOSE, NSHAPE, NCAM), dim=1)
        for _ in range(N_ITER):
            xc = torch.cat([x, pose, shape, cam], dim=1)
            xc = self.drop1(dense(xc, self.fc1, dt), train, generator)
            xc = self.drop2(dense(xc, self.fc2, dt), train, generator)
            pose = dense(xc, self.decpose, dt) + pose
            shape = dense(xc, self.decshape, dt) + shape
            cam = dense(xc, self.deccam, dt) + cam
        st = torch.promote_types(pose.dtype, torch.float32)
        return regressor_output(smpl_model, pose.to(st), shape.to(st), cam.to(st), J_regressor,
                                plain=plain)
