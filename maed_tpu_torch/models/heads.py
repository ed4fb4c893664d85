"""The decoder's output head: 6D pose -> SMPL -> joints -> reprojection.

Port of ``maed_tpu/models/heads.py::regressor_output``.
"""

from __future__ import annotations

import torch

from maed_tpu_torch.ops.geometry import (rot6d_to_rotmat, rotmat_to_aa,
                                         weak_perspective_projection)
from maed_tpu_torch.ops.smpl import SMPLModel, smpl_forward


def regressor_output(
    smpl_model: SMPLModel,
    pred_pose6d: torch.Tensor,   # (nt, 24*6)
    pred_shape: torch.Tensor,    # (nt, 10)
    pred_cam: torch.Tensor,      # (nt, 3)
    J_regressor: torch.Tensor | None = None,  # (J, V) eval-protocol regressor
    plain: bool = False,
):
    nt = pred_pose6d.shape[0]
    rotmat = rot6d_to_rotmat(pred_pose6d).reshape(nt, 24, 3, 3)

    out = smpl_forward(smpl_model, pred_shape, pose_rotmats=rotmat, plain=plain)
    verts = out["vertices"]
    joints = out["joints"]
    if J_regressor is not None:
        # Eval protocol: regress H36M-space joints from the posed mesh.
        joints = torch.einsum("jv,bvk->bjk", J_regressor.to(verts.dtype), verts)

    kp_2d = weak_perspective_projection(joints, pred_cam)
    pose_aa = rotmat_to_aa(rotmat.reshape(-1, 3, 3)).reshape(nt, -1)
    theta = torch.cat([pred_cam, pose_aa, pred_shape], dim=1)  # (nt, 85)
    return {"theta": theta, "verts": verts, "kp_2d": kp_2d, "kp_3d": joints,
            "rotmat": rotmat}
