"""The SMPL body model: blend shapes, forward kinematics, skinning, joints.

Port of ``maed_tpu/ops/smpl.py``. The JAX package pins its contractions to
``Precision.HIGHEST``; here they are plain f32 (or f64) products, and
callers keep TF32 off (``torch.backends.cuda.matmul.allow_tf32``, False by
default). SMPL runs in f32 even when the encoder runs in bf16: the decoder
promotes its outputs to f32 first, and every SMPL tensor is cast to the dtype
of ``betas`` where it is used.

The skinning step goes through :func:`maed_tpu_torch.ops.skinning.skinning`,
the CUDA kernel on the card, unless ``plain=True`` asks for its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from maed_tpu_torch.ops.geometry import rodrigues
from maed_tpu_torch.ops.joints import JOINT_SELECT, SMPL_PARENTS, VERTEX_JOINT_IDS
from maed_tpu_torch.ops.skinning import skinning, skinning_reference

NUM_JOINTS = 24
NUM_BETAS = 10


class SMPLModel(NamedTuple):
    """Static SMPL model tensors, all on one device. V = 6890 for the real body."""

    v_template: torch.Tensor        # (V, 3)
    shapedirs: torch.Tensor         # (V, 3, 10)
    posedirs: torch.Tensor          # (207, V*3)
    J_regressor: torch.Tensor       # (24, V)
    lbs_weights: torch.Tensor       # (V, 24)
    parents: tuple                  # 24 ints
    vertex_joint_ids: torch.Tensor  # (21,) int64, surface keypoint vertices
    J_regressor_extra: torch.Tensor  # (9, V)
    joint_select: torch.Tensor      # (49,) int64, 54-bank -> 49 output joints
    faces: np.ndarray | None = None  # (F, 3) int32, host-side only


def blend_shapes(betas: torch.Tensor, shapedirs: torch.Tensor) -> torch.Tensor:
    """(B, 10) x (V, 3, 10) -> (B, V, 3)."""
    return torch.einsum("bl,mkl->bmk", betas, shapedirs)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("bik,ji->bjk", vertices, J_regressor)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor, parents):
    """Rigid forward kinematics along the SMPL tree, unrolled over the joints.

    rot_mats (B, 24, 3, 3); joints (B, 24, 3); parents a tuple of ints.
    Returns (posed_joints (B, 24, 3), rel_transforms (B, 24, 4, 4)).
    """
    rel_joints = torch.cat(
        [joints[:, :1], joints[:, 1:] - joints[:, list(parents[1:])]], dim=1)

    tmat = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)  # (B, 24, 3, 4)
    pad = torch.zeros_like(tmat[..., :1, :])
    pad[..., 0, 3] = 1.0
    tmat = torch.cat([tmat, pad], dim=-2)                         # (B, 24, 4, 4)

    chain = [tmat[:, 0]]
    for i in range(1, len(parents)):
        chain.append(torch.matmul(chain[parents[i]], tmat[:, i]))
    transforms = torch.stack(chain, dim=1)

    posed_joints = transforms[:, :, :3, 3]

    # A = T - [0 | T @ [j; 0]]: the transforms act on rest-pose vertices.
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shifted = torch.matmul(transforms, joints_h[..., None])[..., 0]
    rel_transforms = torch.cat(
        [transforms[..., :3], transforms[..., 3:] - shifted[..., None]], dim=-1)
    return posed_joints, rel_transforms


def lbs(model: SMPLModel, betas: torch.Tensor, rot_mats: torch.Tensor,
        plain: bool = False):
    """Linear blend skinning in the dtype of ``betas``.

    betas (B, 10); rot_mats (B, 24, 3, 3).
    Returns (vertices (B, V, 3), skeleton joints (B, 24, 3)).
    """
    B = betas.shape[0]
    V = model.v_template.shape[0]
    dt = betas.dtype

    v_shaped = model.v_template.to(dt)[None] + blend_shapes(betas, model.shapedirs.to(dt))
    J = vertices2joints(model.J_regressor.to(dt), v_shaped)

    ident = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)  # (B, 207)
    pose_offsets = torch.matmul(pose_feature, model.posedirs.to(dt))
    v_posed = v_shaped + pose_offsets.reshape(B, V, 3)

    posed_joints, A = batch_rigid_transform(rot_mats, J, model.parents)
    skin = skinning_reference if plain else skinning
    verts = skin(v_posed, model.lbs_weights.to(dt), A)
    return verts, posed_joints


def smpl_forward(
    model: SMPLModel,
    betas: torch.Tensor,
    global_orient: torch.Tensor | None = None,
    body_pose: torch.Tensor | None = None,
    pose_rotmats: torch.Tensor | None = None,
    pose_axis_angle: torch.Tensor | None = None,
    plain: bool = False,
):
    """Full SMPL forward to (vertices, 49 joints).

    The pose is pose_rotmats (B, 24, 3, 3), or global_orient (B, 1, 3, 3) +
    body_pose (B, 23, 3, 3), or pose_axis_angle (B, 72).
    Returns a dict with 'vertices' (B, V, 3), 'joints' (B, 49, 3) and
    'joints24' (B, 24, 3).
    """
    if pose_rotmats is None:
        if pose_axis_angle is not None:
            B = pose_axis_angle.shape[0]
            pose_rotmats = rodrigues(pose_axis_angle.reshape(B, 24, 3))
        else:
            pose_rotmats = torch.cat([global_orient, body_pose], dim=1)

    verts, joints24 = lbs(model, betas, pose_rotmats, plain=plain)

    # 54-joint bank: 24 skeleton + 21 surface keypoints + 9 extra regressed.
    vertex_joints = verts[:, model.vertex_joint_ids]
    extra_joints = vertices2joints(model.J_regressor_extra.to(verts.dtype), verts)
    bank = torch.cat([joints24, vertex_joints, extra_joints], dim=1)
    joints = bank[:, model.joint_select]
    return {"vertices": verts, "joints": joints, "joints24": joints24}


def make_model(
    v_template,
    shapedirs,
    posedirs_raw,
    J_regressor,
    lbs_weights,
    J_regressor_extra,
    faces=None,
    vertex_joint_ids=None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> SMPLModel:
    """Assemble an SMPLModel on ``device`` from raw (numpy) arrays.

    posedirs_raw: (V, 3, 207) as stored in the SMPL pickle; converted to the
    (207, 3V) matmul layout here. vertex_joint_ids defaults to the real-mesh
    indices; synthetic models pass their own.
    """
    posedirs = np.asarray(posedirs_raw, np.float64).reshape(-1, posedirs_raw.shape[-1]).T
    if vertex_joint_ids is None:
        vertex_joint_ids = VERTEX_JOINT_IDS

    def tensor(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device).contiguous()

    return SMPLModel(
        v_template=tensor(v_template),
        shapedirs=tensor(np.asarray(shapedirs)[..., :NUM_BETAS]),
        posedirs=tensor(posedirs),
        J_regressor=tensor(J_regressor),
        lbs_weights=tensor(lbs_weights),
        parents=tuple(SMPL_PARENTS),
        vertex_joint_ids=tensor(vertex_joint_ids, torch.int64),
        J_regressor_extra=tensor(J_regressor_extra),
        joint_select=tensor(JOINT_SELECT, torch.int64),
        faces=None if faces is None else np.asarray(faces, np.int32),
    )
