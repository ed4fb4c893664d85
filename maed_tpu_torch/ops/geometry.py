"""Rotation representations and camera projections, over arbitrary leading axes.

The port of the functions of ``maed_tpu/ops/geometry.py`` that the eval
forward runs, with the same formulas and epsilon placements, so that both
agree to rounding in float64. Each function computes in the dtype of its
input.
"""

from __future__ import annotations

import torch


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) (..., 4) -> rotation matrix (..., 3, 3)."""
    q = quat / _norm(quat, keepdim=True)
    w, x, y, z = q.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    The angle is the norm of (axisang + 1e-8), so the zero rotation maps to
    the identity without NaNs.
    """
    angle = _norm(axisang + 1e-8, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    return quat_to_rotmat(quat)


def rotmat_to_quat(rotmat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (w, x, y, z) (..., 4).

    The branch-free four-case form: every case is computed and the one that
    applies is kept by masks.
    """
    shape = rotmat.shape[:-2]
    t = rotmat.reshape(-1, 3, 3).transpose(-1, -2)
    t00, t01, t02 = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    t10, t11, t12 = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    t20, t21, t22 = t[:, 2, 0], t[:, 2, 1], t[:, 2, 2]

    mask_d2 = t22 < eps
    mask_d0_d1 = t00 > t11
    mask_d0_nd1 = t00 < -t11

    s0 = 1 + t00 - t11 - t22
    q0 = torch.stack([t12 - t21, s0, t01 + t10, t20 + t02], dim=-1)
    s1 = 1 - t00 + t11 - t22
    q1 = torch.stack([t20 - t02, t01 + t10, s1, t12 + t21], dim=-1)
    s2 = 1 - t00 - t11 + t22
    q2 = torch.stack([t01 - t10, t20 + t02, t12 + t21, s2], dim=-1)
    s3 = 1 + t00 + t11 + t22
    q3 = torch.stack([s3, t12 - t21, t20 - t02, t01 - t10], dim=-1)

    cases = (
        (mask_d2 & mask_d0_d1, q0, s0),
        (mask_d2 & ~mask_d0_d1, q1, s1),
        (~mask_d2 & mask_d0_nd1, q2, s2),
        (~mask_d2 & ~mask_d0_nd1, q3, s3),
    )
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    q = sum(torch.where(c[:, None], qc, zero) for c, qc, _ in cases)
    s = sum(torch.where(c, sc, zero) for c, _, sc in cases)
    q = q / torch.sqrt(s)[:, None] * 0.5
    return q.reshape(shape + (4,))


def quat_to_aa(quaternion: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) (..., 4) -> axis-angle (..., 3)."""
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(sin_sq)
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    # Avoid 0/0: where sin_sq == 0 use the small-angle limit k = 2.
    positive = sin_sq > 0.0
    safe_sin = torch.where(positive, sin_theta, torch.ones_like(sin_theta))
    k = torch.where(positive, two_theta / safe_sin, torch.full_like(sin_theta, 2.0))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def rotmat_to_aa(rotmat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3); NaNs mapped to 0."""
    aa = quat_to_aa(rotmat_to_quat(rotmat))
    return torch.where(torch.isnan(aa), torch.zeros_like(aa), aa)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation -> rotation matrices (Zhou et al., CVPR'19).

    The input is read as consecutive 6-tuples, each the row-major (3, 2)
    block [m00, m01, m10, m11, m20, m21] (not two concatenated columns):
    (B, 6) -> (B, 3, 3), and a packed (nt, 24*6) pose -> (nt*24, 3, 3).
    """
    if x.numel() % 6:
        raise ValueError(f"rot6d input size {tuple(x.shape)} is not divisible by 6")
    shape = x.shape[:-1] if x.shape[-1] == 6 else (x.numel() // 6,)
    m = x.reshape(-1, 3, 2)
    a1, a2 = m[:, :, 0], m[:, :, 1]
    # F.normalize(v, eps=1e-6): v / max(||v||, eps)
    b1 = a1 / torch.clamp(_norm(a1, keepdim=True), min=1e-6)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    u2 = a2 - dot * b1
    b2 = u2 / torch.clamp(_norm(u2, keepdim=True), min=1e-6)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1).reshape(shape + (3, 3))


def perspective_projection(
    points: torch.Tensor,
    translation: torch.Tensor,
    focal_length: float = 5000.0,
    camera_center: torch.Tensor | None = None,
    rotation: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pinhole projection of (..., N, 3) points given a (..., 3) translation."""
    if rotation is not None:
        points = torch.einsum("...ij,...kj->...ki", rotation, points)
    points = points + translation[..., None, :]
    projected = points / points[..., -1:]
    xy = projected[..., :2] * focal_length
    if camera_center is not None:
        xy = xy + camera_center[..., None, :]
    return xy


def weak_perspective_projection(
    pred_joints: torch.Tensor, pred_camera: torch.Tensor, img_res: float = 224.0
) -> torch.Tensor:
    """SPIN-style weak-perspective reprojection to [-1, 1] image coordinates.

    pred_joints: (..., N, 3); pred_camera: (..., 3) = (s, tx, ty).
    """
    s, tx, ty = pred_camera[..., 0], pred_camera[..., 1], pred_camera[..., 2]
    tz = 2.0 * 5000.0 / (img_res * s + 1e-9)
    translation = torch.stack([tx, ty, tz], dim=-1)
    kp = perspective_projection(pred_joints, translation, focal_length=5000.0)
    return kp / (img_res / 2.0)
