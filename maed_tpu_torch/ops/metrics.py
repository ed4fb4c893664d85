"""Evaluation metrics on the device: MPJPE / PA-MPJPE / PVE / ACCEL.

Port of ``maed_tpu/ops/metrics.py``. All metrics are plain tensor code in
the inputs' dtype (f32 in the eval protocol), so model forward, Procrustes
and metric reduction run on the card and only per-frame values come back.
Pelvis convention: joints [2] and [3] are the two hips in the J14/J17 eval
spaces.
"""

from __future__ import annotations

import torch

from maed_tpu_torch.ops.procrustes import batch_similarity_transform


def pelvis_center(joints: torch.Tensor) -> torch.Tensor:
    pelvis = (joints[..., 2:3, :] + joints[..., 3:4, :]) / 2.0
    return joints - pelvis


def _joint_error(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-joint Euclidean distance, (..., K, 3) -> (..., K)."""
    return torch.sqrt(((a - b) ** 2).sum(-1))


def mpjpe(pred_j3d: torch.Tensor, gt_j3d: torch.Tensor) -> torch.Tensor:
    """Per-frame mean joint error, (N, K, 3) -> (N,). Inputs pre-centered."""
    return _joint_error(pred_j3d, gt_j3d).mean(-1)


def pa_mpjpe(pred_j3d: torch.Tensor, gt_j3d: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned per-frame error, (N, K, 3) -> (N,)."""
    return _joint_error(batch_similarity_transform(pred_j3d, gt_j3d), gt_j3d).mean(-1)


def vert_error(pred_verts: torch.Tensor, gt_verts: torch.Tensor) -> torch.Tensor:
    """PVE, (N, V, 3) -> (N,)."""
    return _joint_error(pred_verts, gt_verts).mean(-1)


def accel(joints: torch.Tensor) -> torch.Tensor:
    """Acceleration magnitude of a joint sequence, (N, K, 3) -> (N-2,)."""
    vel = joints[1:] - joints[:-1]
    acc = vel[1:] - vel[:-1]
    return torch.linalg.norm(acc, dim=-1).mean(-1)


def accel_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Acceleration error between sequences, (N, K, 3) -> (N-2,)."""
    acc_gt = gt[:-2] - 2 * gt[1:-1] + gt[2:]
    acc_pred = pred[:-2] - 2 * pred[1:-1] + pred[2:]
    return torch.linalg.norm(acc_pred - acc_gt, dim=-1).mean(-1)


def eval_metrics(pred_j3d, target_j3d, vis=None):
    """The metric block of the eval protocol: vis-mask, pelvis-center,
    MPJPE / PA-MPJPE / ACCEL.

    pred_j3d, target_j3d: (N, K, 3); vis: (N, K, 1) or None.
    Returns dict of per-frame tensors (meters); caller scales to mm / averages.

    Visibility semantics: joints with vis=0 are zeroed on both sides before
    centering/Procrustes and then *excluded* from the per-frame joint mean
    (dividing by a fixed K would deflate MPJPE whenever a joint is invisible
    mid-sequence, e.g. mpii3d). ACCEL keeps the fixed-K mean.
    """
    if vis is not None:
        pred_j3d = pred_j3d * vis
        target_j3d = target_j3d * vis
        vis_k = vis[..., 0]  # (N, K)
    else:
        vis_k = torch.ones(pred_j3d.shape[:-1], dtype=pred_j3d.dtype, device=pred_j3d.device)
    pred_c = pelvis_center(pred_j3d)
    target_c = pelvis_center(target_j3d)
    n_vis = vis_k.sum(-1).clamp(min=1.0)

    err = _joint_error(pred_c, target_c)  # (N, K)
    err_pa = _joint_error(batch_similarity_transform(pred_c, target_c), target_c)
    return {
        "mpjpe": (err * vis_k).sum(-1) / n_vis,
        "pa_mpjpe": (err_pa * vis_k).sum(-1) / n_vis,
        "accel": accel(pred_c),
        "accel_err": accel_error(pred_c, target_c),
    }
