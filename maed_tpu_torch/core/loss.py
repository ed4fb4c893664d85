"""Training losses as confidence- and validity-weighted reductions over
static shapes.

Port of ``maed_tpu/core/loss.py``, whole: the 2D and 3D keypoint losses, the
masked SMPL losses (``w_smpl`` weights rows instead of selecting them, with
the mean taken over the selected rows), the acceleration and theta-norm
terms, the video and image losses of the stage-2 step and their weighted
merge, and the adversarial and smoothness losses, which the released recipe
does not use. Every function takes and returns tensors, so one step covers
every batch composition.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maed_tpu_torch.ops.geometry import rodrigues


class LossWeights(NamedTuple):
    kp_2d: float = 60.0
    kp_3d: float = 30.0
    shape: float = 0.001
    pose: float = 1.0
    norm: float = 1.0
    accl: float = 0.0


def _flatten_video(x):
    """(N, T, ...) -> (N*T, ...); image batches pass through."""
    if x.ndim > 3:
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return x


def keypoint_2d_loss(pred_kp2d, gt_kp2d):
    """Confidence-weighted MSE over 2D keypoints: pred (..., K, 2), gt
    (..., K, 3) with the confidence last."""
    pred = _flatten_video(pred_kp2d)
    gt = _flatten_video(gt_kp2d)
    conf = gt[..., -1:]
    return (conf * (pred - gt[..., :-1]) ** 2).mean()


def keypoint_3d_loss(pred_kp3d, gt_kp3d):
    """Pelvis-centred confidence-weighted MSE over the 49 joints: pred (...,
    49, 3), gt (..., 49, 4). The pelvis is the mean of joints 27 and 28 (the
    hips of the 49-joint convention)."""
    pred = _flatten_video(pred_kp3d)
    gt = _flatten_video(gt_kp3d)
    conf = gt[..., -1:]
    gt = gt[..., :-1]
    gt_pelvis = (gt[:, 25 + 2] + gt[:, 25 + 3]) / 2
    pred_pelvis = (pred[:, 25 + 2] + pred[:, 25 + 3]) / 2
    gt = gt - gt_pelvis[:, None]
    pred = pred - pred_pelvis[:, None]
    return (conf * (pred - gt) ** 2).mean()


def smpl_losses(pred_pose, pred_shape, gt_pose, gt_shape, w_smpl=None):
    """Masked MSE on the Rodrigues rotation matrices and on the betas.

    Poses (..., 72), shapes (..., 10); ``w_smpl`` (...) the rows' validity,
    or None for every row. The sums are divided by the count of selected
    rows (at least 1) times the row width.
    """
    pose_p = pred_pose.reshape(-1, pred_pose.shape[-1])
    pose_g = gt_pose.reshape(-1, gt_pose.shape[-1])
    shape_p = pred_shape.reshape(-1, pred_shape.shape[-1])
    shape_g = gt_shape.reshape(-1, gt_shape.shape[-1])
    if w_smpl is None:
        w = torch.ones((pose_p.shape[0],), dtype=pose_p.dtype, device=pose_p.device)
    else:
        w = w_smpl.reshape(-1).to(pose_p.dtype)

    X = pose_p.shape[0]
    rm_p = rodrigues(pose_p.reshape(X * 24, 3)).reshape(X, -1)
    rm_g = rodrigues(pose_g.reshape(X * 24, 3)).reshape(X, -1)

    n_sel = torch.clamp(w.sum(), min=1.0)
    loss_pose = (w[:, None] * (rm_p - rm_g) ** 2).sum() / (n_sel * rm_p.shape[1])
    loss_shape = (w[:, None] * (shape_p - shape_g) ** 2).sum() / (n_sel * shape_p.shape[1])
    return loss_pose, loss_shape


def accl_loss(pred_kp3d, gt_kp3d):
    """MSE of the second differences over time, gated by conf ** 4 of the
    later frame: pred (N, T, 49, 3), gt (N, T, 49, 4)."""
    conf = gt_kp3d[..., -1:]
    conf_acc = conf[:, 2:] ** 4

    def dd(x):
        return x[:, 2:] - 2 * x[:, 1:-1] + x[:, :-2]

    pred_acc = dd(pred_kp3d) * conf_acc
    gt_acc = dd(gt_kp3d[..., :3]) * conf_acc
    return ((pred_acc - gt_acc) ** 2).mean()


def theta_norm_loss(pred_theta):
    """Frobenius norm of (pose || shape) over the batch, divided by the row count."""
    flat = pred_theta.reshape(-1, pred_theta.shape[-1])[:, 3:]
    return torch.sqrt((flat ** 2).sum()) / flat.shape[0]


def video_loss(preds: dict, data_3d: dict, data_2d: dict | None, w: LossWeights):
    """The video batch's loss: the 2D keypoints over the whole (2D || 3D)
    batch, the 3D terms over its 3D part, which starts after the ``n2d``
    clips of ``data_2d``. Returns (total, the weighted terms)."""
    if data_2d is not None:
        n2d = data_2d["kp_2d"].shape[0]
        gt_j2d = torch.cat([data_2d["kp_2d"], data_3d["kp_2d"]], dim=0)
    else:
        n2d = 0
        gt_j2d = data_3d["kp_2d"]

    pred_j2d = preds["kp_2d"]
    pred_j3d = preds["kp_3d"][n2d:]
    pred_theta = preds["theta"][n2d:]

    loss_dict = {
        "loss_kp_2d": w.kp_2d * keypoint_2d_loss(pred_j2d, gt_j2d),
        "loss_kp_3d": w.kp_3d * keypoint_3d_loss(pred_j3d, data_3d["kp_3d"]),
    }

    gt_theta = data_3d["theta"]
    if w.shape > 0 and w.pose > 0:
        loss_pose, loss_shape = smpl_losses(
            pred_theta[..., 3:75], pred_theta[..., 75:],
            gt_theta[..., 3:75], gt_theta[..., 75:],
            data_3d["w_smpl"],
        )
        loss_dict["loss_shape"] = w.shape * loss_shape
        loss_dict["loss_pose"] = w.pose * loss_pose

    if w.norm > 0:
        loss_dict["loss_norm"] = w.norm * theta_norm_loss(pred_theta)

    if w.accl > 0:
        loss_dict["loss_accl"] = w.accl * accl_loss(pred_j3d, data_3d["kp_3d"])

    total = sum(loss_dict.values())
    return total, loss_dict


def image_loss(preds: dict, target: dict, w: LossWeights):
    """The image batch's loss; preds carry a T = 1 axis, taken off here. The
    3D keypoint term is kept where the target has ``kp_3d``, and the SMPL
    losses run over every row (``w_smpl`` is not applied to images)."""
    pred_j2d = preds["kp_2d"][:, 0]
    pred_j3d = preds["kp_3d"][:, 0]
    pred_theta = preds["theta"][:, 0]

    loss_dict = {"loss_kp_2d": w.kp_2d * keypoint_2d_loss(pred_j2d, target["kp_2d"])}
    if "kp_3d" in target:
        loss_dict["loss_kp_3d"] = w.kp_3d * keypoint_3d_loss(pred_j3d, target["kp_3d"])

    gt_theta = target["theta"]
    if w.shape > 0 and w.pose > 0:
        loss_pose, loss_shape = smpl_losses(
            pred_theta[:, 3:75], pred_theta[:, 75:],
            gt_theta[:, 3:75], gt_theta[:, 75:],
            w_smpl=None,
        )
        loss_dict["loss_shape"] = w.shape * loss_shape
        loss_dict["loss_pose"] = w.pose * loss_pose

    if w.norm > 0:
        loss_dict["loss_norm"] = w.norm * theta_norm_loss(pred_theta)

    total = sum(loss_dict.values())
    return total, loss_dict


def encoder_disc_l2_loss(disc_value):
    """The generator's LSGAN loss (the adversarial variant; not in the recipe)."""
    return torch.sum((disc_value - 1.0) ** 2) / disc_value.shape[0]


def adv_disc_l2_loss(real_disc_value, fake_disc_value):
    la = torch.sum((real_disc_value - 1.0) ** 2) / real_disc_value.shape[0]
    lb = torch.sum(fake_disc_value ** 2) / fake_disc_value.shape[0]
    return la, lb, la + lb


def encoder_disc_wasserstein_loss(disc_value):
    return -torch.sum(disc_value) / disc_value.shape[0]


def adv_disc_wasserstein_loss(real_disc_value, fake_disc_value):
    la = -torch.sum(real_disc_value) / real_disc_value.shape[0]
    lb = torch.sum(fake_disc_value) / fake_disc_value.shape[0]
    return la, lb, la + lb


def smooth_pose_loss(pred_theta):
    """|mean first difference| of the pose track (N, T, 85)."""
    pose = pred_theta[:, :, 3:75]
    return torch.abs(torch.mean(pose[:, 1:] - pose[:, :-1]))


def smooth_shape_loss(pred_theta):
    shape = pred_theta[:, :, 75:]
    return torch.abs(torch.mean(shape[:, 1:] - shape[:, :-1]))


def merge_loss(loss_vid, loss_vid_dict, loss_img, loss_img_dict, vid_w=1.0, img_w=1.0):
    """The video and image losses and their terms merged with the
    per-sample-count weights the step computes."""
    merged = {}
    for k in set(loss_vid_dict) | set(loss_img_dict):
        v = 0.0
        if k in loss_vid_dict:
            v = v + loss_vid_dict[k] * vid_w
        if k in loss_img_dict:
            v = v + loss_img_dict[k] * img_w
        merged[k] = v
    return loss_vid * vid_w + loss_img * img_w, merged
