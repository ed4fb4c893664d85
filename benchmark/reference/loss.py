"""The training loss of MAED's recipe and Adam, in plain torch.

The loss is the recipe's: over the video batch (2D clips first, then 3D
clips) the confidence-weighted 2D keypoint MSE over every clip, and over the
3D clips the pelvis-centred 3D keypoint MSE, the SMPL pose (on Rodrigues
matrices) and shape MSE masked by ``w_smpl``, and the norm of (pose, shape)
over the row count; over the images the same terms, with every row's SMPL
terms; the two halves weighted by their frame counts. Adam is
``torch.optim.Adam``'s algorithm with L2 weight decay added to the gradient,
written out.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.body import axis_angle_to_rotmat


def _flat(x):
    return x.reshape((-1,) + tuple(x.shape[2:])) if x.ndim > 3 else x


def kp2d_loss(pred, gt):
    pred, gt = _flat(pred), _flat(gt)
    return (gt[..., -1:] * (pred - gt[..., :-1]) ** 2).mean()


def kp3d_loss(pred, gt):
    pred, gt = _flat(pred), _flat(gt)
    conf, gt = gt[..., -1:], gt[..., :-1]
    gt = gt - ((gt[:, 27] + gt[:, 28]) / 2)[:, None]
    pred = pred - ((pred[:, 27] + pred[:, 28]) / 2)[:, None]
    return (conf * (pred - gt) ** 2).mean()


def smpl_loss(pred_theta, gt_theta, w):
    """(pose MSE on rotation matrices, shape MSE) over the rows ``w`` selects."""
    pose_p = pred_theta[..., 3:75].reshape(-1, 72)
    pose_g = gt_theta[..., 3:75].reshape(-1, 72)
    rm_p = axis_angle_to_rotmat(pose_p.reshape(-1, 3)).reshape(pose_p.shape[0], -1)
    rm_g = axis_angle_to_rotmat(pose_g.reshape(-1, 3)).reshape(pose_g.shape[0], -1)
    shape_p = pred_theta[..., 75:].reshape(-1, 10)
    shape_g = gt_theta[..., 75:].reshape(-1, 10)
    w = w.reshape(-1).float()
    n = torch.clamp(w.sum(), min=1.0)
    pose = (w[:, None] * (rm_p - rm_g) ** 2).sum() / (n * rm_p.shape[1])
    shape = (w[:, None] * (shape_p - shape_g) ** 2).sum() / (n * 10)
    return pose, shape


def norm_loss(theta):
    flat = theta.reshape(-1, theta.shape[-1])[:, 3:]
    return torch.sqrt((flat ** 2).sum()) / flat.shape[0]


def terms(preds, kp2d_gt, kp3d_gt, theta_gt, w_smpl, weights, n2d=0):
    """The weighted sum of one half's terms; ``n2d`` leading clips carry 2D
    keypoints alone."""
    total = weights["kp_2d"] * kp2d_loss(preds["kp_2d"], kp2d_gt)
    total = total + weights["kp_3d"] * kp3d_loss(preds["kp_3d"][n2d:], kp3d_gt)
    pose, shape = smpl_loss(preds["theta"][n2d:], theta_gt, w_smpl)
    total = total + weights["shape"] * shape + weights["pose"] * pose
    return total + weights["norm"] * norm_loss(preds["theta"][n2d:])


def step_loss(vid_preds, vid, img_preds, img, weights):
    """The step's loss: video and image halves weighted by frame counts.
    ``vid``/``img`` as the program's step takes them (either may be None)."""
    nt_vid = 0 if vid is None else vid["images"].shape[0] * vid["images"].shape[1]
    nt_img = 0 if img is None else img["image"].shape[0]
    w_vid = nt_vid / (nt_vid + nt_img)
    total = 0.0
    if vid is not None:
        t3 = vid["target_3d"]
        kp2d, n2d = t3["kp_2d"], 0
        if vid.get("target_2d") is not None:
            n2d = vid["target_2d"]["kp_2d"].shape[0]
            kp2d = torch.cat([vid["target_2d"]["kp_2d"], kp2d], dim=0)
        total = total + w_vid * terms(vid_preds, kp2d, t3["kp_3d"], t3["theta"], t3["w_smpl"],
                                      weights, n2d)
    if img is not None:
        preds = {k: v[:, 0] for k, v in img_preds.items()}
        ones = torch.ones(img["image"].shape[0], device=img["image"].device)
        total = total + (1.0 - w_vid) * terms(preds, img["kp_2d"], img["kp_3d"], img["theta"],
                                              ones, weights)
    return total


class Adam:
    """Adam with L2 weight decay on the gradient (``torch.optim.Adam``'s
    ``weight_decay``), betas (0.9, 0.999), eps 1e-8, over a dict of leaves."""

    def __init__(self, params: dict, lr: float, wd: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, wd, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Update in place; returns the gradients as Adam took them (g + wd p)."""
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        taken = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
        return taken
