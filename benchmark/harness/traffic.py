"""The one generator of the benchmark's traffic: it reads a mix's parameters
(``benchmark/traffic/<mix>.json``) and draws, on the device from the seed, a
pool of batches that it keeps in pinned host memory, where a caller's data
would wait. Every seed draws the same sizes; only the values differ.

A mix of kind ``infer`` is closed-loop requests of ``clips`` clips of
``frames`` frames of ``size``^2 uint8 pixels. A mix of kind ``train`` is the
step's composition: ``clips_2d`` clips with 2D keypoints, ``clips_3d``
clips with 3D targets, and ``images`` single images, with self-consistent
targets: smooth pose tracks (four anchors of N(0, 0.4) per joint angle,
eased between) and shapes N(0, 0.3) through the benchmark's own SMPL, the
joints projected with the camera (1, 0, 0). These are the recipe's batch
and the targets of the port's ``tools/bench_train.py``, redrawn in torch.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.body import axis_angle_to_rotmat, smpl, weak_perspective


def _pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=torch.cuda.is_available())
    host.copy_(t)
    return host


def _tree(tree, fn):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree(v, fn) for v in tree)
    return fn(tree)


def to_device(tree, device):
    """A pool batch on ``device``: pinned host -> device, not blocking the host."""
    return _tree(tree, lambda t: t.to(device, non_blocking=True))


def to_host(tree):
    return _tree(tree, _pinned)


def consistent_targets(g, body, n, T, device):
    """(theta (n, T, 85), kp_3d (n, T, 49, 4), kp_2d (n, T, 49, 3))."""
    anchors = torch.randn(n, 4, 72, generator=g, device=device) * 0.4
    t = torch.linspace(0, 3, T, device=device, dtype=torch.float64)
    i0 = torch.clamp(t.floor().long(), max=2)
    w = (0.5 - 0.5 * torch.cos(math.pi * (t - i0))).float()[None, :, None]
    pose = (1 - w) * anchors[:, i0] + w * anchors[:, i0 + 1]
    shape = (torch.randn(n, 1, 10, generator=g, device=device) * 0.3).expand(n, T, 10)
    cam = torch.tensor([1.0, 0.0, 0.0], device=device).expand(n, T, 3)
    rot = axis_angle_to_rotmat(pose.reshape(n * T, 24, 3))
    _, joints = smpl(body, shape.reshape(n * T, 10), rot)
    joints = joints.reshape(n, T, 49, 3)
    kp2d = weak_perspective(joints, cam)
    conf = torch.ones(n, T, 49, 1, device=device)
    return (torch.cat([cam, pose, shape], dim=-1), torch.cat([joints, conf], dim=-1),
            torch.cat([kp2d, conf], dim=-1))


def _frames(g, shape, device):
    return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)


def train_batch(g, body, mix, device):
    """(vid, img) of one step, as the program's step takes them."""
    T, S = mix["frames"], mix["size"]
    n2d, n3d, ni = mix["clips_2d"], mix["clips_3d"], mix["images"]
    vid = None
    if n2d + n3d:
        frames = _frames(g, (n2d + n3d, T, S, S, 3), device)
        th3, kp3_3, kp2_3 = consistent_targets(g, body, n3d, T, device)
        vid = {"images": frames,
               "target_3d": {"kp_2d": kp2_3, "kp_3d": kp3_3, "theta": th3,
                             "w_smpl": torch.ones(n3d, T, device=device)}}
        if n2d:
            vid["target_2d"] = {"kp_2d": consistent_targets(g, body, n2d, T, device)[2]}
    th, kp3, kp2 = consistent_targets(g, body, ni, 1, device)
    img = {"image": _frames(g, (ni, S, S, 3), device), "kp_2d": kp2[:, 0], "kp_3d": kp3[:, 0],
           "theta": th[:, 0], "w_smpl": torch.ones(ni, device=device)}
    return vid, img


@torch.no_grad()
def make_pool(mix: dict, seed: int, body: dict, device) -> list:
    """``mix['pool']`` distinct batches in pinned host memory: uint8 clips
    (infer) or (vid, img) step batches (train)."""
    g = torch.Generator(device=device).manual_seed(seed)
    pool = []
    for _ in range(mix["pool"]):
        if mix["kind"] == "infer":
            pool.append(_pinned(_frames(g, (mix["clips"], mix["frames"], mix["size"],
                                            mix["size"], 3), device)))
        else:
            pool.append(to_host(train_batch(g, body, mix, device)))
    return pool
