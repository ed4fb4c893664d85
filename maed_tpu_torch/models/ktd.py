"""Kinematic-Topology Decoder: ancestor-conditioned per-joint SMPL regression.

Port of ``maed_tpu/models/ktd.py``. Each joint's 6D pose is regressed from
[trunk feature || 6D poses of its SMPL ancestors, root first] in topological
order: an unrolled chain of 24 small regressors. SMPL then runs in
promote(dtype, f32). A training forward drops out the trunk's fc1 and fc2
outputs at ``drop`` (0.5, as in the JAX package), from the step's generator.
"""

from __future__ import annotations

import torch
from torch import nn

from maed_tpu_torch.models.heads import regressor_output
from maed_tpu_torch.models.layers import Dropout, dense
from maed_tpu_torch.ops.joints import SMPL_PARENTS
from maed_tpu_torch.ops.smpl import SMPLModel


def ancestor_index(parents=tuple(SMPL_PARENTS)):
    """Root-first ancestor chain of every SMPL joint."""
    table = []
    for j in range(len(parents)):
        chain = []
        p = parents[j]
        while p >= 0:
            chain.append(p)
            p = parents[p]
        table.append(list(reversed(chain)))
    return table


ANCESTOR_INDEX = ancestor_index()


class KTD(nn.Module):
    def __init__(self, feat_dim: int = 768, hidden_dim: int = 1024,
                 npose_per_joint: int = 6, drop: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(feat_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.dropout = Dropout(drop)
        self.decshape = nn.Linear(hidden_dim, 10)
        self.deccam = nn.Linear(hidden_dim, 3)
        self.joint_regs = nn.ModuleList(
            nn.Linear(hidden_dim + npose_per_joint * len(ancestors), npose_per_joint)
            for ancestors in ANCESTOR_INDEX)

    def forward(self, x: torch.Tensor, smpl_model: SMPLModel,
                J_regressor: torch.Tensor | None = None, plain: bool = False,
                train: bool = False, generator: torch.Generator | None = None):
        dt = self.dtype
        x = self.dropout(dense(x, self.fc1, dt), train, generator)
        x = self.dropout(dense(x, self.fc2, dt), train, generator)
        pred_shape = dense(x, self.decshape, dt)
        pred_cam = dense(x, self.deccam, dt)

        pose = []
        for reg, ancestors in zip(self.joint_regs, ANCESTOR_INDEX):
            pose.append(dense(torch.cat([x] + [pose[a] for a in ancestors], dim=1), reg, dt))
        pred_pose = torch.cat(pose, dim=1)  # (nt, 144)

        st = torch.promote_types(dt, torch.float32)
        return regressor_output(smpl_model, pred_pose.to(st), pred_shape.to(st),
                                pred_cam.to(st), J_regressor, plain=plain)
