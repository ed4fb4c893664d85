"""The body model of the benchmark: a synthetic 6890-vertex SMPL body drawn
from the seed, and the plain SMPL forward, rotations and projection.

There are no SMPL files on either machine, so the benchmark draws a body
with the real model's shapes and kinematic tree, as the port's own fallback
body is drawn (template N(0, 0.3), shape directions N(0, 0.03), pose
directions N(0, 0.01), skinning weights uniform to the fourth power,
row-normalised), on the device from the seed, with joint regressors (and a
J14 regressor for the eval protocol's joints) that each weigh 64 random
vertices, as SMPL's sparse regressors do. The same
tensors go to the program (as its ``SMPLModel``) and to the reference.

The formulas are SMPL's (Loper et al. 2015) and SPIN's weak-perspective
camera, written here in plain torch: nothing of the port is imported.
"""

from __future__ import annotations

import torch

NUM_VERTS = 6890
NUM_JOINTS = 24
# the kinematic tree: the parent of joint i, -1 for the root
SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20,
                21)
# the 49 output joints, picked from the bank [24 skeleton | 21 surface | 9 extra]
JOINT_SELECT = (24, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 25, 26, 27, 28, 29, 30, 31,
                32, 33, 34, 8, 5, 45, 46, 4, 7, 21, 19, 17, 16, 18, 20, 47, 48, 49, 50, 51, 52,
                53, 24, 26, 25, 28, 27)


def ancestors(parents=SMPL_PARENTS) -> list[list[int]]:
    """Root-first ancestor chain of every joint."""
    table = []
    for j in range(len(parents)):
        chain, p = [], parents[j]
        while p >= 0:
            chain.append(p)
            p = parents[p]
        table.append(chain[::-1])
    return table


def make_body(seed: int, device, num_verts: int = NUM_VERTS) -> dict:
    """The body and the J14 regressor, drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    V = num_verts

    def rows(n, m, k=64):
        # each joint a weighted mean of k vertices, as SMPL's sparse regressors
        # are; a dense mean of every vertex would put all joints at the centroid
        r = torch.rand(n, m, generator=g, device=device)
        keep = r >= r.topk(min(k, m), dim=1).values[:, -1:]
        r = torch.where(keep, r, torch.zeros((), device=device))
        return r / r.sum(dim=1, keepdim=True)

    v_template = torch.randn(V, 3, generator=g, device=device) * 0.3
    shapedirs = torch.randn(V, 3, 10, generator=g, device=device) * 0.03
    posedirs = torch.randn(V * 3, 207, generator=g, device=device) * 0.01
    weights = torch.rand(V, NUM_JOINTS, generator=g, device=device) ** 4
    return {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs.t().contiguous(),  # (207, 3V): the product's layout
        "J_regressor": rows(NUM_JOINTS, V),
        "lbs_weights": weights / weights.sum(dim=1, keepdim=True),
        "vertex_joint_ids": torch.randperm(V, generator=g, device=device)[:21],
        "J_regressor_extra": rows(9, V),
        "joint_select": torch.tensor(JOINT_SELECT, dtype=torch.int64, device=device),
        "jreg14": rows(14, V),
    }


# ---------------------------------------------------------------- rotations

def _norm(x, keepdim=True):
    return torch.sqrt((x * x).sum(dim=-1, keepdim=keepdim))


def quat_to_rotmat(q):
    """(w, x, y, z) (..., 4) -> (..., 3, 3)."""
    q = q / _norm(q)
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (w * y + x * z),
        2 * (w * z + x * y), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (w * x + y * z), w * w - x * x - y * y + z * z], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_rotmat(aa):
    """(..., 3) -> (..., 3, 3); the angle is |aa + 1e-8|, so 0 maps to I."""
    angle = _norm(aa + 1e-8)
    half = angle * 0.5
    return quat_to_rotmat(torch.cat([torch.cos(half), torch.sin(half) * aa / angle], dim=-1))


def rotmat_to_axis_angle(R, eps=1e-6):
    """(..., 3, 3) -> (..., 3), through the quaternion of the branch whose
    pivot is largest (the four-case form); NaN -> 0."""
    shape = R.shape[:-2]
    t = R.reshape(-1, 3, 3).transpose(-1, -2)
    t00, t01, t02 = t[:, 0, 0], t[:, 0, 1], t[:, 0, 2]
    t10, t11, t12 = t[:, 1, 0], t[:, 1, 1], t[:, 1, 2]
    t20, t21, t22 = t[:, 2, 0], t[:, 2, 1], t[:, 2, 2]
    d2, d0_d1, d0_nd1 = t22 < eps, t00 > t11, t00 < -t11
    cases = (
        (d2 & d0_d1, 1 + t00 - t11 - t22,
         lambda s: (t12 - t21, s, t01 + t10, t20 + t02)),
        (d2 & ~d0_d1, 1 - t00 + t11 - t22,
         lambda s: (t20 - t02, t01 + t10, s, t12 + t21)),
        (~d2 & d0_nd1, 1 - t00 - t11 + t22,
         lambda s: (t01 - t10, t20 + t02, t12 + t21, s)),
        (~d2 & ~d0_nd1, 1 + t00 + t11 + t22,
         lambda s: (s, t12 - t21, t20 - t02, t01 - t10)),
    )
    q = torch.zeros(t.shape[0], 4, dtype=t.dtype, device=t.device)
    s = torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    for mask, sc, comps in cases:
        q = torch.where(mask[:, None], torch.stack(comps(sc), dim=-1), q)
        s = torch.where(mask, sc, s)
    q = q / torch.sqrt(s)[:, None] * 0.5
    v = q[:, 1:]
    sin = _norm(v, keepdim=False)
    cos = q[:, 0]
    two_theta = 2.0 * torch.where(cos < 0, torch.atan2(-sin, -cos), torch.atan2(sin, cos))
    k = torch.where(sin > 0, two_theta / torch.where(sin > 0, sin, torch.ones_like(sin)),
                    torch.full_like(sin, 2.0))
    aa = v * k[:, None]
    return torch.nan_to_num(aa, nan=0.0).reshape(shape + (3,))


def rot6d_to_rotmat(x):
    """Packed 6D rotations (..., 6k), each the row-major (3, 2) block of the
    first two columns -> (n, 3, 3), Gram-Schmidt with F.normalize's eps."""
    m = x.reshape(-1, 3, 2)
    a1, a2 = m[:, :, 0], m[:, :, 1]
    b1 = a1 / torch.clamp(_norm(a1), min=1e-6)
    u2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = u2 / torch.clamp(_norm(u2), min=1e-6)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def weak_perspective(joints, cam, img_res=224.0):
    """SPIN's projection: (..., J, 3) joints, (..., 3) camera (s, tx, ty) ->
    (..., J, 2) in [-1, 1]."""
    s, tx, ty = cam.unbind(-1)
    tz = 2.0 * 5000.0 / (img_res * s + 1e-9)
    p = joints + torch.stack([tx, ty, tz], dim=-1)[..., None, :]
    return p[..., :2] / p[..., 2:] * 5000.0 / (img_res / 2.0)


# ---------------------------------------------------------------- SMPL

def smpl(body: dict, betas, rotmat):
    """Vertices (B, V, 3), the 49 joints (B, 49, 3) of (B, 10) betas and
    (B, 24, 3, 3) rotations: blend shapes, pose correctives, forward
    kinematics along the tree and linear blend skinning."""
    B = betas.shape[0]
    V = body["v_template"].shape[0]
    v_shaped = body["v_template"] + torch.einsum("bl,vkl->bvk", betas, body["shapedirs"])
    J = torch.einsum("jv,bvk->bjk", body["J_regressor"], v_shaped)
    eye = torch.eye(3, dtype=rotmat.dtype, device=rotmat.device)
    v_posed = v_shaped + torch.matmul((rotmat[:, 1:] - eye).reshape(B, 207),
                                      body["posedirs"]).reshape(B, V, 3)
    parents = SMPL_PARENTS
    rel = torch.cat([J[:, :1], J[:, 1:] - J[:, list(parents[1:])]], dim=1)
    bottom = torch.zeros(B, NUM_JOINTS, 1, 4, dtype=J.dtype, device=J.device)
    bottom[..., 0, 3] = 1.0
    local = torch.cat([torch.cat([rotmat, rel[..., None]], dim=-1), bottom], dim=-2)
    world = [local[:, 0]]
    for j in range(1, NUM_JOINTS):
        world.append(torch.matmul(world[parents[j]], local[:, j]))
    world = torch.stack(world, dim=1)                                  # (B, 24, 4, 4)
    posed_joints = world[:, :, :3, 3]
    rest = torch.matmul(world[:, :, :3, :3], J[..., None])[..., 0]    # R_j J_j
    A = torch.cat([world[:, :, :3, :3], (world[:, :, :3, 3] - rest)[..., None]], dim=-1)
    T = torch.einsum("vj,bjpq->bvpq", body["lbs_weights"], A)          # (B, V, 3, 4)
    verts = torch.matmul(T[..., :3], v_posed[..., None])[..., 0] + T[..., 3]
    extra = torch.einsum("jv,bvk->bjk", body["J_regressor_extra"], verts)
    bank = torch.cat([posed_joints, verts[:, body["vertex_joint_ids"]], extra], dim=1)
    return verts, bank[:, body["joint_select"]]
