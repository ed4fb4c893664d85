"""SMPL's products for ``B`` bodies of ``V`` vertices, as the plain
reference computes them (``reference.body.smpl``), and the skinning step
alone (kernel A's operation)."""

JOINTS, BETAS, POSE_FEATURES = 24, 10, 207


def flops(B: int, V: int, regressor_joints: int = 0) -> int:
    f = 2 * B * V * 3 * BETAS                 # shape blend
    f += 2 * B * JOINTS * V * 3               # rest joints
    f += 2 * B * POSE_FEATURES * V * 3        # pose correctives
    f += (JOINTS - 1) * 2 * B * 4 * 4 * 4     # the kinematic chain
    f += 2 * B * JOINTS * 3 * 3               # R_j J_j
    f += skinning_flops(B, V)
    f += 2 * B * 9 * V * 3                    # the extra joints
    f += 2 * B * regressor_joints * V * 3     # the eval regressor's joints
    return f


def skinning_flops(B: int, V: int) -> int:
    """Blending the 24 (3, 4) transforms per vertex, then applying them."""
    return 2 * V * JOINTS * B * 12 + 2 * B * V * 3 * 3


def skinning_bytes(B: int, V: int) -> int:
    """f32: posed vertices, the weights, the transforms read; vertices written."""
    return 4 * (B * V * 3 + V * JOINTS + B * JOINTS * 16 + B * V * 3)
