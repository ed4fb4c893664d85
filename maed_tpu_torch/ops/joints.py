"""Joint-index tables for the 49-joint ("spin") keypoint convention.

A copy of the tables of ``maed_tpu/ops/joints.py`` that the eval forward and
the eval protocol use. It is a copy and not an import because importing anything under
``maed_tpu.ops`` imports JAX (``maed_tpu/ops/__init__.py``), and the port runs
where JAX is not installed. ``tests/test_torch_port_ops.py`` checks that the
copies equal the originals.

The 49 output joints are selected from a 54-joint bank: 24 SMPL skeleton
joints, 21 surface-vertex keypoints, and 9 extra regressed joints.
"""

# Bank layout: [0:24] SMPL joints, [24:45] vertex keypoints, [45:54] extra.
JOINT_MAP = {
    'OP Nose': 24, 'OP Neck': 12, 'OP RShoulder': 17,
    'OP RElbow': 19, 'OP RWrist': 21, 'OP LShoulder': 16,
    'OP LElbow': 18, 'OP LWrist': 20, 'OP MidHip': 0,
    'OP RHip': 2, 'OP RKnee': 5, 'OP RAnkle': 8,
    'OP LHip': 1, 'OP LKnee': 4, 'OP LAnkle': 7,
    'OP REye': 25, 'OP LEye': 26, 'OP REar': 27,
    'OP LEar': 28, 'OP LBigToe': 29, 'OP LSmallToe': 30,
    'OP LHeel': 31, 'OP RBigToe': 32, 'OP RSmallToe': 33, 'OP RHeel': 34,
    'Right Ankle': 8, 'Right Knee': 5, 'Right Hip': 45,
    'Left Hip': 46, 'Left Knee': 4, 'Left Ankle': 7,
    'Right Wrist': 21, 'Right Elbow': 19, 'Right Shoulder': 17,
    'Left Shoulder': 16, 'Left Elbow': 18, 'Left Wrist': 20,
    'Neck (LSP)': 47, 'Top of Head (LSP)': 48,
    'Pelvis (MPII)': 49, 'Thorax (MPII)': 50,
    'Spine (H36M)': 51, 'Jaw (H36M)': 52,
    'Head (H36M)': 53, 'Nose': 24, 'Left Eye': 26,
    'Right Eye': 25, 'Left Ear': 28, 'Right Ear': 27,
}

JOINT_NAMES = [
    'OP Nose', 'OP Neck', 'OP RShoulder',
    'OP RElbow', 'OP RWrist', 'OP LShoulder',
    'OP LElbow', 'OP LWrist', 'OP MidHip',
    'OP RHip', 'OP RKnee', 'OP RAnkle',
    'OP LHip', 'OP LKnee', 'OP LAnkle',
    'OP REye', 'OP LEye', 'OP REar',
    'OP LEar', 'OP LBigToe', 'OP LSmallToe',
    'OP LHeel', 'OP RBigToe', 'OP RSmallToe', 'OP RHeel',
    'Right Ankle', 'Right Knee', 'Right Hip',
    'Left Hip', 'Left Knee', 'Left Ankle',
    'Right Wrist', 'Right Elbow', 'Right Shoulder',
    'Left Shoulder', 'Left Elbow', 'Left Wrist',
    'Neck (LSP)', 'Top of Head (LSP)',
    'Pelvis (MPII)', 'Thorax (MPII)',
    'Spine (H36M)', 'Jaw (H36M)',
    'Head (H36M)', 'Nose', 'Left Eye',
    'Right Eye', 'Left Ear', 'Right Ear',
]

JOINT_SELECT = [JOINT_MAP[name] for name in JOINT_NAMES]  # 54-bank -> 49

# SMPL-mesh vertex indices for the 21 appended surface keypoints, in append
# order: 5 face, 6 feet, 10 finger tips (left hand then right hand).
VERTEX_JOINT_IDS = [
    332, 6260, 2800, 4071, 583,           # nose, reye, leye, rear, lear
    3216, 3226, 3387, 6617, 6624, 6787,   # LBigToe, LSmallToe, LHeel, R...
    2746, 2319, 2445, 2556, 2673,         # lthumb, lindex, lmiddle, lring, lpinky
    6191, 5782, 5905, 6016, 6133,         # rthumb, rindex, rmiddle, rring, rpinky
]

# SMPL 24-joint kinematic tree (parent of joint i; -1 for the root).
SMPL_PARENTS = [
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21,
]

# Eval-protocol joint subsets (H36M-regressed 17-joint space and the 49 space).
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 0, 7, 9, 10]
H36M_TO_J14 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10]
H36M_TO_MPII3D = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]

OP_TO_J14 = [11, 10, 9, 12, 13, 14, 4, 3, 2, 5, 6, 7, 1, -1]
J49_TO_J14 = list(range(25, 39))
J49_TO_MPII3D = list(range(25, 39)) + [39, 41, 43]
J49_TO_H36M = [25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 39, 41, 42, 43]

# Which external regressor / joint subset each eval dataset uses.
REGRESSOR_DICT = {
    '3dpw': 'J_regressor_h36m.npy',
    'mpii3d': None,
    'h36m': 'J_regressor_h36m.npy',
}
JID_DICT = {
    '3dpw': H36M_TO_J14,
    'h36m': H36M_TO_J17,
    'mpii3d': J49_TO_MPII3D,
}
