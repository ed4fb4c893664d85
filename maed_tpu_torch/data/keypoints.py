"""Keypoint-format rosetta stone: joint-name tables per dataset and
name-matching format conversion, plus left/right flip helpers.

A numpy copy of ``maed_tpu/data/keypoints.py`` (the original MAED's
``lib/data_utils/kp_utils.py``). Joint
orderings are dataset facts; conversion is by name matching with zero-fill for
absent joints, exactly like the reference. Flip permutations are derived from
a name-level left<->right swap (verified in tests against the reference's
explicit flipped table).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# joint-name tables
# ---------------------------------------------------------------------------

SPIN_JOINT_NAMES = [
    'OP Nose', 'OP Neck', 'OP RShoulder', 'OP RElbow', 'OP RWrist',
    'OP LShoulder', 'OP LElbow', 'OP LWrist', 'OP MidHip',
    'OP RHip', 'OP RKnee', 'OP RAnkle', 'OP LHip', 'OP LKnee', 'OP LAnkle',
    'OP REye', 'OP LEye', 'OP REar', 'OP LEar',
    'OP LBigToe', 'OP LSmallToe', 'OP LHeel',
    'OP RBigToe', 'OP RSmallToe', 'OP RHeel',
    'rankle', 'rknee', 'rhip', 'lhip', 'lknee', 'lankle',
    'rwrist', 'relbow', 'rshoulder', 'lshoulder', 'lelbow', 'lwrist',
    'neck', 'headtop', 'hip', 'thorax',
    'Spine (H36M)', 'Jaw (H36M)', 'Head (H36M)',
    'nose', 'leye', 'reye', 'lear', 'rear',
]

H36M_JOINT_NAMES = [
    'hip', 'lhip', 'lknee', 'lankle', 'rhip', 'rknee', 'rankle',
    'Spine (H36M)', 'neck', 'Head (H36M)', 'headtop',
    'lshoulder', 'lelbow', 'lwrist', 'rshoulder', 'relbow', 'rwrist',
]

COMMON_JOINT_NAMES = [
    'rankle', 'rknee', 'rhip', 'lhip', 'lknee', 'lankle',
    'rwrist', 'relbow', 'rshoulder', 'lshoulder', 'lelbow', 'lwrist',
    'neck', 'headtop',
]

COCO_JOINT_NAMES = [
    'nose', 'leye', 'reye', 'lear', 'rear',
    'lshoulder', 'rshoulder', 'lelbow', 'relbow', 'lwrist', 'rwrist',
    'lhip', 'rhip', 'lknee', 'rknee', 'lankle', 'rankle',
]

MPII_JOINT_NAMES = [
    'rankle', 'rknee', 'rhip', 'lhip', 'lknee', 'lankle',
    'hip', 'thorax', 'neck', 'headtop',
    'rwrist', 'relbow', 'rshoulder', 'lshoulder', 'lelbow', 'lwrist',
]

MPII3D_JOINT_NAMES = [
    'spine3', 'spine4', 'spine2', 'Spine (H36M)', 'hip', 'neck',
    'Head (H36M)', 'headtop', 'left_clavicle', 'lshoulder', 'lelbow',
    'lwrist', 'left_hand', 'right_clavicle', 'rshoulder', 'relbow', 'rwrist',
    'right_hand', 'lhip', 'lknee', 'lankle', 'left_foot', 'left_toe',
    'rhip', 'rknee', 'rankle', 'right_foot', 'right_toe',
]

MPII3D_TEST_JOINT_NAMES = [
    'headtop', 'neck', 'rshoulder', 'relbow', 'rwrist', 'lshoulder',
    'lelbow', 'lwrist', 'rhip', 'rknee', 'rankle', 'lhip', 'lknee',
    # NOTE the reference is missing a comma after 'lankle', fusing it with
    # 'hip' into one bogus name; kept split here (the fused name never
    # matches anything in either codebase, so conversion output is identical
    # for all joints that matter).
    'lankle', 'hip', 'Spine (H36M)', 'Head (H36M)',
]

INSTA_JOINT_NAMES = [
    'OP RHeel', 'OP RKnee', 'OP RHip', 'OP LHip', 'OP LKnee', 'OP LHeel',
    'OP RWrist', 'OP RElbow', 'OP RShoulder', 'OP LShoulder', 'OP LElbow',
    'OP LWrist', 'OP Neck', 'headtop', 'OP Nose', 'OP LEye', 'OP REye',
    'OP LEar', 'OP REar', 'OP LBigToe', 'OP RBigToe', 'OP LSmallToe',
    'OP RSmallToe', 'OP LAnkle', 'OP RAnkle',
]

POSETRACK_JOINT_NAMES = [
    'nose', 'neck', 'headtop', 'lear', 'rear',
    'lshoulder', 'rshoulder', 'lelbow', 'relbow', 'lwrist', 'rwrist',
    'lhip', 'rhip', 'lknee', 'rknee', 'lankle', 'rankle',
]

PENNACTION_JOINT_NAMES = [
    'lankle', 'lknee', 'lhip', 'rhip', 'rknee', 'rankle',
    'lwrist', 'lelbow', 'lshoulder', 'rshoulder', 'relbow', 'rwrist',
    'headtop',
]

STAF_JOINT_NAMES = [
    'OP Nose', 'OP Neck', 'OP RShoulder', 'OP RElbow', 'OP RWrist',
    'OP LShoulder', 'OP LElbow', 'OP LWrist', 'OP MidHip',
    'OP RHip', 'OP RKnee', 'OP RAnkle', 'OP LHip', 'OP LKnee', 'OP LAnkle',
    'OP REye', 'OP LEye', 'OP REar', 'OP LEar',
    'Neck (LSP)', 'Top of Head (LSP)',
]

THREEDPW_JOINT_NAMES = [
    'nose', 'thorax', 'rshoulder', 'relbow', 'rwrist',
    'lshoulder', 'lelbow', 'lwrist',
    'rhip', 'rknee', 'rankle', 'lhip', 'lknee', 'lankle',
]

AICH_JOINT_NAMES = [
    'rshoulder', 'relbow', 'rwrist', 'lshoulder', 'lelbow', 'lwrist',
    'rhip', 'rknee', 'rankle', 'lhip', 'lknee', 'lankle',
    'headtop', 'neck',
]

SMPLCOCO_JOINT_NAMES = COMMON_JOINT_NAMES + ['nose', 'leye', 'reye', 'lear', 'rear']

SMPL_JOINT_NAMES = [
    'hips', 'leftUpLeg', 'rightUpLeg', 'spine', 'leftLeg', 'rightLeg',
    'spine1', 'leftFoot', 'rightFoot', 'spine2', 'leftToeBase',
    'rightToeBase', 'neck', 'leftShoulder', 'rightShoulder', 'head',
    'leftArm', 'rightArm', 'leftForeArm', 'rightForeArm', 'leftHand',
    'rightHand', 'leftHandIndex1', 'rightHandIndex1',
]

SPIN2_JOINT_NAMES = SPIN_JOINT_NAMES[25:]

JOINT_FORMATS = {
    'spin': SPIN_JOINT_NAMES,
    'spin2': SPIN2_JOINT_NAMES,
    'h36m': H36M_JOINT_NAMES,
    'common': COMMON_JOINT_NAMES,
    'coco': COCO_JOINT_NAMES,
    'mpii': MPII_JOINT_NAMES,
    'mpii3d': MPII3D_JOINT_NAMES,
    'mpii3d_test': MPII3D_TEST_JOINT_NAMES,
    'insta': INSTA_JOINT_NAMES,
    'posetrack': POSETRACK_JOINT_NAMES,
    'pennaction': PENNACTION_JOINT_NAMES,
    'staf': STAF_JOINT_NAMES,
    '3dpw': THREEDPW_JOINT_NAMES,
    'aich': AICH_JOINT_NAMES,
    'smplcoco': SMPLCOCO_JOINT_NAMES,
    'smpl': SMPL_JOINT_NAMES,
}


def flip_name(name: str) -> str:
    """Left<->right swap of a joint name across all naming conventions."""
    if name.startswith('OP '):
        rest = name[3:]
        if rest.startswith('R'):
            return 'OP L' + rest[1:]
        if rest.startswith('L'):
            return 'OP R' + rest[1:]
        return name
    if name.startswith('left'):
        return 'right' + name[4:]
    if name.startswith('right'):
        return 'left' + name[5:]
    if name and name[0] == 'l' and name[1:] in (
        'ankle', 'knee', 'hip', 'wrist', 'elbow', 'shoulder', 'eye', 'ear',
    ):
        return 'r' + name[1:]
    if name and name[0] == 'r' and name[1:] in (
        'ankle', 'knee', 'hip', 'wrist', 'elbow', 'shoulder', 'eye', 'ear',
    ):
        return 'l' + name[1:]
    return name


def get_joint_names(fmt: str, flip: bool = False):
    names = JOINT_FORMATS[fmt]
    if flip:
        return [flip_name(n) for n in names]
    return list(names)


def convert_kps(joints: np.ndarray, src: str, dst: str, flip: bool = False) -> np.ndarray:
    """Convert (T, K_src, C) keypoints between formats by joint-name matching;
    joints absent in the source are zero-filled (conf channel included)."""
    src_names = get_joint_names(src)
    dst_names = get_joint_names(dst, flip)
    out = np.zeros((joints.shape[0], len(dst_names), joints.shape[2]), dtype=joints.dtype)
    for idx, name in enumerate(dst_names):
        if name in src_names:
            out[:, idx] = joints[:, src_names.index(name)]
    return out


def get_perm_idxs(src: str, dst: str):
    src_names = get_joint_names(src)
    return [src_names.index(n) for n in get_joint_names(dst) if n in src_names]


def convert_kps_to_mask(kp_2d: np.ndarray, visibility: np.ndarray,
                        mask_size: int, img_size: int = 224) -> np.ndarray:
    """Rasterize visible 2D keypoints into a coarse (mask_size, mask_size)
    binary occupancy grid (parity: the original MAED's lib/data_utils/
    kp_utils.py:3-21, vectorized). Cell math reproduces the reference
    exactly: floor-divide by the integer cell width, cast through int8,
    then clamp into the grid — so out-of-frame keypoints land on the
    border cells rather than being dropped."""
    kp = np.asarray(kp_2d, dtype=np.float64)
    cell = img_size // mask_size
    idx = np.floor(kp // cell).astype(np.int8)
    idx = np.clip(idx, 0, mask_size - 1)
    mask = np.zeros((mask_size, mask_size), dtype=np.float16)
    vis = np.asarray(visibility) != 0
    mask[idx[vis, 1], idx[vis, 0]] = 1
    return mask


# ---------------------------------------------------------------------------
# horizontal flips (augmentation)
# ---------------------------------------------------------------------------

def keypoint_2d_hflip(kp_2d: np.ndarray, img_width: int) -> np.ndarray:
    """Mirror 2D spin keypoints: swap left/right joints, negate x."""
    squeeze = kp_2d.ndim == 2
    if squeeze:
        kp_2d = kp_2d[None]
    kp = convert_kps(kp_2d, src='spin', dst='spin', flip=True)
    kp[:, :, 0] = (img_width - 1.0) - kp[:, :, 0]
    return kp[0] if squeeze else kp


def keypoint_3d_hflip(kp_3d: np.ndarray) -> np.ndarray:
    """Mirror 3D spin keypoints about the pelvis-centered y-z plane."""
    squeeze = kp_3d.ndim == 2
    if squeeze:
        kp_3d = kp_3d[None]
    kp = convert_kps(kp_3d, src='spin', dst='spin', flip=True)
    pelvis = (kp[:, 27, :] + kp[:, 28, :]) / 2
    kp = kp - pelvis[:, None, :]
    kp[:, :, 0] = -kp[:, :, 0]
    kp = kp + pelvis[:, None, :]
    return kp[0] if squeeze else kp


def smpl_pose_hflip(pose: np.ndarray) -> np.ndarray:
    """Mirror SMPL axis-angle pose (T, 72): swap left/right joints and negate
    the y/z rotation components. Matches the reference's loop bounds, which
    leave the last joint (rightHandIndex1) untouched."""
    squeeze = pose.ndim == 1
    pose = np.reshape(pose, (-1, 24, 3))
    flipped = pose.copy()
    names = SMPL_JOINT_NAMES
    flipped_names = [flip_name(n) for n in names]
    for idx in range(23):
        src = names.index(flipped_names[idx])
        flipped[:, idx, 0] = pose[:, src, 0]
        flipped[:, idx, 1:] = -pose[:, src, 1:]
    flipped = np.reshape(flipped, (-1, 72))
    return flipped[0] if squeeze else flipped
