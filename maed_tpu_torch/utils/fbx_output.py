"""SMPL pose sequence -> FBX animation export (runs inside Blender).

Port of ``maed_tpu/utils/fbx_output.py``, unchanged but for the reading of
the pkl. It needs Blender's ``bpy`` (and an SMPL FBX template file),
imported inside :func:`export_fbx`, so nothing else of the port depends on
Blender. :func:`main` reads ``inference.pkl`` with joblib where it is
installed, else as a plain pickle (``data/dataset.py::read_pickled``).

Usage (inside Blender, with the repository on its Python path):
  blender -b -P maed_tpu_torch/utils/fbx_output.py -- \
      --input inference.pkl --output out.fbx \
      --fbx_template data/smpl_data/SMPL_m_unityDoubleBlends_lbs_10_scale5_207_v1.0.0.fbx
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

# SMPL joint -> FBX armature bone names (the standard SMPL-maya rig naming).
BONE_NAMES = [
    "Pelvis", "L_Hip", "R_Hip", "Spine1", "L_Knee", "R_Knee", "Spine2",
    "L_Ankle", "R_Ankle", "Spine3", "L_Foot", "R_Foot", "Neck", "L_Collar",
    "R_Collar", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand",
]


def rodrigues_to_quat(aa):
    """Axis-angle (3,) -> quaternion (w, x, y, z) without external deps."""
    angle = float(np.linalg.norm(aa))
    if angle < 1e-8:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = np.asarray(aa) / angle
    s = math.sin(angle / 2.0)
    return np.array([math.cos(angle / 2.0), axis[0] * s, axis[1] * s, axis[2] * s])


def export_fbx(poses: np.ndarray, output_path: str, fbx_template: str,
               fps: int = 30, gender_prefix: str = "m_avg_",
               trans: np.ndarray | None = None, start_origin: bool = False):
    """poses: (T, 72) axis-angle SMPL pose sequence.

    trans: optional (T, 3) per-frame root translations in meters: keyframes
    the Pelvis bone's location, 100*(trans[1], trans[2], trans[0]) cm
    relative to the rest pelvis head. None (default) keyframes rotations
    only. start_origin subtracts frame 0's (x, y) so the animation starts at
    the scene origin."""
    try:
        import bpy
        from mathutils import Quaternion, Vector
    except ImportError as e:
        raise RuntimeError(
            "fbx export requires Blender's bpy (run this script inside "
            "`blender -b -P ...`)"
        ) from e

    scene = bpy.data.scenes["Scene"]
    scene.render.fps = fps
    scene.frame_start = 1
    scene.frame_end = len(poses)

    if "Cube" in bpy.data.objects:
        bpy.data.objects["Cube"].select_set(True)
        bpy.ops.object.delete()

    bpy.ops.import_scene.fbx(filepath=fbx_template)
    armature = bpy.data.objects["Armature"]
    bpy.context.view_layer.objects.active = armature

    pelvis_position = None
    if trans is not None:
        trans = np.asarray(trans, np.float64).reshape(-1, 3)
        if len(trans) != len(poses):
            raise ValueError(f"trans has {len(trans)} frames, poses {len(poses)}")
        if start_origin:
            trans = trans - np.array([trans[0, 0], trans[0, 1], 0.0])
        # rest pelvis head in armature units ([cm]: the template armature is
        # scaled); a COPY — the edit-bone reference mutates with keyframes
        bpy.ops.object.mode_set(mode="EDIT")
        pelvis_position = Vector(
            armature.data.edit_bones[gender_prefix + BONE_NAMES[0]].head)
        bpy.ops.object.mode_set(mode="OBJECT")

    bpy.ops.object.mode_set(mode="POSE")

    for frame_i, pose in enumerate(np.asarray(poses).reshape(-1, 24, 3)):
        scene.frame_set(frame_i + 1)
        if pelvis_position is not None:
            # SMPL trans (x, y, z) m -> Blender pelvis-local (y, z, x) cm,
            # relative to the rest pelvis head
            t = trans[frame_i]
            pelvis = armature.pose.bones[gender_prefix + BONE_NAMES[0]]
            pelvis.location = (
                Vector((100.0 * t[1], 100.0 * t[2], 100.0 * t[0]))
                - pelvis_position)
            pelvis.keyframe_insert("location", frame=frame_i + 1)
        for joint_i, bone_name in enumerate(BONE_NAMES):
            full = gender_prefix + bone_name
            if full not in armature.pose.bones:
                continue
            bone = armature.pose.bones[full]
            w, x, y, z = rodrigues_to_quat(pose[joint_i])
            bone.rotation_mode = "QUATERNION"
            bone.rotation_quaternion = Quaternion((w, x, y, z))
            bone.keyframe_insert("rotation_quaternion", frame=frame_i + 1)

    bpy.ops.object.mode_set(mode="OBJECT")
    bpy.ops.export_scene.fbx(
        filepath=output_path, use_selection=False, add_leaf_bones=False,
        bake_anim=True,
    )
    print(f"exported {len(poses)} frames to {output_path}")


def main():
    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else sys.argv[1:]
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="inference.pkl path")
    parser.add_argument("--output", required=True, help="output .fbx path")
    parser.add_argument("--fbx_template", required=True)
    parser.add_argument("--fps", type=int, default=30)
    parser.add_argument("--trans_file", default="",
                        help=".npy of (T, 3) per-frame root translations "
                        "(meters); keyframes the Pelvis location")
    parser.add_argument("--start_origin", action="store_true",
                        help="subtract frame 0's (x, y) translation")
    args = parser.parse_args(argv)

    from maed_tpu_torch.data.dataset import read_pickled

    data = read_pickled(args.input)
    poses = np.asarray(data["pred_theta"])[:, 3:75]
    trans = np.load(args.trans_file) if args.trans_file else None
    export_fbx(poses, args.output, args.fbx_template, fps=args.fps,
               trans=trans, start_origin=args.start_origin)


if __name__ == "__main__":
    main()
