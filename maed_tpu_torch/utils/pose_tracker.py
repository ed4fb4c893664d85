"""Multi-person pose tracking through an external OpenPose/STAF binary.

Port of ``maed_tpu/utils/pose_tracker.py`` (subprocess and json,
unchanged): runs the tracker binary over a video, parses its per-frame json
and groups the detections into tracks keyed by person id.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import subprocess
import tempfile

import numpy as np


def run_openpose(video_file: str, output_folder: str, staf_folder: str,
                 vis: bool = False):
    pwd = os.getcwd()
    os.chdir(staf_folder)
    render = "1" if vis else "0"
    display = "2" if vis else "0"
    cmd = [
        "build/examples/openpose/openpose.bin",
        "--model_pose", "BODY_21A",
        "--tracking", "1",
        "--render_pose", render,
        "--video", video_file,
        "--write_json", output_folder,
        "--display", display,
    ]
    try:
        subprocess.run(cmd, check=True)
    finally:
        os.chdir(pwd)


def read_posetrack_keypoints(output_folder: str):
    """Parse tracker jsons into {person_id: {'joints2d': [...], 'frames': [...]}}"""
    people = {}
    for idx, result_file in enumerate(sorted(os.listdir(output_folder))):
        with open(osp.join(output_folder, result_file)) as f:
            data = json.load(f)
        for person in data["people"]:
            person_id = person["person_id"][0]
            joints2d = person["pose_keypoints_2d"]
            if person_id in people:
                people[person_id]["joints2d"].append(joints2d)
                people[person_id]["frames"].append(idx)
            else:
                people[person_id] = {"joints2d": [joints2d], "frames": [idx]}
    for k in people:
        people[k]["joints2d"] = np.array(people[k]["joints2d"]).reshape(
            (len(people[k]["joints2d"]), -1, 3)
        )
        people[k]["frames"] = np.array(people[k]["frames"])
    return people


def run_posetracker(video_file: str, staf_folder: str,
                    posetrack_output_folder: str | None = None,
                    display: bool = False):
    """Track the people of ``video_file`` with the STAF build in
    ``staf_folder``; the json goes to a folder under
    ``posetrack_output_folder`` (default: the temporary directory), removed
    once read."""
    posetrack_output_folder = osp.join(
        posetrack_output_folder or osp.join(tempfile.gettempdir(), "posetrack_output"),
        f"{osp.basename(video_file).replace('.', '_')}_posetrack",
    )
    os.makedirs(posetrack_output_folder, exist_ok=True)
    run_openpose(video_file, posetrack_output_folder, staf_folder, vis=display)
    people_dict = read_posetrack_keypoints(posetrack_output_folder)
    shutil.rmtree(posetrack_output_folder)
    return people_dict
