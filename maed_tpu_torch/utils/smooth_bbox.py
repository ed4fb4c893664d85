"""Smoothed, interpolated bbox tracks from per-frame 2D keypoints.

Port of ``maed_tpu/utils/smooth_bbox.py`` (numpy and scipy, unchanged):
square boxes over the detected frames, linearly interpolated across gaps,
then median and gaussian filtered per coordinate. The demo's ``--staf_dir``
path and the 3DPW preprocessor's boxes go through it.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import medfilt


def get_single_bbox(kp_2d: np.ndarray, vis_thresh: float = 0.3, square: bool = True):
    """kp (K, 3) -> (cx, cy, h) or None when too few visible joints."""
    vis = kp_2d[:, 2] > vis_thresh
    if vis.sum() < 2:
        return None
    pts = kp_2d[vis, :2]
    mn, mx = pts.min(axis=0), pts.max(axis=0)
    center = (mn + mx) / 2
    size = (mx - mn).max() if square else (mx - mn)
    return np.array([center[0], center[1], float(size)])


def get_all_bbox_params(kps: np.ndarray, vis_thresh: float = 0.3):
    """kps (T, K, 3) -> (bbox_params (T', 3), start, end) over the detected
    span, with linear interpolation across missing frames."""
    params = []
    valid = []
    for t, kp in enumerate(kps):
        b = get_single_bbox(kp, vis_thresh)
        if b is not None:
            params.append(b)
            valid.append(t)
    if not params:
        return np.zeros((0, 3)), 0, 0
    start, end = valid[0], valid[-1]
    filled = np.zeros((end - start + 1, 3))
    vi = 0
    for t in range(start, end + 1):
        if t in valid:
            filled[t - start] = params[vi]
            vi += 1
        else:
            prev_t = valid[vi - 1]
            next_t = valid[vi]
            w = (t - prev_t) / (next_t - prev_t)
            filled[t - start] = (1 - w) * params[vi - 1] + w * params[vi]
    return filled, start, end + 1


def smooth_bbox_params(bbox_params: np.ndarray, kernel_size: int = 11,
                       sigma: float = 8.0) -> np.ndarray:
    """Median + gaussian filter each bbox coordinate track."""
    if len(bbox_params) == 0:
        return bbox_params
    ks = min(kernel_size, len(bbox_params) // 2 * 2 + 1)
    smoothed = np.array([medfilt(c, ks) for c in bbox_params.T]).T
    return np.array([gaussian_filter1d(c, sigma) for c in smoothed.T]).T
