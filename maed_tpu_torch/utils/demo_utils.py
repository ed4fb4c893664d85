"""Inference and visualization helpers: the crop camera to the original
image's camera, video <-> frames and trimming through ffmpeg, per-frame
render grouping, and optional downloads (a URL, YouTube through pytube).

Port of ``maed_tpu/utils/demo_utils.py``. The numpy functions are
unchanged. The video functions go through ffmpeg only and raise, naming it,
where it is absent: the JAX package's cv2 fallbacks cannot exist in a port
without cv2. :func:`video_to_images` writes ``%06d.jpg`` frames (``-q:v
2``) where the JAX package writes ``%06d.png``, because the port's data
pipeline decodes JPEG frames only.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil
import subprocess
import tempfile

import numpy as np


def _ffmpeg(what: str) -> str:
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError(f"{what} needs ffmpeg, which is not on PATH (the port has no cv2 "
                           "video fallback)")
    return path


def convert_crop_cam_to_orig_img(cam: np.ndarray, bbox: np.ndarray,
                                 img_width: int, img_height: int) -> np.ndarray:
    """Weak-perspective cam predicted in the crop's frame -> cam for the
    original image's frame.

    cam (N, 3): (s, tx, ty) in crop coords; bbox (N, 4): (cx, cy, w, h).
    Returns (N, 4): (sx, sy, tx, ty) in original-image normalized coords.
    """
    cx, cy, w, h = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    hw, hh = img_width / 2.0, img_height / 2.0
    sx = cam[:, 0] * (1.0 / (img_width / w))
    sy = cam[:, 0] * (1.0 / (img_height / h))
    tx = ((cx - hw) / hw / sx) + cam[:, 1]
    ty = ((cy - hh) / hh / sy) + cam[:, 2]
    return np.stack([sx, sy, tx, ty]).T


def download_youtube_clip(url: str, download_folder: str) -> str:
    """Fetch a YouTube video for the in-the-wild demo. pytube is an optional
    dependency: without it this raises instead of failing deep inside the
    demo."""
    try:
        from pytube import YouTube
    except ImportError as e:
        raise RuntimeError(
            "download_youtube_clip needs the optional 'pytube' package "
            "(pip install pytube); alternatively download the video "
            "yourself and pass the local file to the demo") from e
    os.makedirs(download_folder, exist_ok=True)
    return YouTube(url).streams.first().download(output_path=download_folder)


def trim_videos(filename: str, start_time: float, end_time: float,
                output_filename: str):
    """Cut [start_time, end_time) seconds out of a video with ffmpeg."""
    ffmpeg = _ffmpeg("trim_videos")
    os.makedirs(osp.dirname(output_filename) or ".", exist_ok=True)
    subprocess.run([ffmpeg, "-y", "-i", filename, "-ss", str(start_time),
                    "-t", str(end_time - start_time), "-c:v", "libx264", "-c:a", "copy",
                    "-v", "error", output_filename], check=True)


def download_url(url: str, outdir: str) -> str:
    """Download a file into outdir, skipping files that already exist.
    Returns the local path."""
    import urllib.parse
    import urllib.request

    os.makedirs(outdir, exist_ok=True)
    name = osp.basename(urllib.parse.urlparse(url).path) or "download"
    out = osp.join(outdir, name)
    if not osp.isfile(out):
        urllib.request.urlretrieve(url, out)
    return out


def prepare_rendering_results(results: dict, nframes: int):
    """Regroup per-person tracking results into per-frame render dicts,
    depth-ordered back-to-front by the weak-perspective y-scale. ``results``
    maps person_id -> {'frame_ids', 'verts', 'orig_cam'}; returns a list of
    nframes OrderedDicts person_id -> {'verts', 'cam'}."""
    from collections import OrderedDict

    frames = [dict() for _ in range(nframes)]
    for person_id, person in results.items():
        for idx, frame_id in enumerate(person["frame_ids"]):
            frames[frame_id][person_id] = {
                "verts": person["verts"][idx],
                "cam": person["orig_cam"][idx],
            }
    ordered = []
    for frame in frames:
        pids = list(frame.keys())
        order = np.argsort([frame[p]["cam"][1] for p in pids])
        ordered.append(OrderedDict((pids[i], frame[pids[i]]) for i in order))
    return ordered


def video_to_images(vid_file: str, img_folder: str | None = None,
                    return_info: bool = False):
    """The frames of a video as ``<img_folder>/%06d.jpg`` (1-based, ffmpeg's
    image2 numbering); with ``return_info`` also their count and (H, W, 3)."""
    ffmpeg = _ffmpeg("video_to_images")
    if img_folder is None:
        img_folder = osp.join(tempfile.gettempdir(), osp.basename(vid_file).replace(".", "_"))
    os.makedirs(img_folder, exist_ok=True)
    subprocess.run([ffmpeg, "-i", vid_file, "-f", "image2", "-q:v", "2", "-v", "error",
                    f"{img_folder}/%06d.jpg"], check=True)
    if return_info:
        from maed_tpu_torch.utils.image_io import image_size

        h, w = image_size(osp.join(img_folder, "000001.jpg"))
        return img_folder, len(os.listdir(img_folder)), (h, w, 3)
    return img_folder


def images_to_video(img_folder: str, output_vid_file: str, fps: int = 30,
                    pattern: str = "%06d.png"):
    ffmpeg = _ffmpeg("images_to_video")
    os.makedirs(osp.dirname(output_vid_file) or ".", exist_ok=True)
    subprocess.run([ffmpeg, "-framerate", str(fps), "-y", "-i", f"{img_folder}/{pattern}",
                    "-c:v", "libx264", "-pix_fmt", "yuv420p", "-v", "error", output_vid_file],
                   check=True)
