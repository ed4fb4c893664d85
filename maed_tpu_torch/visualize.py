"""Visualization CLI of the port: render the predicted SMPL meshes over the
source frames.

    python -m maed_tpu_torch.visualize --input_file <dir>/inference.pkl \
        --output_folder out/ [--alpha 0.8] [--allow_synthetic_smpl]

Port of the JAX package's ``visualize.py``: reads the Evaluator's
``inference.pkl`` ({pred_theta, pred_verts, paths, bboxes}; joblib where it
is installed, else a plain pickle), converts the crop camera to the
original image's, and composites each mesh with the host rasterizer of
``utils/renderer.py``. Frames are read through ``utils/image_io.py`` (JPEG
only) and the overlays written as ``{i:06d}_{stem}.png``, not with the
frame's own extension: the port has no JPEG encoder. The body model gives
the faces; it must be the real one unless ``--allow_synthetic_smpl``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import numpy as np


def render_inference_pkl(input_file: str, output_folder: str, alpha: float = 0.8,
                         allow_synthetic_smpl: bool = False) -> int:
    """Render every frame of an Evaluator inference.pkl; returns the count.

    Shared by this CLI and the demo. Without the SMPL files under
    data/smpl_data it fails with where to place them, unless the caller
    accepts the synthetic body (rendered with its synthetic triangulation)."""
    from maed_tpu_torch.data.dataset import read_pickled
    from maed_tpu_torch.utils.demo_utils import convert_crop_cam_to_orig_img
    from maed_tpu_torch.utils.image_io import read_rgb, write_png
    from maed_tpu_torch.utils.renderer import Renderer
    from maed_tpu_torch.utils.smpl_io import find_smpl_model

    data = read_pickled(input_file)
    pred_verts = np.asarray(data["pred_verts"])
    bboxes = np.asarray(data["bboxes"])
    paths = list(np.asarray(data["paths"]).ravel())
    cams = np.asarray(data["pred_theta"])[:, :3]

    # the faces only: a host-side array of the body, whatever its device
    smpl = find_smpl_model(allow_synthetic=allow_synthetic_smpl, device="cpu")
    faces = smpl.faces
    if faces is None:
        raise SystemExit("No SMPL faces available (real SMPL model required)")

    os.makedirs(output_folder, exist_ok=True)
    renderer = None
    raster_s = 0.0
    for i, path in enumerate(paths):
        img = read_rgb(path)
        h, w = img.shape[:2]
        if renderer is None:
            renderer = Renderer(resolution=(w, h))
        orig_cam = convert_crop_cam_to_orig_img(cams[i:i + 1], bboxes[i:i + 1], w, h)[0]
        t0 = time.perf_counter()
        out = renderer.render(img, pred_verts[i], faces, orig_cam, alpha=alpha)
        raster_s += time.perf_counter() - t0
        stem = osp.splitext(osp.basename(path))[0]
        write_png(osp.join(output_folder, f"{i:06d}_{stem}.png"), out)
        if i % 50 == 0:
            print(f"rendered {i + 1}/{len(paths)}")
    print(f"wrote {len(paths)} frames to {output_folder}; the rasterizer "
          f"{raster_s / max(len(paths), 1):.4f} s a frame")
    return len(paths)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_file", type=str, required=True)
    parser.add_argument("--output_folder", type=str, default="vis_output")
    parser.add_argument("--alpha", type=float, default=0.8)
    parser.add_argument("--allow_synthetic_smpl", action="store_true",
                        help="render with a RANDOM body model when the real "
                        "SMPL artifacts are missing (smoke runs only)")
    args = parser.parse_args(argv)
    render_inference_pkl(args.input_file, args.output_folder, args.alpha,
                         args.allow_synthetic_smpl)


if __name__ == "__main__":
    main()
