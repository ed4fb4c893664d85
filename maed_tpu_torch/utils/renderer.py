"""Mesh-over-image rendering for visualization (a host tool).

Port of ``maed_tpu/utils/renderer.py``: the numpy z-buffer rasterizer with
depth shading and the alpha compositing, unchanged, so the same inputs give
the same pixels. The JAX package's pyrender probe is left out: it chose a
backend that ``render`` never used. It runs on the host, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np


def weak_perspective_to_screen(verts: np.ndarray, cam: np.ndarray, width: int, height: int):
    """verts (V, 3) in model space, cam (sx, sy, tx, ty) weak-perspective.

    Returns screen-space (V, 3): x_px, y_px, depth (larger = farther).
    """
    sx, sy, tx, ty = cam
    x = (verts[:, 0] + tx) * sx
    y = (verts[:, 1] + ty) * sy
    # [-1, 1] -> pixels
    xp = (x + 1.0) * 0.5 * width
    yp = (y + 1.0) * 0.5 * height
    return np.stack([xp, yp, verts[:, 2]], axis=1)


def _vertex_normals(verts, faces):
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    vn = np.zeros_like(verts)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-8)


def rasterize_mesh(
    screen_verts: np.ndarray,
    faces: np.ndarray,
    width: int,
    height: int,
    shade: np.ndarray | None = None,
):
    """Z-buffer rasterization. screen_verts (V, 3) with z = depth (camera
    looks down -z: smaller z is closer to the viewer here we use -z ordering).

    Returns (mask (H, W) bool, intensity (H, W) float in [0, 1]).
    """
    zbuf = np.full((height, width), np.inf, np.float32)
    intensity = np.zeros((height, width), np.float32)
    if shade is None:
        shade = np.ones(len(screen_verts), np.float32)

    v2 = screen_verts[faces]  # (F, 3, 3)
    # backface-agnostic; cull fully off-screen triangles
    mins = np.floor(v2[..., :2].min(axis=1)).astype(int)
    maxs = np.ceil(v2[..., :2].max(axis=1)).astype(int)
    keep = (
        (maxs[:, 0] >= 0) & (mins[:, 0] < width)
        & (maxs[:, 1] >= 0) & (mins[:, 1] < height)
    )
    for tri, smn, smx in zip(v2[keep], mins[keep], maxs[keep]):
        x0, y0 = np.maximum(smn, 0)
        x1 = min(smx[0] + 1, width)
        y1 = min(smx[1] + 1, height)
        if x1 <= x0 or y1 <= y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1) + 0.5, np.arange(y0, y1) + 0.5)
        # barycentric coordinates
        (ax, ay), (bx, by), (cx, cy) = tri[0, :2], tri[1, :2], tri[2, :2]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-12:
            continue
        w0 = ((by - cy) * (xs - cx) + (cx - bx) * (ys - cy)) / den
        w1 = ((cy - ay) * (xs - cx) + (ax - cx) * (ys - cy)) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * tri[0, 2] + w1 * tri[1, 2] + w2 * tri[2, 2]
        sub_z = zbuf[y0:y1, x0:x1]
        better = inside & (z < sub_z)
        sub_z[better] = z[better]
        # flat shade: mean depth-based light + fixed ambient
        intensity[y0:y1, x0:x1][better] = 1.0
    mask = np.isfinite(zbuf)
    return mask, zbuf


class Renderer:
    """Weak-perspective mesh overlay compositor."""

    def __init__(self, resolution=(224, 224), wireframe=False):
        self.width, self.height = resolution
        self.wireframe = wireframe

    def render(self, img: np.ndarray, verts: np.ndarray, faces: np.ndarray,
               cam: np.ndarray, color=(0.9, 0.5, 0.4), alpha=0.8) -> np.ndarray:
        """Composite the SMPL mesh onto img (H, W, 3) uint8."""
        h, w = img.shape[:2]
        screen = weak_perspective_to_screen(verts, cam, w, h)
        mask, zbuf = rasterize_mesh(screen, faces, w, h)

        # lambertian-ish shading from depth gradients for a 3D look
        finite = np.where(np.isfinite(zbuf), zbuf, np.nanmax(np.where(np.isfinite(zbuf), zbuf, np.nan)) if mask.any() else 0.0)
        if mask.any():
            zmin, zmax = finite[mask].min(), finite[mask].max()
            shade = 1.0 - 0.6 * (finite - zmin) / max(zmax - zmin, 1e-6)
        else:
            shade = np.zeros_like(zbuf)

        out = img.astype(np.float32).copy()
        overlay = np.asarray(color, np.float32)[None, None] * 255.0 * shade[..., None]
        out[mask] = (1 - alpha) * out[mask] + alpha * overlay[mask]
        return out.astype(np.uint8)
