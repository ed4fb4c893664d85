"""Debug visualization: skeleton overlays, 3D pose plots, and
batch-inspection grids.

Port of ``maed_tpu/utils/vis.py``. Everything there but the drawing is
numpy and is unchanged here. The JAX package draws with cv2, which the port
does without: :func:`draw_line` and :func:`draw_disk` draw the pixels of
``cv2.line(..., thickness, LINE_8)`` and ``cv2.circle(..., -1)`` (the
Bresenham walk, the clipping and, for a thick line, the filled polygon with
round caps, in the fixed-point arithmetic cv2 uses), checked equal to
OpenCV 5.0's, bit for bit, at thickness 1 and 2 and at radii 1 to 7, with
end points and centres inside and outside the image
(``tests/test_torch_port_demo.py``); :func:`hsv_to_bgr_u8` is
``cv2.cvtColor(..., COLOR_HSV2BGR)`` on uint8 images, equal to OpenCV 5.0's
on every HSV triple (``tests/test_torch_port_tools.py``). :func:`visualize_sequence` needs
matplotlib, imported in the function: where it is absent it raises and
names it.
"""

from __future__ import annotations

import numpy as np

from maed_tpu_torch.data.keypoints import get_joint_names

SPIN_SKELETON = [
    (0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 8),
    (8, 9), (9, 10), (10, 11), (8, 12), (12, 13), (13, 14),
    (0, 15), (0, 16), (15, 17), (16, 18),
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# --------------------------------------------------------------------------- #
# cv2's LINE_8 drawing: coordinates of thick lines are 16.16 fixed point
# --------------------------------------------------------------------------- #
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's clipLine to [0, w) x [0, h): the clipped end points, or None
    when the segment misses the rectangle."""
    if w <= 0 or h <= 0:
        return None
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2, c2 = a, 0
    return (x1, y1, x2, y2) if (c1 | c2) == 0 else None


def _hline(img, y, xl, xr, color):
    h, w = img.shape[:2]
    if 0 <= y < h:
        xl, xr = max(xl, 0), min(xr, w - 1)
        if xl <= xr:
            img[y, xl:xr + 1] = color


def _put(img, pts, color):
    pts = [(x, y) for x, y in pts if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]]
    if pts:
        xs, ys = zip(*pts)
        img[list(ys), list(xs)] = color


def _line(img, x1, y1, x2, y2, color):
    """A one-pixel 8-connected line between integer points, walked from its
    left end after clipping to the image (cv2's Line / LineIterator)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, x, y, pts = dx - 2 * dy, x1, y1, []
    for _ in range(dx + 1):
        pts.append((x, y))
        minor = err < 0  # also step along the minor axis
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0
    _put(img, pts, color)


def _line_fixed(img, p1, p2, color):
    """A one-pixel line between 16.16 fixed-point points, stepped along its
    major axis from the rounded start (cv2's Line2: a polygon's outline)."""
    h, w = img.shape[:2]
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy, x1, x2, y1, y2 = -dy, x2, x1, y2, y1
        step, count = _cdiv(dy << XY_SHIFT, ax | 1), (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx, x1, x2, y1, y2 = -dx, x2, x1, y2, y1
        step, count = _cdiv(dx << XY_SHIFT, ay | 1), (y2 - y1) >> XY_SHIFT
    x1, y1 = x1 + HALF, y1 + HALF
    pts = [((x2 + HALF) >> XY_SHIFT, (y2 + HALF) >> XY_SHIFT)]
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(count + 1):
            pts.append((x1, y1 >> XY_SHIFT))
            x1, y1 = x1 + 1, y1 + step
    else:
        y1 >>= XY_SHIFT
        for _ in range(count + 1):
            pts.append((x1 >> XY_SHIFT, y1))
            x1, y1 = x1 + step, y1 + 1
    _put(img, pts, color)


def _fill_convex_poly(img, v, color):
    """A convex polygon of 16.16 fixed-point vertices: its outline, then a
    scan of spans between its two edge walks (cv2's FillConvexPoly)."""
    h, w = img.shape[:2]
    npts = len(v)
    xs_, ys_ = [p[0] for p in v], [p[1] for p in v]
    ymin = min(ys_)
    imin = ys_.index(ymin)
    p0 = v[-1]
    for p in v:
        _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (min(xs_) + HALF) >> XY_SHIFT, (max(xs_) + HALF) >> XY_SHIFT
    ymin, ymax = (ymin + HALF) >> XY_SHIFT, (max(ys_) + HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymin >= h or xmin >= w:
        return
    ymax = min(ymax, h - 1)
    edges = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
             {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    left_over, y = npts, ymin
    while True:
        for e in edges:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % npts
            while True:
                left_over -= 1
                if left_over < 0:
                    break
                ty = (v[idx][1] + HALF) >> XY_SHIFT
                if ty > y:  # the next edge that spans this row
                    e.update(ye=ty, x=v[idx0][0], idx=idx,
                             dx=_cdiv((v[idx][0] - v[idx0][0]) * 2 + (ty - y), 2 * (ty - y)))
                    break
                idx0, idx = idx, (idx + e["di"]) % npts
        if left_over < 0:
            break
        if y >= 0:
            a, b = sorted((edges[0]["x"], edges[1]["x"]))
            xl, xr = (a + HALF) >> XY_SHIFT, (b + HALF) >> XY_SHIFT
            if xr >= 0 and xl < w:
                _hline(img, y, xl, xr, color)
        for e in edges:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


# cv2's uint8 HSV -> BGR: each row's first whole blocks of HSV_VECTOR_PIXELS
# pixels take its vector path (sector by truncation, no grey special case,
# the result truncated), the rest its scalar path (sector by floor, grey
# where s = 0, the result rounded); both form 1 - s h and 1 - s (1 - h) with
# one rounding (a fused multiply-add). 32: a row of AVX2's 32-byte vectors.
HSV_VECTOR_PIXELS = 32
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _fused_one_minus(s: np.ndarray, h: np.ndarray) -> np.ndarray:
    """f32(1 - s h) with one rounding: the f32 product is exact in f64."""
    return (1.0 - s.astype(np.float64) * h.astype(np.float64)).astype(np.float32)


def _hsv_to_bgr_path(hsv: np.ndarray, vector: bool) -> np.ndarray:
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    if vector:
        sector = np.trunc(h)
        frac = h - sector
        sector = (sector - np.trunc(sector * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    else:
        h = np.fmod(h, f32(6.0))
        sector = np.floor(h)
        frac = h - sector
        sector = sector.astype(np.int64)
    tab = np.stack([v, v * (f32(1.0) - s), v * _fused_one_minus(s, frac),
                    v * _fused_one_minus(s, f32(1.0) - frac)], -1).astype(f32)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], -1)
    if not vector:
        bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    x = bgr.astype(f32) * f32(255.0)
    return np.clip(np.trunc(x) if vector else np.rint(x), 0, 255).astype(np.uint8)


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)`` for an (H, W, 3) uint8 image
    (hue 0 to 179), OpenCV 5.0's arithmetic bit for bit (see
    HSV_VECTOR_PIXELS)."""
    hsv = np.asarray(hsv, np.uint8)
    if hsv.ndim != 3 or hsv.shape[2] != 3:
        raise ValueError(f"hsv_to_bgr_u8 takes (H, W, 3) uint8, got {hsv.shape}")
    cut = hsv.shape[1] // HSV_VECTOR_PIXELS * HSV_VECTOR_PIXELS
    out = np.empty_like(hsv)
    out[:, :cut] = _hsv_to_bgr_path(hsv[:, :cut], vector=True)
    out[:, cut:] = _hsv_to_bgr_path(hsv[:, cut:], vector=False)
    return out


def draw_disk(img: np.ndarray, center, radius: int, color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)``: the midpoint circle's
    rows filled, clipped to the image. Draws into ``img`` and returns it."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, 2 * int(radius) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            _hline(img, y, cx - half, cx + half, color)
        dy, err, plus = dy + 1, err + plus, plus + 2
        if err > 0:
            err, dx, minus = err - minus, dx - 1, minus - 2
    return img


def draw_line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` with LINE_8. A thick
    line is clipped to the image widened by its thickness, then drawn as the
    polygon of its width with a filled disk at each end. Draws into ``img``
    and returns it."""
    x1, y1, x2, y2 = int(pt1[0]), int(pt1[1]), int(pt2[0]), int(pt2[1])
    if thickness <= 1:
        _line(img, x1, y1, x2, y2, color)
        return img
    h, w = img.shape[:2]
    m = thickness
    clipped = _clip_line(w + 2 * m, h + 2 * m, x1 + m, y1 + m, x2 + m, y2 + m)
    if clipped is None:
        return img
    p = ((clipped[0] - m) << XY_SHIFT, (clipped[1] - m) << XY_SHIFT)
    q = ((clipped[2] - m) << XY_SHIFT, (clipped[3] - m) << XY_SHIFT)
    dx, dy = (p[0] - q[0]) * (1.0 / XY_ONE), (q[1] - p[1]) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    half_width = (thickness << (XY_SHIFT - 1)) + (thickness & 1) * XY_ONE * 0.5
    if abs(r) > np.finfo(np.float64).eps:
        r = half_width / np.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)  # cvRound: half to even, as Python's round
        _fill_convex_poly(img, [(p[0] + ox, p[1] + oy), (p[0] - ox, p[1] - oy),
                                (q[0] - ox, q[1] - oy), (q[0] + ox, q[1] + oy)], color)
    cap = ((thickness << (XY_SHIFT - 1)) + HALF) >> XY_SHIFT
    for e in (p, q):
        draw_disk(img, ((e[0] + HALF) >> XY_SHIFT, (e[1] + HALF) >> XY_SHIFT), cap, color)
    return img


# --------------------------------------------------------------------------- #


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalized float (H, W, 3) -> uint8 RGB."""
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def draw_skeleton(img: np.ndarray, kp_2d: np.ndarray, normalized: bool = True,
                  skeleton=SPIN_SKELETON, vis_thresh: float = 0.3) -> np.ndarray:
    """Draw keypoints + bones; kp in [-1,1] when normalized, else pixels."""
    out = img.copy()
    h, w = img.shape[:2]
    kp = kp_2d.copy()
    if normalized:
        kp[:, 0] = (kp[:, 0] + 1) * 0.5 * w
        kp[:, 1] = (kp[:, 1] + 1) * 0.5 * h
    conf = kp[:, 2] if kp.shape[1] > 2 else np.ones(len(kp))
    for a, b in skeleton:
        if a < len(kp) and b < len(kp) and conf[a] > vis_thresh and conf[b] > vis_thresh:
            draw_line(out, kp[a, :2].astype(int), kp[b, :2].astype(int), (0, 255, 0), 1)
    for i, p in enumerate(kp):
        if conf[i] > vis_thresh:
            draw_disk(out, p[:2].astype(int), 2, (255, 0, 0))
    return out


def batch_grid(images: np.ndarray, kp_2d: np.ndarray | None = None,
               max_items: int = 16, normalized: bool = True) -> np.ndarray:
    """(N, H, W, 3) normalized batch -> one uint8 grid image for logging."""
    n = min(len(images), max_items)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h, w = images.shape[1:3]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(n):
        img = denormalize_image(images[i])
        if kp_2d is not None:
            img = draw_skeleton(img, kp_2d[i], normalized=normalized)
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
    return grid


def joint_names(fmt: str = "spin"):
    return get_joint_names(fmt)


# A named debug palette (ColorBrewer picks) for per-limb coloring.
COLORS = {
    "pink": (197, 27, 125), "light_pink": (233, 163, 201),
    "light_green": (161, 215, 106), "green": (77, 146, 33),
    "red": (215, 48, 39), "light_red": (252, 146, 114),
    "light_orange": (252, 141, 89), "purple": (118, 42, 131),
    "light_purple": (175, 141, 195), "light_blue": (145, 191, 219),
    "blue": (69, 117, 180), "gray": (130, 130, 130),
    "white": (255, 255, 255),
}


def get_colors():
    return {k: np.array(v) for k, v in COLORS.items()}


def draw_smpl_joints2d(joints2d: np.ndarray, image: np.ndarray,
                       kintree_table: np.ndarray | None = None) -> np.ndarray:
    """Draw a 2D SMPL skeleton from a (2, 24) parent/child kintree table into
    ``image``, alternating the palette's red and blue per bone; the SMPL tree
    of ops/joints.py when no table is given."""
    if kintree_table is None:
        from maed_tpu_torch.ops.joints import SMPL_PARENTS

        kintree_table = np.stack([np.asarray(SMPL_PARENTS),
                                  np.arange(len(SMPL_PARENTS))])
    rcolor, lcolor = COLORS["red"], COLORS["blue"]
    out = image
    pts = np.asarray(joints2d)[:, :2].astype(int)
    for i in range(1, kintree_table.shape[1]):
        j1, j2 = int(kintree_table[0][i]), int(kintree_table[1][i])
        color = lcolor if i % 2 == 0 else rcolor
        draw_line(out, pts[j1], pts[j2], color, thickness=2)
        draw_disk(out, pts[j1], 4, color)
        draw_disk(out, pts[j2], 4, color)
    return out


H36M_17_CONNECTIONS = [
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8),
    (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15),
    (15, 16),
]
_H36M_17_LEFT = np.array(
    [0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0], dtype=bool)


def show_3d_pose(joints3d: np.ndarray, ax, radius: float = 40.0,
                 lcolor: str = "#ff0000", rcolor: str = "#0000ff"):
    """Plot a 17-joint h36m-topology 3D pose on a matplotlib 3D axis,
    root-centered cube limits."""
    vals = np.asarray(joints3d)
    for ind, (i, j) in enumerate(H36M_17_CONNECTIONS):
        seg = np.stack([vals[i], vals[j]])
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], lw=2,
                c=lcolor if _H36M_17_LEFT[ind] else rcolor)
    xr, yr, zr = vals[0, :3]
    ax.set_xlim3d([xr - radius, xr + radius])
    ax.set_ylim3d([yr - radius, yr + radius])
    ax.set_zlim3d([zr - radius, zr + radius])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")


def visualize_sequence(sequence: np.ndarray, radius: float = 0.6) -> np.ndarray:
    """Render a (T, 17*3) or (T, 17, 3) pose sequence to a (T, H, W, 3)
    uint8 frame stack (feed them to demo_utils.images_to_video for a clip)."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("visualize_sequence needs matplotlib, which is not installed") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    seq = np.asarray(sequence)
    seq = seq.reshape((seq.shape[0], -1, 3))
    frames = []
    fig = plt.figure(figsize=(4, 4))
    try:
        for pose in seq:
            ax = fig.add_subplot(111, projection="3d")
            show_3d_pose(pose, ax, radius=radius)
            ax.view_init(-75, -90)
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
            frames.append(buf.copy())
            fig.clf()
    finally:
        plt.close(fig)
    return np.stack(frames)


# --------------------------------------------------------------------------- #
# mesh-overlay batch grids, composed from the rasterizer in utils/renderer.py
# --------------------------------------------------------------------------- #

def _axis_angle_rotation(angle_deg: float, axis) -> np.ndarray:
    """Rodrigues rotation matrix for the side-view render."""
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    th = np.deg2rad(angle_deg)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)).astype(np.float32)


def render_mesh_overlay(img: np.ndarray, verts: np.ndarray, cam: np.ndarray,
                        faces: np.ndarray, angle: float | None = None,
                        axis=None, color=(0.9, 0.5, 0.4)) -> np.ndarray:
    """Composite a weak-perspective SMPL mesh onto a uint8 image.

    cam is the model's (s, tx, ty) weak-perspective triple
    (pred_theta[:3]); angle/axis rotate the mesh about its centroid first
    (a side view)."""
    from maed_tpu_torch.utils.renderer import Renderer

    verts = np.asarray(verts, np.float32)
    if angle is not None:
        R = _axis_angle_rotation(angle, axis if axis is not None else [0, 1, 0])
        center = verts.mean(axis=0, keepdims=True)
        verts = (verts - center) @ R.T + center
    s, tx, ty = np.asarray(cam, np.float32)[:3]
    h, w = img.shape[:2]
    return Renderer(resolution=(w, h)).render(
        img, verts, np.asarray(faces), np.array([s, s, tx, ty], np.float32),
        color=color,
    )


def visualize_preds(image: np.ndarray, preds: dict, faces: np.ndarray,
                    target: dict | None = None,
                    normalized_image: bool = True) -> np.ndarray:
    """One sample's inspection strip:
    [image | pred skeleton | (target skeleton) | mesh render | side render].

    preds: per-sample {'theta' (85,), 'kp_2d' (K, 2|3), 'verts' (V, 3)};
    target (optional): {'kp_2d' (K, 2|3)}. image: (H, W, 3) ImageNet-
    normalized float (normalized_image=True) or uint8."""
    img = denormalize_image(image) if normalized_image else image.copy()

    cam = np.asarray(preds["theta"])[:3]
    kp = np.asarray(preds["kp_2d"])
    if kp.shape[-1] == 2:
        kp = np.concatenate([kp, np.ones_like(kp[:, :1])], axis=-1)
    panels = [img, draw_skeleton(img, kp)]
    if target is not None and "kp_2d" in target:
        panels.append(draw_skeleton(img, np.asarray(target["kp_2d"])))
    verts = np.asarray(preds["verts"])
    panels.append(render_mesh_overlay(img, verts, cam, faces))
    panels.append(render_mesh_overlay(
        np.zeros_like(img), verts, cam, faces, angle=90, axis=[0, 1, 0]))
    return np.hstack(panels)


def batch_visualize_preds(images: np.ndarray, preds: dict, faces: np.ndarray,
                          target: dict | None = None, max_images: int = 16,
                          idxs=None) -> np.ndarray:
    """(N, H, W, 3) batch -> one vertically-stacked strip per sample."""
    n = min(len(images), max_images)
    rows = []
    for i in (range(n) if idxs is None else idxs):
        p = {k: np.asarray(v)[i] for k, v in preds.items()}
        t = None if target is None else {k: np.asarray(v)[i] for k, v in target.items()}
        rows.append(visualize_preds(images[i], p, faces, t))
    return np.vstack(rows)


def batch_visualize_vid_preds(video: np.ndarray, preds: dict, faces: np.ndarray,
                              target: dict | None = None,
                              max_video: int = 4) -> np.ndarray:
    """(N, T, H, W, 3) clips -> (N', T, H', W', 3) uint8 prediction video
    grid."""
    video = np.asarray(video)[:max_video]
    n, t = video.shape[:2]
    out = []
    for b in range(n):
        frames = []
        for i in range(t):
            p = {k: np.asarray(v)[b, i] for k, v in preds.items()}
            tg = None if target is None else {
                k: np.asarray(v)[b, i] for k, v in target.items()}
            frames.append(visualize_preds(video[b, i], p, faces, tg))
        out.append(np.stack(frames))
    return np.stack(out)
