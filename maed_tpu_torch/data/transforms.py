"""Host-side augmentation stack (numpy and the port's native crop),
clip-coherent like the reference.

Port of ``maed_tpu/data/transforms.py``, whose pixels came from cv2. Here no
path uses cv2: the crop of :class:`CropVideo` and :class:`FusedCropNormalize`
is the native library's (``maed_tpu_torch/native``, the same C++ as the JAX
package's fused path), :func:`gen_crop_trans` solves its 3-point affine in
numpy with the elimination cv2.getAffineTransform runs (the same bits), and
:class:`FusedCropNormalize` takes JPEG bytes straight to the native decode +
crop. The photometric ops, the erase, the flip and :class:`StackNormalize`
are numpy copies. :class:`DeviceCropPack` (DATASET.DEVICE_CROP) leaves the
crop to the device (``ops.image.apply_device_preproc``).

Everything operates on dicts of numpy arrays: {'clip': [HWC uint8 frames],
'kp_2d': (T, 49, 3), 'kp_3d': (T, 49, 4), 'pose': (T, 72), ...}. One
augmentation draw is shared across all frames of a clip. Output of the full
train/val stack: clip (T, H, W, 3), uint8 (DATASET.DEVICE_PREPROC: the model
normalizes on the device) or float32 ImageNet-normalized, kp_2d in [-1, 1].

Each transform takes an explicit np.random.RandomState so the pipeline is
reproducible and shardable (seeded per (epoch, index)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from maed_tpu_torch import native
from maed_tpu_torch.data.keypoints import (
    keypoint_2d_hflip,
    keypoint_3d_hflip,
    smpl_pose_hflip,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _rotate_2d(pt, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32)


def gen_crop_trans(bbox, scale, rot, shift, out_w, out_h):
    """Affine from bbox (cx, cy, w, h) + augmentation to the output patch.
    Built from 3 control points exactly like the reference."""
    src_w = bbox[2] * scale[0]
    src_h = bbox[3] * scale[1]
    # f64 until the final f32 control-point cast, like the reference
    # (crop.py:58: bbox[:2] + bbox[2:] * shift before np.float32(src)) —
    # rounding the shifted center early skews the affine by ~1e-4 px
    src_center = np.asarray(bbox[:2], np.float64) + np.asarray(bbox[2:], np.float64) * np.asarray(shift, np.float64)

    rot_rad = np.pi * rot / 180
    src_downdir = _rotate_2d(np.array([0, src_h * 0.5], np.float32), rot_rad)
    src_rightdir = _rotate_2d(np.array([src_w * 0.5, 0], np.float32), rot_rad)

    dst_center = np.array([out_w * 0.5, out_h * 0.5], np.float32)
    src = np.stack([src_center, src_center + src_downdir, src_center + src_rightdir]).astype(np.float32)
    dst = np.stack(
        [dst_center, dst_center + np.array([0, out_h * 0.5]), dst_center + np.array([out_w * 0.5, 0])]
    ).astype(np.float32)
    return affine_from_points(src, dst)


def affine_from_points(src, dst) -> np.ndarray:
    """The 2x3 affine taking 3 points ``src`` onto ``dst`` ((3, 2) each), as
    cv2.getAffineTransform computes it: its 6x6 system solved in f64 by
    Gaussian elimination with partial pivoting, in its order of operations,
    so the result has the same bits."""
    a = [[0.0] * 6 for _ in range(6)]
    b = [0.0] * 6
    for i in range(3):
        x, y = float(src[i][0]), float(src[i][1])
        a[2 * i][0:3] = [x, y, 1.0]
        a[2 * i + 1][3:6] = [x, y, 1.0]
        b[2 * i], b[2 * i + 1] = float(dst[i][0]), float(dst[i][1])
    for i in range(6):
        k = i
        for j in range(i + 1, 6):
            if abs(a[j][i]) > abs(a[k][i]):
                k = j
        if abs(a[k][i]) < np.finfo(np.float64).eps:
            raise ValueError(f"the control points are collinear: {np.asarray(src).tolist()}")
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, 6):
            alpha = a[j][i] * d
            for m in range(i + 1, 6):
                a[j][m] += alpha * a[i][m]
            b[j] += alpha * b[i]
    for i in range(5, -1, -1):
        s = b[i]
        for m in range(i + 1, 6):
            s -= a[i][m] * b[m]
        b[i] = s / a[i][i]
    return np.array(b, np.float64).reshape(2, 3)


def apply_trans_points(kp, trans):
    """(K, 2+) keypoints through a 2x3 affine; extra channels pass through."""
    xy1 = np.concatenate([kp[:, :2], np.ones((kp.shape[0], 1))], axis=1)
    out = kp.copy()
    out[:, :2] = xy1 @ trans.T
    return out


class CropVideo:
    """Crop-and-augment a clip around per-frame bboxes with one shared
    (scale, rot, shift) draw."""

    def __init__(self, height=224, width=224, rot_jitter=0.0, size_jitter=0.0,
                 random_crop_p=0.0, random_crop_size=0.5):
        self.h, self.w = height, width
        self.rot_jitter = rot_jitter
        self.size_jitter = size_jitter
        self.random_crop_p = random_crop_p
        self.random_crop_size = random_crop_size

    def gen_augmentation(self, rng):
        scale = rng.uniform(1.3 - self.size_jitter, 1.3 + self.size_jitter)
        rot = rng.uniform(-self.rot_jitter, self.rot_jitter)
        if rng.rand() < self.random_crop_p:
            scale = rng.uniform(1.3 - self.random_crop_size, 1.3)
            shift_w = rng.uniform(-(1.3 - scale) / 2.0, (1.3 - scale) / 2.0)
            shift_h = rng.uniform(-(1.3 - scale) / 2.0, (1.3 - scale) / 2.0)
            return (scale, scale), rot, (shift_w, shift_h)
        return (scale, scale), rot, (0.0, 0.0)

    def __call__(self, inst, rng: np.random.RandomState):
        if "bbox" not in inst:
            return inst
        scale, rot, shift = self.gen_augmentation(rng)
        kps = []
        kp_2d = inst.get("kp_2d")
        trans = np.stack([gen_crop_trans(bbox, scale, rot, shift, self.w, self.h)
                          for bbox in inst["bbox"][:len(inst["clip"])]])
        if kp_2d is not None:
            kps = [apply_trans_points(kp_2d[t], m) for t, m in enumerate(trans)]
        out = dict(inst)
        # cv2.warpAffine's bilinear crop with a constant border, to within
        # its fixed-point rounding (1 LSB)
        out["clip"] = list(native.clip_crop_u8(inst["clip"], trans, self.h, self.w))
        if kp_2d is not None:
            out["kp_2d"] = np.stack(kps, axis=0)
        return out


# --------------------------------------------------------------------------- #
# PIL-exact photometric ops. The reference's ColorJitterVideo/Image delegate
# to torchvision.transforms.functional, whose PIL backend is ImageEnhance
# (blend against a degenerate image) for brightness/saturation/contrast and a
# uint8-HSV roll for hue. These vectorized numpy replicas are BIT-EQUAL to
# that path (tests/test_colorjitter_reference_oracle.py runs the reference
# module on real PIL and demands exact equality):
#   * gray: Pillow convert("L") integer formula (L24 >> 16 with +0x8000);
#   * blend: Pillow Blend.c — float arithmetic, TRUNCATING uint8 store;
#   * hsv: Pillow Convert.c rgb2hsv/hsv2rgb_row — float32 divisions/stores
#     but double-literal arithmetic (the 1-ulp difference flips truncated
#     LSBs, so the precision mix matters).
# Parity target: the original MAED's lib/data_utils/transforms/color_jitter.py
# + torchvision/transforms/_functional_pil.py adjust_* semantics.
# --------------------------------------------------------------------------- #

def _pil_gray(img):
    """Pillow convert('L'): (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    r = img[..., 0].astype(np.uint32)
    g = img[..., 1].astype(np.uint32)
    b = img[..., 2].astype(np.uint32)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _pil_blend(degenerate, img, f):
    """Pillow ImageEnhance blend: out = deg + f*(img-deg), truncated uint8."""
    t = degenerate + np.float32(f) * (img.astype(np.float32) - degenerate)
    return np.where(t <= 0, 0, np.where(t >= 255, 255, t)).astype(np.uint8)


def adjust_brightness(img, f):
    return _pil_blend(np.float32(0.0), img, f)


def adjust_saturation(img, f):
    return _pil_blend(_pil_gray(img).astype(np.float32)[..., None], img, f)


def adjust_contrast(img, f):
    # ImageEnhance.Contrast: solid gray at round-half-up mean of convert("L")
    mean = int(_pil_gray(img).astype(np.float64).mean() + 0.5)
    return _pil_blend(np.float32(mean), img, f)


def _rgb_to_hsv_pil(rgb):
    """Pillow Convert.c rgb2hsv_row, vectorized bit-exact (verified against
    PIL over random + structured grids in the oracle test)."""
    r = rgb[..., 0].astype(np.float32)
    g = rgb[..., 1].astype(np.float32)
    b = rgb[..., 2].astype(np.float32)
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    v = maxc.astype(np.uint8)
    eq = maxc == minc
    cr = np.where(eq, 1.0, maxc - minc).astype(np.float32)
    s = (np.where(eq, 0.0, maxc - minc) / np.where(maxc == 0, 1.0, maxc)).astype(np.float32)
    rc = ((maxc - r) / cr).astype(np.float32)
    gc = ((maxc - g) / cr).astype(np.float32)
    bc = ((maxc - b) / cr).astype(np.float32)
    # C source uses double literals: h accumulates in f64, stores to float
    h64 = np.where(
        r == maxc, bc.astype(np.float64) - gc,
        np.where(g == maxc, 2.0 + rc.astype(np.float64) - bc,
                 4.0 + gc.astype(np.float64) - rc))
    h = h64.astype(np.float32)
    h = np.mod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(np.float32)
    uh = np.clip(h.astype(np.float64) * 255.0, 0, 255).astype(np.int32)
    us = np.clip(s.astype(np.float64) * 255.0, 0, 255).astype(np.int32)
    uh = np.where(eq, 0, uh).astype(np.uint8)
    us = np.where(eq, 0, us).astype(np.uint8)
    return np.stack([uh, us, v], axis=-1)


def _hsv_to_rgb_pil(hsv):
    """Pillow Convert.c hsv2rgb_row, vectorized bit-exact (verified
    exhaustively over all 256^3 HSV triples against PIL)."""
    h = hsv[..., 0].astype(np.float64)
    s = hsv[..., 1]
    v = hsv[..., 2]
    h6 = h * 6.0 / 255.0
    i = np.floor(h6).astype(np.int32)
    f = (h6 - i).astype(np.float32)  # float store in C
    fs = (s.astype(np.float64) / 255.0).astype(np.float32)
    fd, fsd = f.astype(np.float64), fs.astype(np.float64)
    vd = v.astype(np.float32).astype(np.float64)
    # C round(): half away from zero; everything here is >= 0
    p = np.clip(np.floor(vd * (1.0 - fsd) + 0.5), 0, 255).astype(np.uint8)
    q = np.clip(np.floor(vd * (1.0 - fsd * fd) + 0.5), 0, 255).astype(np.uint8)
    t = np.clip(np.floor(vd * (1.0 - fsd * (1.0 - fd)) + 0.5), 0, 255).astype(np.uint8)
    im = np.mod(i, 6)
    sel = [im == k for k in range(6)]
    r = np.select(sel, [v, q, p, p, t, v])
    g = np.select(sel, [t, v, v, q, p, p])
    b = np.select(sel, [p, p, t, v, v, q])
    out = np.stack([r, g, b], axis=-1).astype(np.uint8)
    gray = s == 0
    out[gray] = np.stack([v, v, v], axis=-1).astype(np.uint8)[gray]
    return out


def adjust_hue(img, f):
    """torchvision PIL-backend adjust_hue: roll the uint8 hue channel by
    trunc(f*255) with wraparound (numpy-1.x modular float->uint8 cast)."""
    hsv = _rgb_to_hsv_pil(img)
    shift = np.uint8(int(np.trunc(f * 255.0)) % 256)
    hsv[..., 0] = hsv[..., 0] + shift  # uint8 wraparound, like np_h += shift
    return _hsv_to_rgb_pil(hsv)


class _ColorJitter:
    """Factor draws + op assembly shared by the video/image variants
    (the original MAED's color_jitter.py:8-38: brightness, saturation, hue,
    contrast appended in that order, then shuffled)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue

    def _ops(self, rng: np.random.RandomState):
        ops = []
        if self.b > 0:
            f = rng.uniform(max(0, 1 - self.b), 1 + self.b)
            ops.append(lambda im, f=f: adjust_brightness(im, f))
        if self.s > 0:
            f = rng.uniform(max(0, 1 - self.s), 1 + self.s)
            ops.append(lambda im, f=f: adjust_saturation(im, f))
        if self.h > 0:
            f = rng.uniform(-self.h, self.h)
            ops.append(lambda im, f=f: adjust_hue(im, f))
        if self.c > 0:
            f = rng.uniform(max(0, 1 - self.c), 1 + self.c)
            ops.append(lambda im, f=f: adjust_contrast(im, f))
        order = rng.permutation(len(ops))
        return [ops[i] for i in order]


class ColorJitterVideo(_ColorJitter):
    """Brightness/saturation/hue/contrast with factors and op order shared
    across the clip (torchvision adjust_* PIL semantics on uint8)."""

    def __call__(self, inst, rng: np.random.RandomState):
        ops = self._ops(rng)
        out = dict(inst)
        out["clip"] = [_chain(frame, ops) for frame in inst["clip"]]
        return out


class ColorJitterImage(_ColorJitter):
    """Single-image variant (reference color_jitter.py:99-155)."""

    def __call__(self, inst, rng: np.random.RandomState):
        out = dict(inst)
        out["image"] = _chain(inst["image"], self._ops(rng))
        return out


def _chain(img, fns):
    for fn in fns:
        img = fn(img)
    return img


class RandomEraseVideo:
    """Erase a random-ratio strip from one of 4 sides (side shared per clip,
    applied per-frame with probability `prob`); optional keypoint-confidence
    zeroing for joints deep inside the erased strip.

    Note: the reference erases *rows* for its left/right branches (an indexing
    slip); here left/right erase columns, which matches the documented intent.
    """

    def __init__(self, prob=0.0, max_erase_part=0.5, random_filling=True,
                 erase_kp=True, margin=0.1):
        self.prob = prob
        self.max_part = max_erase_part
        self.random_filling = random_filling
        self.erase_kp = erase_kp
        self.margin = margin

    def _fill(self, shape, rng):
        if self.random_filling:
            return rng.randint(256, size=shape).astype(np.uint8)
        return np.zeros(shape, np.uint8)

    def _erase(self, img, kp, side, ratio, rng):
        h, w, _ = img.shape
        img = img.copy()
        if side == "top":
            eh = int(h * ratio)
            if eh > 0:
                img[:eh] = self._fill((eh, w, 3), rng)
                if self.erase_kp and kp is not None:
                    far = eh - kp[:, 1] > h * self.margin
                    kp[far, 2] = 0.0
        elif side == "bottom":
            eh = int(h * ratio)
            if eh > 0:
                img[h - eh:] = self._fill((eh, w, 3), rng)
                if self.erase_kp and kp is not None:
                    far = eh - (h - kp[:, 1]) > h * self.margin
                    kp[far, 2] = 0.0
        elif side == "left":
            ew = int(w * ratio)
            if ew > 0:
                img[:, :ew] = self._fill((h, ew, 3), rng)
                if self.erase_kp and kp is not None:
                    far = ew - kp[:, 0] > w * self.margin
                    kp[far, 2] = 0.0
        else:  # right
            ew = int(w * ratio)
            if ew > 0:
                img[:, w - ew:] = self._fill((h, ew, 3), rng)
                if self.erase_kp and kp is not None:
                    far = ew - (w - kp[:, 0]) > w * self.margin
                    kp[far, 2] = 0.0
        return img, kp

    def __call__(self, inst, rng: np.random.RandomState):
        side = ["left", "right", "top", "bottom"][rng.randint(4)]
        kp_2d = inst.get("kp_2d")
        clip, kps = [], []
        for t, frame in enumerate(inst["clip"]):
            kp = kp_2d[t].copy() if kp_2d is not None else None
            if rng.rand() < self.prob:
                frame, kp = self._erase(frame, kp, side, rng.rand() * self.max_part, rng)
            clip.append(frame)
            if kp is not None:
                kps.append(kp)
        out = dict(inst)
        out["clip"] = clip
        if kp_2d is not None:
            out["kp_2d"] = np.stack(kps, axis=0)
        return out


class RandomHFlipVideo:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, inst, rng: np.random.RandomState):
        if rng.rand() >= self.p:
            return inst
        out = dict(inst)
        width = inst["clip"][0].shape[1]
        out["clip"] = [np.ascontiguousarray(f[:, ::-1]) for f in inst["clip"]]
        out["kp_2d"] = keypoint_2d_hflip(inst["kp_2d"].copy(), width)
        if "kp_3d" in inst:
            out["kp_3d"] = keypoint_3d_hflip(inst["kp_3d"].copy())
        if "pose" in inst:
            out["pose"] = smpl_pose_hflip(inst["pose"].copy())
        return out


class StackNormalize:
    """[0,255] HWC uint8 frames -> (T, H, W, 3) float32, ImageNet-normalized;
    kp_2d xy -> [-1, 1].

    device_normalize=True (DATASET.DEVICE_PREPROC) stacks the frames as
    uint8 instead and leaves normalization to the device (the model's
    ops/image.py::device_normalize): 1/4 the host->device bytes per step, same
    f32 arithmetic on the same uint8 crop — every augmentation before this
    stage (crop/jitter/erase/flip) already operates on uint8."""

    def __init__(self, patch_size=224, device_normalize=False):
        self.patch_size = patch_size
        self.device_normalize = device_normalize

    def __call__(self, inst, rng=None):
        clip = np.stack(inst["clip"], axis=0)
        if self.device_normalize and clip.dtype == np.uint8:
            pass  # ship uint8; the model normalizes on the device
        else:
            clip = clip.astype(np.float32) / 255.0
            clip = (clip - IMAGENET_MEAN) / IMAGENET_STD
        out = dict(inst)
        out["clip"] = clip
        if "kp_2d" in inst:
            kp = np.asarray(inst["kp_2d"], np.float32).copy()
            kp[..., :2] = 2.0 * kp[..., :2] / self.patch_size - 1.0
            out["kp_2d"] = kp
        return out


class FusedCropNormalize:
    """The eval path's crop: the native fused affine crop + ImageNet
    normalize, from JPEG bytes (decoded in the native thread pool) or from
    decoded frames. Without bboxes the frames are only stacked, as
    CropVideo + StackNormalize do.

    device_normalize=True (DATASET.DEVICE_PREPROC) crops to uint8 instead
    and skips the normalize: the model applies it on the device."""

    # the dataset hands this transform the frames' JPEG bytes
    wants_jpeg_bytes = True

    def __init__(self, height=224, width=224, device_normalize=False):
        self.h, self.w = height, width
        self.device_normalize = device_normalize

    def __call__(self, inst, rng: np.random.RandomState):
        has_bytes = inst["clip"] and isinstance(inst["clip"][0], (bytes, bytearray))
        if "bbox" not in inst:
            inst = dict(inst)
            if has_bytes:
                inst["clip"] = [native.decode(b) for b in inst["clip"]]
            return StackNormalize(self.w, device_normalize=self.device_normalize)(inst, rng)

        trans = np.stack([
            gen_crop_trans(bbox, (1.3, 1.3), 0.0, (0.0, 0.0), self.w, self.h)
            for bbox in inst["bbox"]
        ])
        if has_bytes:
            crop = (native.clip_decode_crop_u8 if self.device_normalize
                    else native.clip_decode_crop_normalize)
        else:
            crop = native.clip_crop_u8 if self.device_normalize else native.clip_crop_normalize
        out = dict(inst)
        out["clip"] = crop(inst["clip"], trans, self.h, self.w)
        if "kp_2d" in inst:
            kps = np.stack([
                apply_trans_points(kp, m) for kp, m in zip(inst["kp_2d"], trans)
            ])
            kps[..., :2] = 2.0 * kps[..., :2] / self.w - 1.0
            out["kp_2d"] = kps.astype(np.float32)
        return out


class DeviceCropPack:
    """DATASET.DEVICE_CROP: the raw uint8 frames and each frame's eval affine
    instead of the crop: the crop and the normalize then run on the device
    (``ops.image.apply_device_preproc`` -> ``batch_crop_normalize``, the
    separable warp).

    The host's work a frame drops to the decode and 6 floats of affine; the
    keypoints still move on the host (they are targets, not device inputs).
    A batch needs one source frame size (a device array is rectangular):
    true of single-video footage and fixed-camera datasets; a dataset of
    mixed resolutions takes the host uint8 crop (DEVICE_PREPROC, the
    default) instead, which ``data.loaders.collate`` says when it meets one.
    """

    def __init__(self, height=224, width=224):
        self.h, self.w = height, width

    def __call__(self, inst, rng: np.random.RandomState):
        if "bbox" not in inst:
            raise ValueError("DEVICE_CROP needs per-frame bboxes")
        clip = inst["clip"]
        if clip and isinstance(clip[0], (bytes, bytearray)):
            clip = [native.decode(b) for b in clip]
        shapes = {f.shape for f in clip}
        if len(shapes) != 1:
            raise ValueError(f"DEVICE_CROP needs uniform source frame sizes, got {shapes}; "
                             "use DEVICE_PREPROC (host uint8 crop) for mixed-size sources")
        trans = np.stack([
            gen_crop_trans(bbox, (1.3, 1.3), 0.0, (0.0, 0.0), self.w, self.h)
            for bbox in inst["bbox"]
        ]).astype(np.float32)
        out = dict(inst)
        out["clip"] = np.stack(clip, axis=0)  # (T, Hs, Ws, 3) raw uint8
        out["trans"] = trans
        if "kp_2d" in inst:
            kps = np.stack([
                apply_trans_points(kp, m) for kp, m in zip(inst["kp_2d"], trans)
            ])
            kps[..., :2] = 2.0 * kps[..., :2] / self.w - 1.0
            out["kp_2d"] = kps.astype(np.float32)
        return out


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    @property
    def wants_jpeg_bytes(self) -> bool:
        """A pipeline accepts raw JPEG bytes iff its FIRST stage does (the
        stage that touches inst['clip'] first — see FusedCropNormalize)."""
        return bool(self.transforms) and getattr(
            self.transforms[0], "wants_jpeg_bytes", False)

    def __call__(self, inst, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        for t in self.transforms:
            inst = t(inst, rng)
        return inst


def build_train_transforms(cfg_dataset, color_jitter: bool = True) -> Compose:
    """The reference's train transform stack (train.py:40-57 equivalent).

    color_jitter=False builds the 2D/image variant: the reference jitters
    ONLY the 3D video pipeline (transforms_3d gets ColorJitterVideo with
    brightness=contrast=saturation=hue=COLOR_JITTER; transforms_2d and
    transforms_img do not — the original MAED's train.py:40-63)."""
    d = cfg_dataset
    ts = [
        CropVideo(d.HEIGHT, d.WIDTH, d.ROT_JITTER, d.SIZE_JITTER,
                  d.RANDOM_CROP_P, d.RANDOM_CROP_SIZE),
    ]
    if color_jitter and d.COLOR_JITTER > 0:
        ts.append(ColorJitterVideo(d.COLOR_JITTER, d.COLOR_JITTER,
                                   d.COLOR_JITTER, d.COLOR_JITTER))
    if d.ERASE_PROB > 0:
        ts.append(RandomEraseVideo(d.ERASE_PROB, d.ERASE_PART, d.ERASE_FILL,
                                   d.ERASE_KP, d.ERASE_MARGIN))
    if d.RANDOM_FLIP > 0:
        ts.append(RandomHFlipVideo(d.RANDOM_FLIP))
    # DATASET.DEVICE_PREPROC (on by default): every stage above operates on
    # uint8, so the stack ships uint8 and the model normalizes on the device
    # (ops/image.py::device_normalize)
    ts.append(StackNormalize(
        d.WIDTH, device_normalize=bool(getattr(d, "DEVICE_PREPROC", False))))
    return Compose(ts)


def build_eval_transforms(width=224, height=224, fused: bool = True,
                          device_normalize: bool = False,
                          device_crop: bool = False) -> Compose:
    if device_crop:
        return Compose([DeviceCropPack(height, width)])
    if fused:
        return Compose([FusedCropNormalize(height, width,
                                           device_normalize=device_normalize)])
    return Compose([CropVideo(height, width),
                    StackNormalize(width, device_normalize=device_normalize)])
