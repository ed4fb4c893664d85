"""On-device image preprocessing: ImageNet normalization of uint8 clips, and
the affine crop of raw frames (DATASET.DEVICE_CROP).

Port of ``maed_tpu/ops/image.py``. Hosts ship uint8 frames (a quarter of the
bytes of f32) and the model normalizes them on the device
(:func:`device_normalize`). With DEVICE_CROP they ship the raw frames and
each frame's crop affine instead, and :func:`batch_crop_normalize` crops,
resizes and normalizes on the device: cv2.warpAffine's bilinear taps with a
constant-0 border, to float accuracy. XLA compiled these functions in the
JAX package, with no Pallas kernel, so plain torch ops stand in: for the
eval protocol's axis-aligned affines the warp is two batched products (one
over rows, one over columns), for any other a bilinear gather.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalize uint8 images (..., 3) to f32; float inputs pass through."""
    if images.dtype != torch.uint8:
        return images
    return _normalize(images.to(torch.float32))


def _normalize(pixels: torch.Tensor) -> torch.Tensor:
    """f32 pixels in 0..255 -> ImageNet-normalized."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=pixels.device)
    std = torch.as_tensor(IMAGENET_STD, device=pixels.device)
    return (pixels / 255.0 - mean) / std


def invert_affine(trans: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) forward affines (input px -> output px) -> their inverses."""
    a, b, c = trans[..., 0, 0], trans[..., 0, 1], trans[..., 0, 2]
    d, e, f = trans[..., 1, 0], trans[..., 1, 1], trans[..., 1, 2]
    det = a * e - b * d
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    return torch.stack([torch.stack([ia, ib, ic], dim=-1),
                        torch.stack([id_, ie, if_], dim=-1)], dim=-2)


def _warp_gather(frames: torch.Tensor, inv: torch.Tensor, out_h: int, out_w: int):
    """Bilinear warp by gathers: frames (T, H, W, 3) any dtype, inv (T, 2, 3)
    output-px -> input-px affines; taps outside the frame are 0. The JAX
    package's ``_warp_one`` over every frame at once."""
    T, H, W = frames.shape[:3]
    dev = frames.device
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    coef = inv[:, :, :, None, None]  # (T, 2, 3, 1, 1)
    sx = coef[:, 0, 0] * gx + coef[:, 0, 1] * gy + coef[:, 0, 2]
    sy = coef[:, 1, 0] * gx + coef[:, 1, 1] * gy + coef[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    img = frames.to(torch.float32)
    t = torch.arange(T, device=dev)[:, None, None]

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[t, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(valid[..., None], v, 0.0)

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x0i + 1) * fx * (1 - fy)
            + tap(y0i + 1, x0i) * (1 - fx) * fy + tap(y0i + 1, x0i + 1) * fx * fy)


def _interp_matrix(starts: torch.Tensor, steps: torch.Tensor, out_size: int, in_size: int):
    """Per-frame 1D bilinear interpolation matrices (T, out_size, in_size):
    rows relu(1 - |src - j|) for the source coordinate src = start + step *
    i of output index i, which are the bilinear taps, and zero rows (the
    constant-0 border) outside the source."""
    out_idx = torch.arange(out_size, dtype=torch.float32, device=starts.device)
    src = starts[:, None] + steps[:, None] * out_idx[None, :]
    in_idx = torch.arange(in_size, dtype=torch.float32, device=starts.device)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - in_idx[None, None, :]), min=0.0)


def _warp_separable(frames: torch.Tensor, inv: torch.Tensor, out_h: int, out_w: int):
    """The warp of axis-aligned affines (no rotation: inv's off-diagonal
    terms 0) as two batched products, over the rows and then the columns."""
    H, W = frames.shape[1:3]
    img = frames.to(torch.float32)
    wx = _interp_matrix(inv[:, 0, 2], inv[:, 0, 0], out_w, W)  # (T, ow, W)
    wy = _interp_matrix(inv[:, 1, 2], inv[:, 1, 1], out_h, H)  # (T, oh, H)
    rows = torch.einsum("tiy,tyxc->tixc", wy, img)
    return torch.einsum("tjx,tixc->tijc", wx, rows)


def affine_crop_normalize(frames: torch.Tensor, trans: torch.Tensor, out_h: int, out_w: int,
                          separable: bool | None = None) -> torch.Tensor:
    """Crop every frame (T, H, W, 3) (uint8, or float in 0..255) with its
    forward affine (T, 2, 3) (cv2's convention) and ImageNet-normalize:
    (T, out_h, out_w, 3) f32.

    Axis-aligned affines (the eval protocol's scale and translation) take the
    separable path, any other the gather. ``separable`` forces the choice;
    None reads it from the affines' values (which waits for the device)."""
    trans = trans.to(torch.float32)
    inv = invert_affine(trans)
    if separable is None:
        separable = bool((trans[..., 0, 1].abs().max() == 0)
                         & (trans[..., 1, 0].abs().max() == 0))
    warp = _warp_separable if separable else _warp_gather
    return _normalize(warp(frames, inv, out_h, out_w))


def normalize_keypoints(kp: torch.Tensor, trans: torch.Tensor, patch_size: int):
    """The affines (T, 2, 3) applied to keypoints (T, K, 3), xy scaled to
    [-1, 1] over ``patch_size``; the third column kept."""
    xy1 = torch.cat([kp[..., :2], torch.ones_like(kp[..., :1])], dim=-1)
    out_xy = torch.einsum("tij,tkj->tki", trans.to(kp.dtype), xy1)
    return torch.cat([2.0 * out_xy / patch_size - 1.0, kp[..., 2:]], dim=-1)


def batch_crop_normalize(frames: torch.Tensor, trans: torch.Tensor, out_h: int, out_w: int,
                         separable: bool = True) -> torch.Tensor:
    """(N, T, H, W, 3) clips and (N, T, 2, 3) affines -> (N, T, out_h,
    out_w, 3) normalized crops. ``separable=True`` (the default) takes the
    affines to be axis-aligned, as the eval protocol's are."""
    N, T = frames.shape[:2]
    crops = affine_crop_normalize(frames.reshape((N * T,) + frames.shape[2:]),
                                  trans.reshape(N * T, 2, 3), out_h, out_w, separable)
    return crops.reshape((N, T) + crops.shape[1:])


def apply_device_preproc(images, out_h: int, out_w: int):
    """Either input contract of the eval forward as the model's frames:

    - a tensor (N, T, H, W, 3) of cropped clips, uint8 (the model normalizes
      them) or normalized f32: returned as it is;
    - a DEVICE_CROP pack {'frames': (N, T, Hs, Ws, 3) raw uint8 frames,
      'trans': (N, T, 2, 3) forward affines}: cropped and normalized here,
      on the pack's device, by the separable warp (the eval protocol's
      affines are axis-aligned).
    """
    if isinstance(images, dict):
        return batch_crop_normalize(images["frames"], images["trans"], out_h, out_w,
                                    separable=True)
    return images


def crop_trans_for_bbox(bbox: np.ndarray, out_h: int, out_w: int,
                        scale: float = 1.3) -> np.ndarray:
    """Host helper: the eval crop's affine (..., 2, 3) for (..., 4) bboxes
    (cx, cy, w, h), the geometry of ``data.transforms.gen_crop_trans``."""
    bbox = np.asarray(bbox, np.float32)
    a = out_w / (bbox[..., 2] * scale)
    e = out_h / (bbox[..., 3] * scale)
    c = out_w * 0.5 - a * bbox[..., 0]
    f = out_h * 0.5 - e * bbox[..., 1]
    z = np.zeros_like(a)
    return np.stack([np.stack([a, z, c], axis=-1), np.stack([z, e, f], axis=-1)], axis=-2)
