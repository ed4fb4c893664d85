"""On-device ImageNet normalization of uint8 clips.

Port of ``maed_tpu/ops/image.py::device_normalize``: hosts ship uint8 frames
(a quarter of the bytes of f32) and the model normalizes them on the device.
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
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std
