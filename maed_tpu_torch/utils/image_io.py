"""Frames in and overlays out, without cv2: the port's stand-in for the
``cv2.imread`` / ``cv2.imwrite`` calls of the JAX package's host tools.

- :func:`read_rgb` decodes a JPEG through the port's native library
  (libjpeg, or nvJPEG where libjpeg is absent), as the data pipeline does
  (``data/dataset.py::read_img``). Any other format raises: the port decodes
  JPEG frames only.
- :func:`image_size` reads (height, width) from a JPEG's header alone.
- :func:`write_png` writes 8-bit RGB as PNG with ``zlib`` and ``struct`` from
  the standard library. The port writes its overlays as PNG where the JAX
  package keeps the source frame's extension.
- :func:`write_jpeg` writes 8-bit RGB as a baseline JPEG through the native
  library's encoder (libjpeg's, or nvJPEG's on the card's machine), at
  cv2.imwrite's quality 95 and 4:2:0 chroma by default, for the frames the
  port must read back. A failed encode raises; nothing else writes it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from maed_tpu_torch import native

JPEG_RULE = "the port decodes JPEG frames only"
JPEG_MAGIC = b"\xff\xd8\xff"


def is_jpeg(path: str) -> bool:
    """Whether the file starts with a JPEG's start-of-image marker."""
    with open(path, "rb") as f:
        return f.read(len(JPEG_MAGIC)) == JPEG_MAGIC


def _jpeg_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(JPEG_MAGIC):
        raise IOError(f"{path} is not a JPEG: {JPEG_RULE}")
    return blob


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file."""
    blob = _jpeg_bytes(path)
    try:
        return native.decode(blob)
    except IOError as e:
        raise IOError(f"{path}: {e} ({JPEG_RULE})") from e


def image_size(path: str) -> tuple[int, int]:
    """(height, width) of a JPEG file, from its header."""
    blob = _jpeg_bytes(path)
    try:
        return native.jpeg_size(blob)
    except IOError as e:
        raise IOError(f"{path}: {e} ({JPEG_RULE})") from e


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as an 8-bit RGB PNG (no filter on any row,
    zlib's default deflate level): the same array gives the same bytes."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # each row: filter byte 0, then the pixels
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8 bits, truecolour, no interlace
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> None:
    """Write (H, W, 3) uint8 RGB as a JPEG (:func:`native.encode`)."""
    blob = native.encode(rgb, quality)
    with open(path, "wb") as f:
        f.write(blob)
