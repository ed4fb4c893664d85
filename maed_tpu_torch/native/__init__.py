"""ctypes bindings of the native (C++) host data path: JPEG decode, the
affine crop and the ImageNet normalize of a clip, and a JPEG encoder.

Port of ``maed_tpu/native``. The library is built from ``clip_ops.cc`` with
g++ (``build.sh``) at first use, into ``maed_tpu_torch/kernels/_build/``
under a name keyed on a hash of the two sources, beside the CUDA kernels.
Unlike the JAX package's bindings it has no fallback: a failed build, a
missing decoder or a frame that does not decode raises, and says what is
missing. The decoder is libjpeg where it is installed and nvJPEG from the
CUDA toolkit otherwise (:func:`decoder` says which); :func:`encode` uses
the same library's encoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import threading
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "kernels" / "_build"
_SOURCES = ("clip_ops.cc", "build.sh")

_lib = None
_lib_lock = threading.Lock()

_u8_p = ctypes.POINTER(ctypes.c_uint8)
_u8_pp = ctypes.POINTER(_u8_p)
_i32_p = ctypes.POINTER(ctypes.c_int)
_i64_p = ctypes.POINTER(ctypes.c_int64)
_f64_p = ctypes.POINTER(ctypes.c_double)
_f32_p = ctypes.POINTER(ctypes.c_float)
# entry point -> (argument types, return type)
_SIGNATURES = {
    "clip_crop_normalize": ((_u8_pp, _i32_p, ctypes.c_int, _f64_p, ctypes.c_int, ctypes.c_int,
                             _f32_p, ctypes.c_int), None),
    "clip_crop_u8": ((_u8_pp, _i32_p, ctypes.c_int, _f64_p, ctypes.c_int, ctypes.c_int,
                      _u8_p, ctypes.c_int), None),
    "clip_decode_crop_normalize": ((_u8_pp, _i64_p, ctypes.c_int, _f64_p, ctypes.c_int,
                                    ctypes.c_int, _f32_p, ctypes.c_int), ctypes.c_int),
    "clip_decode_crop_u8": ((_u8_pp, _i64_p, ctypes.c_int, _f64_p, ctypes.c_int, ctypes.c_int,
                             _u8_p, ctypes.c_int), ctypes.c_int),
    "jpeg_decode_rgb": ((_u8_p, ctypes.c_int64, _u8_p, ctypes.c_int64, _i32_p, _i32_p),
                        ctypes.c_int),
    "jpeg_encode_rgb": ((_u8_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8_p,
                         ctypes.c_int64, _i64_p), ctypes.c_int),
    "jpeg_decoder_name": ((), ctypes.c_char_p),
    "jpeg_decoder_device_live": ((), ctypes.c_int),
}


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update((HERE / name).read_bytes())
    return BUILD_DIR / f"libclip_ops_{digest.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it is already built (or ``force``); raise
    on failure."""
    out = library_path()
    if out.is_file() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(["sh", str(HERE / "build.sh"), str(out)],
                          capture_output=True, text=True)
    if proc.returncode != 0 or not out.is_file():
        raise RuntimeError("building the native clip ops failed (maed_tpu_torch/native/"
                           f"build.sh):\n{(proc.stdout + proc.stderr)[-3000:]}")
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except OSError:
                # a library built on another machine, against a decoder
                # this one lacks: build it here
                lib = ctypes.CDLL(str(build(force=True)))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def decoder() -> str:
    """The JPEG decoder the library links: 'libjpeg' or 'nvjpeg'."""
    return library().jpeg_decoder_name().decode()


def device_live() -> bool:
    """Whether the decoder made a CUDA context in this process (nvJPEG, after
    its first decode). False when the library was never loaded here."""
    return _lib is not None and bool(_lib.jpeg_decoder_device_live())


def _as_bytes(blob) -> np.ndarray:
    if not isinstance(blob, (bytes, bytearray, memoryview, np.ndarray)):
        raise TypeError(f"JPEG data must be bytes, got {type(blob).__name__}")
    buf = np.frombuffer(blob, np.uint8)
    if buf.size == 0:
        raise IOError("empty JPEG data")
    return buf


def jpeg_size(blob) -> tuple[int, int]:
    """(height, width) of one JPEG (its bytes), from its header alone.
    Raises IOError if the header does not decode."""
    buf = _as_bytes(blob)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    rc = library().jpeg_decode_rgb(buf.ctypes.data_as(_u8_p), buf.size, None, 0,
                                   ctypes.byref(h), ctypes.byref(w))
    if rc != -3:
        raise IOError("JPEG header does not decode (corrupt, or larger than 8192 px)")
    return h.value, w.value


def decode(blob) -> np.ndarray:
    """One JPEG (its bytes) -> (H, W, 3) uint8 RGB. Raises IOError if it
    does not decode."""
    lib = library()
    buf = _as_bytes(blob)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    src = buf.ctypes.data_as(_u8_p)
    out = np.empty(jpeg_size(buf) + (3,), np.uint8)
    rc = lib.jpeg_decode_rgb(src, buf.size, out.ctypes.data_as(_u8_p), out.nbytes,
                             ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"JPEG does not decode with {decoder()} (rc {rc})")
    return out


def encode(rgb, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of a baseline JPEG at ``quality``
    with 4:2:0 chroma, cv2.imwrite's defaults. Raises IOError if the
    encoder fails."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes (H, W, 3) uint8 RGB, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    lib = library()
    size = ctypes.c_int64(0)
    out = np.empty(rgb.nbytes + (1 << 16), np.uint8)  # past any JPEG of these pixels
    while True:
        rc = lib.jpeg_encode_rgb(rgb.ctypes.data_as(_u8_p), h, w, int(quality),
                                 out.ctypes.data_as(_u8_p), out.size, ctypes.byref(size))
        if rc != -3:
            break
        out = np.empty(size.value, np.uint8)
    if rc != 0:
        raise IOError(f"JPEG encoding of a {h} x {w} image failed with {decoder()} (rc {rc})")
    return out[:size.value].tobytes()


def _inv_affines(trans) -> np.ndarray:
    """(T, 2, 3) forward affines -> (T, 6) row-major inverses (output px ->
    input px), the convention of the C entry points."""
    trans = np.asarray(trans, np.float64)
    if trans.ndim != 3 or trans.shape[1:] != (2, 3):
        raise ValueError(f"affines must be (T, 2, 3), got {trans.shape}")
    inv = np.zeros((len(trans), 6), np.float64)
    for i, m in enumerate(trans):
        inv[i] = np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2].ravel()
    return inv


def _crop(entry: str, frames, trans, out_h: int, out_w: int, dtype, n_threads: int):
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    for f in frames:
        if f.ndim != 3 or f.shape[2] != 3:
            raise ValueError(f"frames must be (H, W, 3) uint8, got {f.shape}")
    T = len(frames)
    inv = _inv_affines(trans)
    if len(inv) != T:
        raise ValueError(f"{T} frames but {len(inv)} affines")
    ptrs = (_u8_p * T)(*[f.ctypes.data_as(_u8_p) for f in frames])
    src_hw = np.array([f.shape[:2] for f in frames], np.int32).reshape(T, 2)
    out = np.empty((T, out_h, out_w, 3), dtype)
    out_p = out.ctypes.data_as(_f32_p if dtype == np.float32 else _u8_p)
    getattr(library(), entry)(ptrs, src_hw.ctypes.data_as(_i32_p), T,
                              inv.ctypes.data_as(_f64_p), out_h, out_w, out_p, n_threads)
    return out


def _decode_crop(entry: str, jpegs, trans, out_h: int, out_w: int, dtype, n_threads: int):
    bufs = [_as_bytes(j) for j in jpegs]
    T = len(bufs)
    inv = _inv_affines(trans)
    if len(inv) != T:
        raise ValueError(f"{T} frames but {len(inv)} affines")
    ptrs = (_u8_p * T)(*[b.ctypes.data_as(_u8_p) for b in bufs])
    lens = np.array([b.size for b in bufs], np.int64)
    out = np.empty((T, out_h, out_w, 3), dtype)
    out_p = out.ctypes.data_as(_f32_p if dtype == np.float32 else _u8_p)
    rc = getattr(library(), entry)(ptrs, lens.ctypes.data_as(_i64_p), T,
                                   inv.ctypes.data_as(_f64_p), out_h, out_w, out_p, n_threads)
    if rc != 0:
        raise IOError(f"a clip frame does not decode with {decoder()} (rc {rc})")
    return out


def clip_crop_normalize(frames, trans, out_h: int, out_w: int, n_threads: int = 0) -> np.ndarray:
    """Affine crop + ImageNet normalize of a clip: frames, T (H, W, 3) uint8
    RGB arrays (sizes may differ); trans, (T, 2, 3) forward affines (input
    px -> output px, cv2.warpAffine's convention). (T, out_h, out_w, 3) f32."""
    return _crop("clip_crop_normalize", frames, trans, out_h, out_w, np.float32, n_threads)


def clip_crop_u8(frames, trans, out_h: int, out_w: int, n_threads: int = 0) -> np.ndarray:
    """The same crop to a rounded uint8 clip, not normalized."""
    return _crop("clip_crop_u8", frames, trans, out_h, out_w, np.uint8, n_threads)


def clip_decode_crop_normalize(jpegs, trans, out_h: int, out_w: int,
                               n_threads: int = 0) -> np.ndarray:
    """JPEG decode + crop + normalize of a clip given as T JPEG byte strings."""
    return _decode_crop("clip_decode_crop_normalize", jpegs, trans, out_h, out_w,
                        np.float32, n_threads)


def clip_decode_crop_u8(jpegs, trans, out_h: int, out_w: int, n_threads: int = 0) -> np.ndarray:
    """JPEG decode + crop to a uint8 clip."""
    return _decode_crop("clip_decode_crop_u8", jpegs, trans, out_h, out_w, np.uint8, n_threads)
