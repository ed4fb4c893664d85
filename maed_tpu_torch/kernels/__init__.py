"""Build, load and count the port's CUDA kernels.

The CUDA C++ sources under ``maed_tpu_torch/csrc`` have a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``maed_tpu_torch/kernels/_build/``, named by a hash of the
sources and flags (an edited source is rebuilt, an unchanged one is reused),
and loaded with ``ctypes``. Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`check` raises if that is not
0, so a refused launch never passes unnoticed.

``LAUNCHES`` counts, per kernel, the launches that the wrappers in
``maed_tpu_torch.ops`` have made. A wrapper adds one where it launches its
kernel and nowhere else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: dict[str, int] = {
    "skinning": 0,      # csrc/skinning.cu
    "layernorm": 0,     # ops/layernorm.py (Triton)
    "ln_mlp_fc1": 0,    # csrc/ln_mlp.cu, LN + fc1 + GELU launch
    "ln_mlp_fc2": 0,    # csrc/ln_mlp.cu, fc2 + residual launch
}

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of csrc/*.cu: name -> argument types (every one returns int)
_SIGNATURES = {
    # v_posed, weights, A, out, B, V, stream
    "maed_skinning_f32": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr),
    # is_bf16, x, ln_scale, ln_bias, eps, w1, b1, h, M, C, H, stream
    "maed_ln_fc1_gelu": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_float, _c_ptr, _c_ptr,
                         _c_ptr, _c_int, _c_int, _c_int, _c_ptr),
    # is_bf16, h, w2, b2, x, out, M, H, C, stream
    "maed_fc2_residual": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                          _c_int, _c_int, _c_int, _c_ptr),
}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "kernels are built from csrc/ with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmaed_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library, unless it is already built.

    The compiler's output (with ptxas' register and spill report) is kept
    beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}); see {log}:\n"
                           + proc.stderr[-4000:])
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
