"""Build, load and count the port's CUDA kernels.

The CUDA C++ sources under ``maed_tpu_torch/csrc`` have a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together) and linked into one shared library
under ``maed_tpu_torch/kernels/_build/``, named by a hash of the sources and
flags (an edited source is rebuilt, an unchanged one is reused), and loaded
with ``ctypes``. Each C entry point launches on the stream it is
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

LAUNCHES: dict[str, int] = {
    "skinning": 0,      # csrc/skinning.cu
    "layernorm": 0,     # ops/layernorm.py (Triton)
    "ln_rows": 0,       # csrc/ln_mlp.cu, LN(x) rounded to bf16, the pre-pass of C and D in bf16
    "ln_mlp_fc1": 0,    # csrc/ln_mlp.cu, (LN +) fc1 + GELU launch
    "ln_mlp_fc2": 0,    # csrc/ln_mlp.cu, fc2 + residual launch
    "ln_dense": 0,      # csrc/ln_mlp.cu, (LN +) dense (the qkv projection)
    "gate_means": 0,    # csrc/ln_mlp.cu, the attention's tail (E): the branch means
    "gate_alpha": 0,    # csrc/ln_mlp.cu, E: the gate product and its softmax pairs
    "gate_blend": 0,    # csrc/ln_mlp.cu, E in bf16: the blend of the two branches
    "gate_proj": 0,     # csrc/ln_mlp.cu, E: proj + residual (bf16: the dense GEMM's "proj")
    "groupnorm": 0,     # csrc/groupnorm.cu, bf16: a cluster of CTAs a frame
    "groupnorm_strided": 0,   # csrc/groupnorm.cu, f32 and other shapes: a block per group(s)
    "spatial_attention": 0,   # csrc/st_attention.cu, attention over tokens
    "temporal_attention": 0,  # csrc/st_attention.cu, attention over frames
    "attention_blocked": 0,   # csrc/st_attention.cu, online softmax over a clip's tokens
}

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_i64 = ctypes.c_longlong
# C entry points of csrc/*.cu: name -> argument types (every one returns int)
_SIGNATURES = {
    # v_posed, weights, A, out, B, V, stream
    "maed_skinning_f32": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr),
    # x, ln_scale, ln_bias, eps, out, M, C, stream
    "maed_ln_rows": (_c_ptr, _c_ptr, _c_ptr, _c_float, _c_ptr, _c_int, _c_int, _c_ptr),
    # epilogue, a, w, bias, residual, out, M, N, K, stream
    "maed_dense_bf16": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int,
                        _c_ptr),
    # epilogue, a, ln_scale, ln_bias, eps, w, bias, residual, out, M, N, K, stream
    "maed_dense_f32": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_float, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
                       _c_int, _c_int, _c_int, _c_ptr),
    # is_bf16, y_s, y_t, means, BT, N, C, stream
    "maed_gate_means": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr),
    # is_bf16, means, w_ts, b_ts, alpha, BT, C, stream
    "maed_gate_alpha": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr),
    # y_s, y_t, alpha, y, BT, N, C, stream
    "maed_gate_blend": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr),
    # is_bf16, y_s, y_t, x, w_ts, b_ts, w_p, b_p, means, alpha, y, out, BT, N, C, stream
    "maed_gate_proj": (_c_int, *(_c_ptr,) * 11, _c_int, _c_int, _c_int, _c_ptr),
    # is_bf16, x, residual, out, scale, bias, B, G, cpg, HW, eps, relu, stream
    "maed_groupnorm": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
                       _c_int, _c_int, _c_float, _c_int, _c_ptr),
    # x, residual, out, scale, bias, B, G, C, HW, ranks, eps, relu, stream
    "maed_groupnorm_cluster": (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int,
                               _c_int, _c_int, _c_float, _c_int, _c_ptr),
    # is_bf16, q, k, v, out, B, H, S, d, sb, sh, ss, ob, oh, os, scale, stream (both)
    "maed_spatial_attention": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
                               _c_int, _c_int, *(_c_i64,) * 6, _c_float, _c_ptr),
    "maed_blocked_attention": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
                               _c_int, _c_int, *(_c_i64,) * 6, _c_float, _c_ptr),
    # is_bf16, q, k, v, out, G, T, N, H, d, s_frame, s_token, s_head,
    # o_frame, o_token, o_head, scale, stream
    "maed_temporal_attention": (_c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
                                _c_int, _c_int, _c_int, *(_c_i64,) * 6, _c_float, _c_ptr),
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
    """Compile csrc/*.cu into the shared library, unless it is already built:
    every source to an object file at once, one nvcc each, then one link.

    The compilers' output (with ptxas' register and spill report) is kept
    beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, log = _nvcc(), out.with_suffix(".log")
    tag = f"{out.stem}.{os.getpid()}"
    objects = {src: BUILD_DIR / f"{tag}.{src.stem}.o"
               for src in _sources() if src.suffix == ".cu"}
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in objects.items()]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    tmp = BUILD_DIR / f"{tag}.tmp"
    cmds.append([nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj in objects.values())])
    texts = [proc.communicate()[0] for proc in procs]
    codes = [proc.returncode for proc in procs]
    if not any(codes):
        link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        texts.append(link.stdout)
        codes.append(link.returncode)
    log.write_text("".join(" ".join(cmd) + "\n" + text for cmd, text in zip(cmds, texts)))
    for obj in objects.values():
        obj.unlink(missing_ok=True)
    if any(codes):
        tmp.unlink(missing_ok=True)
        failed = "".join(text for text, code in zip(texts, codes) if code)
        raise RuntimeError(f"nvcc failed; see {log}:\n" + failed[-4000:])
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
