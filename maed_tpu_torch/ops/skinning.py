"""Linear blend skinning: the CUDA kernel ``csrc/skinning.cu`` and its plain
PyTorch version.

Counterpart of ``maed_tpu/ops/smpl_pallas.py`` (the Pallas ``skinning``),
which SMPL's ``lbs`` calls. :func:`skinning` launches the CUDA kernel for a
CUDA tensor and takes :func:`skinning_reference` only for a CPU tensor. The
kernel is f32 only: the per-vertex error budget (0.5 mm on a ~1.7 m body) is
below what bf16 can hold. Its gradient is autograd through
:func:`skinning_reference` (``ops.recompute``), the einsums the JAX package's
custom VJP differentiates.
"""

from __future__ import annotations

import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.ops.recompute import differentiable

NUM_JOINTS = 24


def skinning_reference(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
                       A: torch.Tensor) -> torch.Tensor:
    """verts[b, v] = (sum_j W[v, j] * A[b, j, :3, :]) @ [v_posed[b, v], 1].

    v_posed (B, V, 3), lbs_weights (V, J), A (B, J, 4, 4) -> (B, V, 3).
    """
    T = torch.einsum("vj,bjpq->bvpq", lbs_weights, A[:, :, :3, :])
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    return torch.einsum("bvpq,bvq->bvp", T, v_h)


def skinning(v_posed: torch.Tensor, lbs_weights: torch.Tensor,
             A: torch.Tensor) -> torch.Tensor:
    """:func:`skinning_reference` as one CUDA kernel (f32, J = 24)."""
    return differentiable(_skinning_kernel, skinning_reference, v_posed, lbs_weights, A)


def _skinning_kernel(v_posed, lbs_weights, A):
    if v_posed.device.type != "cuda":
        raise ValueError(f"skinning: no kernel for device {v_posed.device}")
    B, V, _ = v_posed.shape
    if v_posed.shape != (B, V, 3) or lbs_weights.shape != (V, NUM_JOINTS) \
            or A.shape != (B, NUM_JOINTS, 4, 4):
        raise ValueError(f"skinning: shapes {tuple(v_posed.shape)}, "
                         f"{tuple(lbs_weights.shape)}, {tuple(A.shape)}")
    for t in (v_posed, lbs_weights, A):
        if t.dtype != torch.float32 or t.device != v_posed.device \
                or not t.is_contiguous():
            raise ValueError("skinning: the kernel takes contiguous f32 tensors "
                             f"on one device, got {t.dtype} on {t.device}")
    if B > 65535:
        raise ValueError(f"skinning: {B} frames exceed the grid's 65535")
    out = torch.empty_like(v_posed)
    lib = kernels.library()
    with torch.cuda.device(v_posed.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.check(lib.maed_skinning_f32(
            v_posed.data_ptr(), lbs_weights.data_ptr(), A.data_ptr(),
            out.data_ptr(), B, V, stream), "maed_skinning_f32")
    kernels.LAUNCHES["skinning"] += 1
    return out
