"""LayerNorm over the last axis: the Triton kernel and its plain PyTorch version.

Counterpart of ``maed_tpu/ops/layernorm.py``. Its Pallas kernel
``_ln_kernel`` (pallas_call in ``_ln_pallas``, public entry
``fast_layernorm``) runs by default in the eval forward: norm1 of every
block and the final norm, 7 calls at the flagship depth of 6.

The formula is the JAX one: f32 statistics as E[x^2] - m^2, eps inside the
rsqrt, the affine in f32, and the output in x's dtype.

The Triton kernel: what bounds it on the H100 is memory. At the flagship
shape, (25216, 768) bf16 tokens, a call reads 38.7 MB and writes 38.7 MB, a
reduction and an affine with no tensor-core work: about 23 us at 3.35 TB/s.
One program per row holds the whole row (C = 768 as a masked 1024-wide block)
in registers, so x is read once and y written once, with the statistics in
f32.
"""

from __future__ import annotations

import functools
import os

import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.ops import library
from maed_tpu_torch.ops.recompute import differentiable


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance); the statistics
    accumulate in promote(x.dtype, f32), so f64 stays f64."""
    st = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(st)
    m = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - m * m
    y = (xf - m) * torch.rsqrt(var + eps)
    y = y * scale.to(st) + bias.to(st)
    return y.to(x.dtype)


@functools.cache
def _triton_kernel():
    """Define (once) the Triton kernel; Triton compiles it at first launch."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(kernels.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def layernorm_kernel(x_ptr, scale_ptr, bias_ptr, y_ptr, C, eps,
                         BLOCK_C: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_C)
        mask = cols < C
        x = tl.load(x_ptr + row * C + cols, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=0) / C
        var = tl.sum(x * x, axis=0) / C - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        scale = tl.load(scale_ptr + cols, mask=mask, other=0.0)
        bias = tl.load(bias_ptr + cols, mask=mask, other=0.0)
        y = (x - mean) * rstd * scale + bias
        tl.store(y_ptr + row * C + cols, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, layernorm_kernel


def fast_layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """:func:`layernorm_reference` as one Triton kernel (x f32 or bf16,
    scale and bias f32); any leading shape. Its gradient is autograd through
    :func:`layernorm_reference` (``ops.recompute``)."""
    return differentiable(_layernorm_kernel, layernorm_reference, x, scale, bias, eps)


def _layernorm_kernel(x, scale, bias, eps):
    if x.device.type != "cuda":
        raise ValueError(f"fast_layernorm: no kernel for device {x.device}")
    C = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"fast_layernorm: the kernel takes contiguous f32 or "
                         f"bf16 x, got {x.dtype}")
    for t in (scale, bias):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"fast_layernorm: scale and bias must be f32 ({C},) "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)}")
    triton, kernel = _triton_kernel()
    x2 = x.reshape(-1, C)
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        kernel[(x2.shape[0],)](x2, scale, bias, out, C, eps,
                               BLOCK_C=triton.next_power_of_2(C), num_warps=4)
    kernels.LAUNCHES["layernorm"] += 1
    return out.reshape(x.shape)


library.define("layernorm(Tensor x, Tensor scale, Tensor bias, float eps) -> Tensor",
               _layernorm_kernel, layernorm_reference)
