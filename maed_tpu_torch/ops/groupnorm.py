"""GroupNorm (+ residual) (+ ReLU) of the hybrid stem: the CUDA kernel
``csrc/groupnorm.cu`` and its plain PyTorch version.

Counterpart of ``maed_tpu/ops/groupnorm.py``: ``groupnorm_reference`` and
``fused_groupnorm``, whose Pallas kernel ``_gn_kernel`` the stem norm and
every bottleneck norm reach, 52 calls per flagship forward. The public
contract is the JAX one, ``x`` of shape (B, ..., C) with the channels last
and f32 ``scale`` and ``bias``. The kernel reads a contiguous (B, ..., C)
tensor: the port's stem, NCHW in shape, is channels-last in memory (it is fed
channels-last frames and cuDNN keeps the format) and hands over the
(B, H, W, C) view of that memory without a copy.
"""

from __future__ import annotations

import math

import torch

from maed_tpu_torch import kernels


def groupnorm_reference(x, scale, bias, num_groups, eps, relu, residual=None):
    """GroupNorm over (B, ..., C) as the JAX package computes it:
    per-channel moments in promote(x.dtype, f32) pooled per group (equal
    channels per group), ``mul = scale * rsqrt(var + eps)`` and ``add = bias -
    mean * mul`` rounded to x's dtype, then ``x * mul + add`` (+ residual)
    (+ ReLU) in x's dtype."""
    B, C = x.shape[0], x.shape[-1]
    g = num_groups
    red = tuple(range(1, x.ndim - 1))
    st = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(st)
    s1 = xf.mean(dim=red)                    # (B, C)
    s2 = (xf * xf).mean(dim=red)
    gmean = s1.reshape(B, g, C // g).mean(-1)
    gsq = s2.reshape(B, g, C // g).mean(-1)
    mean = gmean.repeat_interleave(C // g, dim=-1)
    var = gsq.repeat_interleave(C // g, dim=-1) - mean * mean
    inv = scale.to(st) * torch.rsqrt(var + eps)
    bshape = (B,) + (1,) * (x.ndim - 2) + (C,)
    mul = inv.to(x.dtype).reshape(bshape)
    add = (bias.to(st) - mean * inv).to(x.dtype).reshape(bshape)
    y = x * mul + add
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def fused_groupnorm(x, scale, bias, num_groups, eps, relu, residual=None):
    """:func:`groupnorm_reference` as one CUDA launch (x f32 or bf16, scale
    and bias f32): a block per (frame, group), one read and one write of x."""
    if x.device.type == "cpu":
        return groupnorm_reference(x, scale, bias, num_groups, eps, relu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"fused_groupnorm: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_groupnorm: the kernel takes f32 or bf16, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"fused_groupnorm: x must be (B, ..., C), got {tuple(x.shape)}")
    B, C = x.shape[0], x.shape[-1]
    hw = math.prod(x.shape[1:-1])
    if C % num_groups or hw == 0 or B == 0:
        raise ValueError(f"fused_groupnorm: {C} channels in {num_groups} groups over "
                         f"{hw} positions of {B} frames")
    cpg = C // num_groups
    if cpg * hw >= 2 ** 31 or B * num_groups >= 2 ** 31:
        raise ValueError(f"fused_groupnorm: a group of {cpg * hw} elements or a grid of "
                         f"{B * num_groups} blocks exceeds the kernel's 32-bit indices")
    for t in (scale, bias):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"fused_groupnorm: scale and bias must be contiguous f32 ({C},) "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not x.is_contiguous():
        raise ValueError("fused_groupnorm: the kernel reads a contiguous (B, ..., C) tensor, "
                         f"got shape {tuple(x.shape)} with strides {x.stride()}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError("fused_groupnorm: the residual must be contiguous with x's shape, "
                         f"dtype and device, got {residual.dtype} {tuple(residual.shape)} "
                         f"{residual.stride()}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.maed_groupnorm(
            int(x.dtype == torch.bfloat16), x.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), B, num_groups, cpg, hw, eps, int(bool(relu)),
            torch.cuda.current_stream().cuda_stream), "maed_groupnorm")
    kernels.LAUNCHES["groupnorm"] += 1
    return out
