"""GroupNorm (+ residual) (+ ReLU) of the hybrid stem: the CUDA kernels of
``csrc/groupnorm.cu`` and their plain PyTorch version.

Counterpart of ``maed_tpu/ops/groupnorm.py``: ``groupnorm_reference`` and
``fused_groupnorm``, whose Pallas kernel ``_gn_kernel`` the stem norm and
every bottleneck norm reach, 52 calls per flagship forward (the 16
bottlenecks' norm3 with the shortcut as the residual and the ReLU after it).
The public contract is the JAX one, ``x`` of shape (B, ..., C) with the
channels last and f32 ``scale`` and ``bias``. The kernels read a contiguous
(B, ..., C) tensor: the port's stem, NCHW in shape, is channels-last in
memory (it is fed channels-last frames and cuDNN keeps the format) and hands
over the (B, H, W, C) view of that memory without a copy.

Two kernels, chosen by dtype and shape alone. In bf16, where C is 8 times a
power of two up to 2048, the groups at most 64 and a frame fits the shared
memory of 8 CTAs, a thread-block cluster a frame (:func:`cluster_groupnorm`,
count ``groupnorm``): every element is read from device memory once and the
moments are shared across the cluster. Otherwise (f32, other widths, larger
frames) a block per group or few groups of a frame (count
``groupnorm_strided``). :func:`fused_groupnorm` has a gradient: autograd
through :func:`groupnorm_reference` on the saved inputs (``ops.recompute``),
as the JAX package's custom VJP recomputes its plain version.
"""

from __future__ import annotations

import math

import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.ops import library
from maed_tpu_torch.ops.recompute import differentiable


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


# The cluster kernel's shared memory, as csrc/groupnorm.cu lays it out
# (cl_x_offset, cl_smem): 8 mbarriers; 2G + ranks x 2G + 2C + rows x 2C
# floats, rows = 8 for C / 8 < 32 16-byte columns, else 256 / (C / 8); then
# the CTA's pixels of x, 128-byte aligned.
_CL_CHUNKS, _CL_SMEM, _CL_MAX_GROUPS = 8, 232448, 64
CLUSTERS = (1, 2, 4, 8)


def cluster_smem(num_groups: int, C: int, ranks: int, pixels: int) -> int:
    """Dynamic shared memory of a cluster kernel CTA, one of ``ranks``, that
    stages ``pixels`` pixels of C bf16 channels."""
    cols = C // 8
    rows = 8 if cols < 32 else 256 // cols
    floats = 2 * num_groups + ranks * 2 * num_groups + 2 * C + rows * 2 * C
    return -(-(_CL_CHUNKS * 8 + 4 * floats) // 128) * 128 + 2 * pixels * C


def cluster_fits(hw: int, C: int, num_groups: int, ranks: int) -> bool:
    """Whether the cluster kernel takes a frame of ``hw`` pixels of C bf16
    channels in ``num_groups`` groups with a cluster of ``ranks`` CTAs."""
    cols = C // 8
    return (C % 8 == 0 and cols <= 256 and not cols & (cols - 1) and C % num_groups == 0
            and num_groups <= _CL_MAX_GROUPS and ranks in CLUSTERS and 0 < ranks <= hw
            and cluster_smem(num_groups, C, ranks, -(-hw // ranks)) <= _CL_SMEM)


def cluster_size(hw: int, C: int, num_groups: int):
    """CTAs a frame of ``hw`` pixels of C bf16 channels takes in the cluster
    kernel: the fewest, at least 2, whose shares of the frame fit their
    shared memory (1 for a one-pixel frame; a 1.6 MB frame takes 8 shares of
    196 KB); or None where the kernel does not take it (C not 8 times a
    power of two up to 2048, more than 64 groups or groups that do not
    divide C, a frame beyond 8 CTAs' shared memory). Timed against the
    other sizes at every stem site on an H100 (tools/bench_kernels.py), this
    choice was the fastest or within 1% at 7 of the 9 shapes and within 4%
    at the other two."""
    fits = [r for r in CLUSTERS if cluster_fits(hw, C, num_groups, r)]
    if not fits:
        return None
    return next((r for r in fits if r >= 2), fits[0])


def _check(name, x, scale, bias, num_groups, residual):
    """Raise unless the kernels take these operands; returns (B, HW, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: the kernel takes f32 or bf16, got {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"{name}: x must be (B, ..., C), got {tuple(x.shape)}")
    B, C = x.shape[0], x.shape[-1]
    hw = math.prod(x.shape[1:-1])
    if C % num_groups or hw == 0 or B == 0:
        raise ValueError(f"{name}: {C} channels in {num_groups} groups over "
                         f"{hw} positions of {B} frames")
    cpg = C // num_groups
    if cpg * hw >= 2 ** 31 or B * num_groups >= 2 ** 31 or B * 8 >= 2 ** 31:
        raise ValueError(f"{name}: a group of {cpg * hw} elements or a grid of "
                         f"{B * num_groups} blocks exceeds the kernel's 32-bit indices")
    for t in (scale, bias):
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: scale and bias must be contiguous f32 ({C},) "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel reads a contiguous (B, ..., C) tensor, "
                         f"got shape {tuple(x.shape)} with strides {x.stride()}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or not residual.is_contiguous()):
        raise ValueError(f"{name}: the residual must be contiguous with x's shape, "
                         f"dtype and device, got {residual.dtype} {tuple(residual.shape)} "
                         f"{residual.stride()}")
    return B, hw, C


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _launch_cluster(x, scale, bias, num_groups, eps, relu, residual, B, hw, C, ranks):
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.maed_groupnorm_cluster(
            x.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), B, num_groups, C, hw, ranks, eps,
            int(bool(relu)), torch.cuda.current_stream().cuda_stream), "maed_groupnorm_cluster")
    kernels.LAUNCHES["groupnorm"] += 1
    return out


def cluster_groupnorm(x, scale, bias, num_groups, eps, relu, residual=None, ranks=None):
    """:func:`groupnorm_reference` through the bf16 cluster kernel, a frame
    by ``ranks`` CTAs (default :func:`cluster_size`'s); raises where that
    kernel does not take the operands or the cluster. What
    :func:`fused_groupnorm` launches in bf16 wherever it can."""
    B, hw, C = _check("cluster_groupnorm", x, scale, bias, num_groups, residual)
    if x.dtype != torch.bfloat16 or not _aligned(x, residual):
        raise ValueError("cluster_groupnorm: the cluster kernel takes 16-byte aligned bf16, "
                         f"got {x.dtype}")
    if ranks is None:
        ranks = cluster_size(hw, C, num_groups)
    if ranks is None or not cluster_fits(hw, C, num_groups, ranks):
        raise ValueError(f"cluster_groupnorm: no cluster of {ranks} CTAs for {hw} pixels of "
                         f"{C} channels in {num_groups} groups")
    return _launch_cluster(x, scale, bias, num_groups, eps, relu, residual, B, hw, C, ranks)


def fused_groupnorm(x, scale, bias, num_groups, eps, relu, residual=None):
    """:func:`groupnorm_reference` as one CUDA launch (x f32 or bf16, scale
    and bias f32): in bf16 a cluster of CTAs a frame where
    :func:`cluster_size` allows, else a block per (frame, group); one read
    and one write of x."""
    return differentiable(_groupnorm_kernel, groupnorm_reference, x, scale, bias, num_groups,
                          eps, relu, residual)


def _groupnorm_kernel(x, scale, bias, num_groups, eps, relu, residual):
    B, hw, C = _check("fused_groupnorm", x, scale, bias, num_groups, residual)
    if x.dtype == torch.bfloat16 and _aligned(x, residual):
        ranks = cluster_size(hw, C, num_groups)
        if ranks is not None:
            return _launch_cluster(x, scale, bias, num_groups, eps, relu, residual, B, hw, C,
                                   ranks)
    cpg = C // num_groups
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        kernels.check(lib.maed_groupnorm(
            int(x.dtype == torch.bfloat16), x.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), B, num_groups, cpg, hw, eps, int(bool(relu)),
            torch.cuda.current_stream().cuda_stream), "maed_groupnorm")
    kernels.LAUNCHES["groupnorm_strided"] += 1
    return out


library.define("groupnorm(Tensor x, Tensor scale, Tensor bias, int num_groups, float eps, "
               "bool relu, Tensor? residual) -> Tensor", _groupnorm_kernel, groupnorm_reference)
