"""The Megatron operators of tensor parallelism over a mesh's tp group, as
autograd Functions.

- :func:`copy_to_tp` goes in front of a column-parallel product (qkv, fc1):
  forward the identity, backward the sum over the group of the ranks'
  partial gradients.
- :func:`reduce_from_tp` goes after a row-parallel product (proj, fc2):
  forward the sum over the group of the ranks' partial outputs, backward
  the identity (every rank holds the whole gradient of the replicated
  result).
- :func:`gather_segments` assembles a tensor whose last axis is made of
  segments split over the group (the gate's branch means [mean y_s || mean
  y_t], each rank holding its channels of both): forward each rank's part
  placed in zeros and summed over the group, backward the sum over the
  group of the full gradient (the ranks' uses of the gathered tensor are
  partial) cut to the rank's part.

Every collective is an all-reduce: gloo, which two ranks on one card use,
offers no gather of CUDA tensors. A bf16 (or f16) tensor is summed in f32
and rounded once. With tp = 1 each is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``t``, in a new contiguous tensor of t's
    dtype (a 16-bit float summed in f32)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        out = t.to(torch.float32, memory_format=torch.contiguous_format)
        tdist.all_reduce(out, group=group)
        return out.to(t.dtype)
    out = t.clone(memory_format=torch.contiguous_format)
    tdist.all_reduce(out, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherSegments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, segments, tp, tp_rank, group):
        *lead, width = t.shape
        w = width // segments
        full = torch.zeros((*lead, segments, tp, w), dtype=t.dtype, device=t.device)
        full[..., tp_rank, :] = t.reshape(*lead, segments, w)
        ctx.meta = segments, tp, tp_rank, group
        return _all_reduce(full.reshape(*lead, segments * tp * w), group)

    @staticmethod
    def backward(ctx, grad):
        segments, tp, tp_rank, group = ctx.meta
        *lead, width = grad.shape
        full = _all_reduce(grad, group).reshape(*lead, segments, tp, width // segments // tp)
        return full[..., tp_rank, :].reshape(*lead, width // tp), None, None, None, None


def copy_to_tp(t: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is None or mesh.tp == 1:
        return t
    return _CopyToTP.apply(t, mesh.tp_group)


def reduce_from_tp(t: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is None or mesh.tp == 1:
        return t
    return _ReduceFromTP.apply(t, mesh.tp_group)


def gather_segments(t: torch.Tensor, segments: int, mesh) -> torch.Tensor:
    """(..., segments * w) on each rank -> (..., segments * tp * w): segment
    i of rank r at [(i tp + r) w, (i tp + r + 1) w)."""
    if mesh is None or mesh.tp == 1:
        return t
    return _GatherSegments.apply(t, segments, mesh.tp, mesh.tp_rank, mesh.tp_group)
