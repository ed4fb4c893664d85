"""The ResNetV2 of the hybrid stem (non-pre-activation, layers (3, 4, 9)),
and its pre-activation form.

Port of ``maed_tpu/models/resnetv2.py``: the path the ViT hybrid runs, and
``preact=True`` (``PreActBottleneck``: GroupNorm + ReLU before each conv, the
shortcut added after conv3 without a norm, so no residual goes into a norm's
kernel; no stem norm, a final norm). Frames come in NHWC, as in the JAX
package, and run NCHW in shape and channels-last in memory inside the stem.

TF "SAME" padding: XLA pads asymmetrically, the extra row and column at the
end, and ``F.conv2d`` cannot. So every conv and the max-pool pad explicitly,
with the padding computed from the input size (at 224 px the 7x7 stride-2
stem conv pads (2, 3), the stride-2 3x3 convs and the max-pool (0, 1); the
pool pads with -inf). Convolutions stay on cuDNN through ``F.conv2d``, as the
JAX package leaves them to XLA. Every GroupNorm goes through
``ops.groupnorm.fused_groupnorm`` (the CUDA kernel on the card), unless
``plain=True`` asks for its plain version; a bottleneck's norm3 takes the
shortcut as its residual and the ReLU after it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from maed_tpu_torch.ops.groupnorm import fused_groupnorm, groupnorm_reference


def make_div(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor for a TF SAME window of ``kernel`` and ``stride``."""
    top, bottom = same_padding(x.shape[-2], kernel, stride)
    left, right = same_padding(x.shape[-1], kernel, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """Max-pool an NCHW tensor with TF SAME padding (padded with -inf)."""
    return F.max_pool2d(pad_same(x, window, stride, value=-math.inf), window, stride)


class StdConv(nn.Module):
    """Conv with weight standardization (per output channel over I, H, W;
    biased variance; the (std + eps) denominator) and TF SAME padding.

    The standardization runs in the weight's own dtype before the cast to
    the compute dtype. ``standardize=False`` takes weights that
    ``utils.checkpoint.fold_weight_standardization`` already standardized.
    """

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 eps: float = 1e-5, standardize: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_chs, in_chs, kernel_size, kernel_size))
        self.kernel_size, self.stride = kernel_size, stride
        self.eps, self.standardize, self.dtype = eps, standardize, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.standardize:
            mean = w.mean(dim=(1, 2, 3), keepdim=True)
            var = w.var(dim=(1, 2, 3), correction=0, keepdim=True)
            w = (w - mean) / (torch.sqrt(var) + self.eps)
        x = pad_same(x.to(self.dtype), self.kernel_size, self.stride)
        return F.conv2d(x, w.to(self.dtype), stride=self.stride)


class GroupNormAct(nn.Module):
    """GroupNorm(32) with an optional ReLU (``_GroupNormCore`` of the JAX
    package), on an NCHW tensor. The op sees the (B, H, W, C) view of
    channels-last memory, which is how cuDNN leaves the stem's tensors
    downstream of NHWC frames: no copy there. A tensor in another memory
    format is brought to channels-last first."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 apply_act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))
        self.num_groups, self.eps = num_groups, eps
        self.apply_act, self.dtype = apply_act, dtype

    def forward(self, x: torch.Tensor, plain: bool = False, residual=None,
                relu=None) -> torch.Tensor:
        """GroupNorm(x) (+ ``residual``, brought to x's dtype and layout),
        then the ReLU if ``relu`` (default: ``apply_act``); each sum rounded
        to the dtype, as the unfused relu(norm(x) + residual) rounds."""
        norm = groupnorm_reference if plain else fused_groupnorm
        if residual is not None:
            residual = residual.to(self.dtype).contiguous(memory_format=torch.channels_last)
            residual = residual.permute(0, 2, 3, 1)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        y = norm(x.permute(0, 2, 3, 1), self.weight, self.bias, self.num_groups, self.eps,
                 self.apply_act if relu is None else relu, residual)
        return y.permute(0, 3, 1, 2)


class DownsampleConv(nn.Module):
    """The shortcut's 1x1 conv, with a GroupNorm after it unless ``preact``."""

    def __init__(self, in_chs, out_chs, stride, preact=False, standardize=True,
                 dtype=torch.float32):
        super().__init__()
        self.conv = StdConv(in_chs, out_chs, 1, stride, standardize=standardize, dtype=dtype)
        self.norm = None if preact else GroupNormAct(out_chs, apply_act=False, dtype=dtype)

    def forward(self, x, plain=False):
        y = self.conv(x)
        return y if self.norm is None else self.norm(y, plain)


class Bottleneck(nn.Module):
    """Non-pre-activation bottleneck (the variant the ViT hybrid stem uses)."""

    def __init__(self, in_chs, out_chs, stride=1, has_downsample=False,
                 standardize=True, dtype=torch.float32):
        super().__init__()
        mid = make_div(out_chs * 0.25)
        kw = dict(standardize=standardize, dtype=dtype)
        self.downsample = (DownsampleConv(in_chs, out_chs, stride, **kw)
                           if has_downsample else None)
        self.conv1 = StdConv(in_chs, mid, 1, **kw)
        self.norm1 = GroupNormAct(mid, dtype=dtype)
        self.conv2 = StdConv(mid, mid, 3, stride, **kw)
        self.norm2 = GroupNormAct(mid, dtype=dtype)
        self.conv3 = StdConv(mid, out_chs, 1, **kw)
        self.norm3 = GroupNormAct(out_chs, apply_act=False, dtype=dtype)

    def forward(self, x, plain=False):
        shortcut = x if self.downsample is None else self.downsample(x, plain)
        y = self.norm1(self.conv1(x), plain)
        y = self.norm2(self.conv2(y), plain)
        # relu(norm3(y) + shortcut), the sum and the ReLU in norm3's kernel
        return self.norm3(self.conv3(y), plain, residual=shortcut, relu=True)


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck: norm1 + ReLU feeds conv1 and the
    downsample; y + shortcut after conv3, plain (no norm takes it)."""

    def __init__(self, in_chs, out_chs, stride=1, has_downsample=False,
                 standardize=True, dtype=torch.float32):
        super().__init__()
        mid = make_div(out_chs * 0.25)
        kw = dict(standardize=standardize, dtype=dtype)
        self.norm1 = GroupNormAct(in_chs, dtype=dtype)
        self.downsample = (DownsampleConv(in_chs, out_chs, stride, preact=True, **kw)
                           if has_downsample else None)
        self.conv1 = StdConv(in_chs, mid, 1, **kw)
        self.norm2 = GroupNormAct(mid, dtype=dtype)
        self.conv2 = StdConv(mid, mid, 3, stride, **kw)
        self.norm3 = GroupNormAct(mid, dtype=dtype)
        self.conv3 = StdConv(mid, out_chs, 1, **kw)

    def forward(self, x, plain=False):
        x_preact = self.norm1(x, plain)
        shortcut = x if self.downsample is None else self.downsample(x_preact, plain)
        y = self.norm2(self.conv1(x_preact), plain)
        y = self.norm3(self.conv2(y), plain)
        return self.conv3(y) + shortcut


class ResNetStage(nn.Module):
    def __init__(self, in_chs, out_chs, depth, stride, preact=False, standardize=True,
                 dtype=torch.float32):
        super().__init__()
        block = PreActBottleneck if preact else Bottleneck
        self.blocks = nn.ModuleList(
            block(in_chs if i == 0 else out_chs, out_chs,
                  stride=stride if i == 0 else 1, has_downsample=(i == 0),
                  standardize=standardize, dtype=dtype)
            for i in range(depth))

    def forward(self, x, plain=False):
        for block in self.blocks:
            x = block(x, plain)
        return x


class Stem(nn.Module):
    """7x7 stride-2 conv, GroupNorm + ReLU (not ``preact``), 3x3 stride-2 SAME
    max-pool."""

    def __init__(self, out_chs, preact=False, standardize=True, dtype=torch.float32):
        super().__init__()
        self.conv = StdConv(3, out_chs, 7, 2, standardize=standardize, dtype=dtype)
        self.norm = None if preact else GroupNormAct(out_chs, dtype=dtype)

    def forward(self, x, plain=False):
        y = self.conv(x)
        return max_pool_same(y if self.norm is None else self.norm(y, plain))


class ResNetV2(nn.Module):
    """The 3- or 4-stage feature extractor; with layers (3, 4, 9) and not
    ``preact``, the hybrid-ViT stem: (B, 3, 224, 224) -> (B, 1024, 14, 14).
    ``preact`` ends in a GroupNorm + ReLU (``norm``)."""

    def __init__(self, layers=(3, 4, 9), channels=(256, 512, 1024, 2048), stem_chs=64,
                 preact=False, standardize=True, dtype=torch.float32):
        super().__init__()
        self.stem = Stem(make_div(stem_chs), preact, standardize=standardize, dtype=dtype)
        in_chs, stages = make_div(stem_chs), []
        for i, (depth, chs) in enumerate(zip(layers, channels)):
            stages.append(ResNetStage(in_chs, make_div(chs), depth, 1 if i == 0 else 2,
                                      preact=preact, standardize=standardize, dtype=dtype))
            in_chs = make_div(chs)
        self.stages = nn.ModuleList(stages)
        self.norm = GroupNormAct(in_chs, dtype=dtype) if preact else None
        self.num_features = in_chs

    def forward(self, x, plain=False):
        y = self.stem(x, plain)
        for stage in self.stages:
            y = stage(y, plain)
        return y if self.norm is None else self.norm(y, plain)
