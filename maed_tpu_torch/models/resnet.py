"""The ResNet-50 (v1.5) feature extractor of the stage-1 'cnn' encoder, with
BatchNorm and its running statistics.

Port of ``maed_tpu/models/resnet.py``. Frames come in NHWC, as in the JAX
package, and run NCHW in shape and channels-last in memory (how cuDNN keeps
a tensor that starts NHWC). The convolutions stay on cuDNN through
``F.conv2d``, as the JAX package leaves them to XLA; there is no kernel of
the port here.

Padding is symmetric: every conv pads ``k // 2`` on both sides, the max-pool
one row and column of -inf (``F.max_pool2d``'s own padding), then 3x3
stride 2. v1.5 puts a block's stride on its 3x3; the downsample is a 1x1
with the block's stride, then BN. The names are torchvision's
(``conv1``, ``bn1``, ``layer{1-4}.{i}.conv{1-3}``, ``.bn{1-3}``,
``.downsample.{0,1}``), those of the reference checkpoints.

:class:`BatchNorm` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
a training forward normalizes by the batch's mean and biased variance and
moves the running statistics a tenth of the way to them, the biased
variance included (``torch.nn.BatchNorm2d`` would store the unbiased one).
An eval forward normalizes by the running statistics. The statistics and
the affine stay in f32 whatever the compute dtype, as flax's
``BatchNorm(dtype=bf16)`` reduces in f32.

Under data parallelism (a process group, ``parallel.dist``) a training
forward takes the moments of the global batch, as the JAX package's
``nn.BatchNorm`` without ``axis_name`` does under its 'dp' mesh and the
original MAED's SyncBatchNorm did: each rank's (n mean, n (var + mean^2),
n) a channel, summed over the ranks in f64 in one differentiable
collective a layer, normalize the rank's slice and move the running
statistics, the biased variance again (``torch.nn.SyncBatchNorm`` would
store the unbiased one, and takes no CPU tensor).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maed_tpu_torch.parallel import dist


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` (bias-free) on ``x`` in ``dtype``, as flax's ``nn.Conv(dtype=...)``
    casts its input and kernel."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), None, layer.stride, layer.padding)


class BatchNorm(nn.Module):
    """BatchNorm over the channels of an NCHW tensor with flax's update of
    the running statistics. ``momentum`` is PyTorch's (0.1 is flax's 0.9)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def reset_(self) -> None:
        """flax's initial state: scale 1, bias 0, mean 0, variance 1."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics a ``momentum`` of the way to a batch's
        mean and biased variance."""
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)
            self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if dist.initialized():
            return self._global_batch(x)
        with torch.no_grad():
            stat = x.detach().to(torch.promote_types(x.dtype, torch.float32))
            var, mean = torch.var_mean(stat, dim=(0, 2, 3), correction=0)
            self._track(mean, var)
        # normalized by the batch's own (biased) moments; the running
        # statistics were updated above
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """A training forward over the moments of every rank's batch, with the
        gradient through them."""
        acc = torch.promote_types(x.dtype, torch.float32)
        xa = x.to(acc)
        var, mean = torch.var_mean(xa, dim=(0, 2, 3), correction=0)
        n = x.numel() // x.shape[1]
        m64, v64 = mean.double(), var.double()
        total = dist.sum_over_ranks(torch.cat([n * m64, n * (v64 + m64 * m64),
                                               m64.new_full((1,), float(n))]))
        C = x.shape[1]
        g_mean = total[:C] / total[-1]
        g_var = total[C:2 * C] / total[-1] - g_mean * g_mean
        self._track(g_mean.detach(), g_var.detach())
        scale = self.weight.to(acc) * torch.rsqrt(g_var.to(acc) + self.eps)
        shift = self.bias.to(acc) - g_mean.to(acc) * scale
        return (xa * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def _conv(in_chs: int, out_chs: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_chs, out_chs, kernel, stride, padding=kernel // 2, bias=False)


class Bottleneck(nn.Module):
    """``BottleneckV1``: 1x1, 3x3 (the stride), 1x1 to ``out_chs``, each with
    BN, ReLU after the first two and after the residual sum."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1,
                 has_downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = out_chs // 4
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(in_chs, mid, 1), BatchNorm(mid)
        self.conv2, self.bn2 = _conv(mid, mid, 3, stride), BatchNorm(mid)
        self.conv3, self.bn3 = _conv(mid, out_chs, 1), BatchNorm(out_chs)
        self.downsample = (nn.ModuleList([_conv(in_chs, out_chs, 1, stride), BatchNorm(out_chs)])
                           if has_downsample else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.dtype
        shortcut = x
        if self.downsample is not None:
            ds_conv, ds_bn = self.downsample
            shortcut = ds_bn(conv(x, ds_conv, dt), train)
        y = F.relu(self.bn1(conv(x, self.conv1, dt), train))
        y = F.relu(self.bn2(conv(y, self.conv2, dt), train))
        y = self.bn3(conv(y, self.conv3, dt), train)
        return F.relu(y + shortcut)


class ResNet50(nn.Module):
    """(B, H, W, 3) frames -> (B, channels[-1]) features: the stem, four
    stages of ``layers`` bottlenecks, the global mean over H and W. The
    JAX package's ``layers`` and ``channels`` fields, so that a narrow
    ResNet50 can be built on both sides."""

    def __init__(self, layers=(3, 4, 6, 3), channels=(256, 512, 1024, 2048),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), BatchNorm(64)
        in_chs = 64
        for si, (depth, chs) in enumerate(zip(layers, channels)):
            blocks = []
            for bi in range(depth):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                blocks.append(Bottleneck(in_chs, chs, stride, has_downsample=bi == 0,
                                         dtype=dtype))
                in_chs = chs
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))
        self.num_stages = len(layers)
        self.num_features = channels[-1]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv(x.permute(0, 3, 1, 2), self.conv1, self.dtype)
        y = F.relu(self.bn1(y, train))
        y = F.max_pool2d(y, 3, 2, padding=1)
        for si in range(self.num_stages):
            for block in getattr(self, f"layer{si + 1}"):
                y = block(y, train)
        return y.mean(dim=(2, 3))
