"""The dense layer with flax's rounding points, and the dropout layers, shared
by the encoder and decoder.

flax's ``nn.Dense(dtype=d)`` casts the input, the kernel and the bias to
``d``, multiplies, and adds the bias in ``d``. Parameters are f32, as flax
keeps them, and are cast where they are used; ``core.builder`` casts them to
``d`` once at build (``cast_weights_``), so that in the eval model the casts
here copy nothing. A training model (``core.builder.build_train_model``)
keeps them f32 and casts at use.

The dropout layers take the training flag and the generator as arguments,
as flax's take ``deterministic`` and their rng: a module called without them
is deterministic whatever its ``training`` attribute says.
"""

from __future__ import annotations

import torch
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied to ``x`` in ``dtype``: the product, then the bias
    (if the layer has one)."""
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
    return y if layer.bias is None else y + layer.bias.to(dtype)


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` in a training forward: each entry kept with
    probability 1 - rate and scaled by 1 / (1 - rate), ``where(mask, x /
    keep, 0)``; the mask drawn from the step's ``generator``. Called with
    ``train=False`` or at rate 0 it returns x and draws nothing."""

    per_sample = False

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, shard=None) -> torch.Tensor:
        """``shard = (dim, start, full)``: x is the slice [start, start +
        x.shape[dim]) along ``dim`` of a tensor ``full`` long there (a
        tensor-parallel rank's heads or hidden columns); the mask is drawn
        whole, as for that tensor, and cut to the slice, so that the ranks
        together draw the one-process mask."""
        if not train or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError(f"{type(self).__name__}({self.rate}): a training forward draws its "
                             "masks from an explicit torch.Generator; pass generator=")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1) if self.per_sample else x.shape
        if shard is not None:
            dim, start, full = shard
            shape = list(shape)
            shape[dim] = full
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        if shard is not None:
            mask = mask.narrow(dim, start, x.shape[dim])
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(Dropout):
    """Stochastic depth on a residual branch (the JAX package's
    ``DropPath``): one draw per sample, its whole row kept (scaled) or
    zeroed."""

    per_sample = True
