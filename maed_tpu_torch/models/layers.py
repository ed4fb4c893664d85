"""The dense layer with flax's rounding points, shared by the encoder and decoder.

flax's ``nn.Dense(dtype=d)`` casts the input, the kernel and the bias to
``d``, multiplies, and adds the bias in ``d``. Parameters are f32, as flax
keeps them, and are cast where they are used; ``core.builder`` casts them to
``d`` once at build (``cast_weights_``), so that in the eval model the casts
here copy nothing.
"""

from __future__ import annotations

import torch
from torch import nn


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied to ``x`` in ``dtype``: the product, then the bias."""
    y = torch.matmul(x.to(dtype), layer.weight.to(dtype).t())
    return y + layer.bias.to(dtype)
