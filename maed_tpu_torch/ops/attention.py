"""Fused attention over (B, h, S, d): the spatial CUDA kernel of
``csrc/st_attention.cu`` and its plain PyTorch version.

Counterpart of ``maed_tpu/ops/attention.py``. Its one-shot Pallas kernel
(``_attn_oneshot_kernel``, S <= 1024) is the same function as the spatial
branch's kernel in another layout, so ``fused_attention`` launches that
kernel on (B, h, S, d) strides. Its blocked kernel (``_attn_blocked_kernel``,
online softmax for S > 1024, reached only by st_mode 'coupling') has no port
yet: a longer sequence raises.
"""

from __future__ import annotations

import torch

from maed_tpu_torch.ops.st_attention import MAX_TOKENS, _attend, launch_spatial


def _xla_attention(q, k, v, scale):
    """softmax(q k^T * scale) v for (B, h, S, d), with the kernel's rounding
    points (see ``ops.st_attention``); named after the JAX package's plain
    version."""
    return _attend(q, k, v, scale, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd")


def fused_attention(q, k, v, scale=None):
    """:func:`_xla_attention` as one CUDA launch; q, k, v (B, h, S, d) with
    the same strides (contiguous tensors, or three views of one projection)."""
    if q.ndim != 4:
        raise ValueError(f"fused_attention: q, k, v must be (B, h, S, d), got {tuple(q.shape)}")
    S, d = q.shape[-2:]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return _xla_attention(q, k, v, scale)
    if S > MAX_TOKENS:
        raise NotImplementedError(
            f"fused_attention: {S} tokens; the blocked kernel for more than {MAX_TOKENS} "
            "(kernel K, maed_tpu/ops/attention.py::_attn_blocked_kernel) is still to be "
            "ported: see ROADMAP.md")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_spatial("fused_attention", q, k, v, out, scale)
    return out
