"""Fused attention over (B, h, S, d): the CUDA kernels of
``csrc/st_attention.cu`` and their plain PyTorch versions.

Counterpart of ``maed_tpu/ops/attention.py``, with its dispatch:

- S <= 1024, its one-shot Pallas kernel (``_attn_oneshot_kernel``): the same
  function as the spatial branch's kernel in another layout, so
  ``fused_attention`` launches that kernel on (B, h, S, d) strides. Plain
  version: :func:`_xla_attention` (softmax normalised, then rounded to v's
  dtype).
- S > 1024, its blocked kernel (``_attn_blocked_kernel``, reached by st_mode
  'coupling' with S = T * N): one pass over the keys with an online softmax,
  which rounds the UNNORMALISED p = exp(s - running max) to v's dtype before
  the p v product, sums the unrounded p, and divides once at the end. Plain
  version: :func:`attention_blocked_reference`, the same steps over key blocks
  of 512 as the TPU kernel takes them. The CUDA kernels walk tiles of 128
  keys in both dtypes; in exact arithmetic the block size does not matter,
  in bf16 a running max that moves at other columns lets an unnormalised p
  round to the neighbouring value.

q, k, v share their strides and are read in place: contiguous tensors, or
three views of one qkv projection; the output may be a view too (see
:func:`attention_blocked`), except under grad. Both entry points have a
gradient: autograd through the plain version of the kernel they launch, on
the saved q, k and v (``ops.recompute``). The JAX package's attention has no
custom VJP, so its gradient is that of the same plain function.
"""

from __future__ import annotations

import torch

from maed_tpu_torch.ops import library
from maed_tpu_torch.ops.recompute import differentiable, needs_grad
from maed_tpu_torch.ops.st_attention import MAX_TOKENS, _attend, launch_bhsd


def _xla_attention(q, k, v, scale):
    """softmax(q k^T * scale) v for (B, h, S, d), with the kernel's rounding
    points (see ``ops.st_attention``); named after the JAX package's plain
    version."""
    return _attend(q, k, v, scale, "bhsd,bhtd->bhst", "bhst,bhtd->bhsd")


def attention_blocked_reference(q, k, v, scale, block_k: int = 512):
    """softmax(q k^T * scale) v for (B, h, S, d) by an online softmax over key
    blocks of ``block_k``, with the blocked kernel's rounding points: scores,
    running max m, running sum l and accumulator in promote(dtype, f32); p =
    exp(s - m_new) rounded to v's dtype unnormalised for the p v product,
    while l sums the unrounded p; acc / l once at the end, then the cast."""
    st = torch.promote_types(q.dtype, torch.float32)
    B, h, S, d = q.shape
    qf = q.to(st)
    m = torch.full((B, h, S, 1), float("-inf"), dtype=st, device=q.device)
    l = torch.zeros((B, h, S, 1), dtype=st, device=q.device)
    acc = torch.zeros((B, h, S, d), dtype=st, device=q.device)
    for k0 in range(0, S, block_k):
        kb, vb = k[:, :, k0:k0 + block_k].to(st), v[:, :, k0:k0 + block_k].to(st)
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).to(st), vb)
        m = m_new
    return (acc / l).to(q.dtype)


def _check_bhsd(name, q):
    if q.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be (B, h, S, d), got {tuple(q.shape)}")


def _deliver(result, out):
    """A plain version's result, into ``out`` where the caller gave one."""
    if out is None:
        return result
    out.copy_(result)
    return out


def _launch(name, q, k, v, scale, out=None, blocked=False):
    """One kernel launch into ``out`` (a new tensor if None); returns it."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch_bhsd(name, q, k, v, out, scale, blocked=blocked)
    return out


def _blocked(q, k, v, scale):
    return _launch("attention_blocked", q, k, v, scale, blocked=True)


def _oneshot(q, k, v, scale):
    return _launch("fused_attention", q, k, v, scale)


library.define("attention_blocked(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
               _blocked, attention_blocked_reference)
library.define("attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor", _oneshot,
               _xla_attention)


def _call(name, kernel, reference, q, k, v, scale, out):
    """kernel(q, k, v, scale) with its gradient; with ``out``, which
    autograd cannot track, the kernel or the plain version writes there (an
    eager call: an export traces the form that returns its own tensor)."""
    if out is None:
        return differentiable(kernel, reference, q, k, v, scale)
    if needs_grad(q, k, v):
        raise ValueError(f"{name}: out= is a view written in place, which autograd cannot "
                         "track; under grad call it without out")
    if q.device.type == "cpu":
        return _deliver(reference(q, k, v, scale), out)
    return _launch(name, q, k, v, scale, out, blocked=kernel is _blocked)


def attention_blocked(q, k, v, scale=None, out=None):
    """:func:`attention_blocked_reference` as one CUDA launch, for any S.

    ``out``, if given, is a (B, h, S, d) view (head dim contiguous) that the
    kernel writes in place of a new tensor: the coupling mode hands a view
    of its (BT, N, h * d) result, so nothing is transposed afterwards. Under
    grad it raises if given one.
    """
    _check_bhsd("attention_blocked", q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _call("attention_blocked", _blocked, attention_blocked_reference, q, k, v, scale, out)


def fused_attention(q, k, v, scale=None, out=None):
    """softmax(q k^T * scale) v as one CUDA launch; q, k, v (B, h, S, d) with
    the same strides. Up to 1024 tokens the spatial kernel
    (:func:`_xla_attention` for a CPU tensor), beyond them the blocked one
    (:func:`attention_blocked`)."""
    _check_bhsd("fused_attention", q)
    S, d = q.shape[-2:]
    if scale is None:
        scale = d ** -0.5
    if S > MAX_TOKENS:
        return attention_blocked(q, k, v, scale, out)
    return _call("fused_attention", _oneshot, _xla_attention, q, k, v, scale, out)
