"""Gradients through the kernels: the kernel forward, and for the backward
autograd through the kernel's plain version on the saved inputs.

No Pallas kernel of ``maed_tpu/ops`` has a backward kernel: each custom VJP
recomputes the forward through its plain reference and takes that function's
VJP (``smpl_pallas.py``, ``layernorm.py``, ``mlp.py``, ``groupnorm.py``,
``st_attention.py``). :func:`differentiable` does the same for the port's
kernels. Under grad it calls ``_Recompute``, a ``torch.autograd.Function``
whose forward is the kernel (or, for a CPU tensor, the plain version itself)
and which saves the inputs, never the kernel's intermediates. Its backward
runs the plain version on those inputs under ``torch.enable_grad()`` and
returns ``torch.autograd.grad`` of it, so the backward launches no kernel.
With no grad (eval, ``torch.inference_mode``, ``torch.no_grad``) or no input
that requires one, :func:`differentiable` calls the forward directly, as the
wrappers did before they had a backward.
"""

from __future__ import annotations

import torch


def needs_grad(*args) -> bool:
    """Whether autograd records a function of ``args``: grad mode is on and
    one of the tensors among them requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class _Recompute(torch.autograd.Function):
    """forward(*args) now, autograd through plain(*args) in the backward.
    The first ``n_diff`` outputs are differentiable; the rest (a tuple's
    tail, such as the gate weights of ``fused_gate_proj``) go out detached."""

    @staticmethod
    def forward(ctx, forward, plain, n_diff, *args):
        is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.plain, ctx.n_diff, ctx.is_tensor = plain, n_diff, is_tensor
        ctx.others = [None if t else a for a, t in zip(args, is_tensor)]
        ctx.save_for_backward(*(a for a, t in zip(args, is_tensor) if t))
        out = forward(*args)
        if isinstance(out, tuple):
            ctx.mark_non_differentiable(*out[n_diff:])
        return out

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[3:]
        args = [next(saved).detach().requires_grad_(need) if t else other
                for t, other, need in zip(ctx.is_tensor, ctx.others, needs)]
        with torch.enable_grad():
            out = ctx.plain(*args)
        outs = out[:ctx.n_diff] if isinstance(out, tuple) else (out,)
        wrt = [a for a, need in zip(args, needs) if need]
        got = iter(torch.autograd.grad(outs, wrt, grads[:len(outs)], allow_unused=True))
        return (None, None, None, *(next(got) if need else None for need in needs))


def differentiable(kernel, plain, *args, n_diff: int = 1):
    """``kernel(*args)`` with a gradient: autograd through ``plain(*args)``
    in the backward. The forward is ``plain`` itself where the first
    argument lies on the CPU. Only tensors among ``args`` get gradients;
    ``n_diff`` counts the differentiable outputs of a tuple result."""
    forward = plain if args[0].device.type == "cpu" else kernel
    if needs_grad(*args):
        return _Recompute.apply(forward, plain, n_diff, *args)
    return forward(*args)
