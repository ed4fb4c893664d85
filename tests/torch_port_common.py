"""Shared helpers of the tests of maed_tpu_torch.

Inputs are made with numpy from a seed and handed to both sides: to the JAX
package as numpy arrays, to the port as tensors. This module imports no JAX,
so the tests that run on the card, where JAX is absent, can use it.
"""

import numpy as np
import torch


def to_torch(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(_numpy(got), _numpy(want), atol=atol, rtol=rtol, err_msg=what)


def ln_inputs(rng, shape=(3, 7, 64)):
    """x, LayerNorm scale and bias."""
    C = shape[-1]
    return (rng.randn(*shape) * 2 + 0.5, rng.rand(C) + 0.5, rng.randn(C) * 0.1)


def mlp_inputs(rng, shape=(3, 7, 64), H=128):
    """x, ln scale and bias, then w1 (C, H), b1, w2 (H, C), b2 as flax stores
    them; the weights scaled by 1/sqrt(fan_in), so outputs stay O(1) at any width."""
    C = shape[-1]
    return (rng.randn(*shape), rng.rand(C) + 0.5, rng.randn(C) * 0.1,
            rng.randn(C, H) / np.sqrt(C), rng.randn(H) * 0.1, rng.randn(H, C) / np.sqrt(H),
            rng.randn(C) * 0.1)


def torch_mlp_args(args, dtype):
    """The flax-layout MLP inputs as the port takes them: nn.Linear's (out,
    in) weights in x's dtype, the LN parameters and biases f32 (f64 for an
    f64 x, as the JAX f64 reference has them)."""
    x, s, b, w1, b1, w2, b2 = args
    pdt = torch.promote_types(dtype, torch.float32)

    def T(a, dt=pdt):
        return to_torch(a).to(dt)

    return (T(x, dtype), T(s), T(b), T(w1.T, dtype), T(b1), T(w2.T, dtype), T(b2))
