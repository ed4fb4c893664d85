"""The port's kernels against their plain versions on the card, at small and
ragged shapes (chip_smoke.py checks them at the flagship shapes).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run these there with:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from maed_tpu_torch import kernels
from maed_tpu_torch.ops import layernorm as TLN
from maed_tpu_torch.ops import mlp as TMLP
from maed_tpu_torch.ops import skinning as TK
from torch_port_common import assert_close, ln_inputs, mlp_inputs, to_torch, torch_mlp_args

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels run only on the card")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def test_skinning_kernel(cuda):
    """f32 at atol 1e-5 (m): the kernel and the einsums sum the 24 joints in
    different orders."""
    rng = np.random.RandomState(4)
    B, V = 3, 1000  # V is not a multiple of the 128-vertex block
    W = rng.rand(V, 24)
    W /= W.sum(axis=1, keepdims=True)
    A = rng.randn(B, 24, 4, 4) * 0.3
    args = [to_torch(a, torch.float32).to(cuda) for a in (rng.randn(B, V, 3), W, A)]
    before = kernels.LAUNCHES["skinning"]
    got = TK.skinning(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["skinning"] == before + 1
    assert_close(got, TK.skinning_reference(*args), 1e-5)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-5, 0.0),
                                               (torch.bfloat16, 2e-2, 1e-2)])
@pytest.mark.parametrize("C", [768, 100])
def test_layernorm_kernel(cuda, dtype, atol, rtol, C):
    """bf16 at 2e-2 abs + 1e-2 rel: one bf16 rounding of outputs up to ~5."""
    x, s, b = ln_inputs(np.random.RandomState(5), (37, C))
    x = to_torch(x, dtype).to(cuda)
    s, b = (to_torch(a, torch.float32).to(cuda) for a in (s, b))
    before = kernels.LAUNCHES["layernorm"]
    got = TLN.fast_layernorm(x, s, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["layernorm"] == before + 1
    assert got.dtype == dtype
    assert_close(got.float(), TLN.layernorm_reference(x, s, b, 1e-6).float(), atol, rtol)


@pytest.mark.parametrize("dtype, atol, rtol", [(torch.float32, 1e-4, 0.0),
                                               (torch.bfloat16, 5e-2, 2e-2)])
@pytest.mark.parametrize("M, C, H", [(256, 768, 3072), (100, 80, 176)])
def test_ln_mlp_kernel(cuda, dtype, atol, rtol, M, C, H):
    """(100, 80, 176) leaves ragged tiles on every axis: M and N past a 64
    tile, K past a 32 step. bf16 tolerates an h element rounding to the
    neighbouring bf16 value on one side only."""
    args = torch_mlp_args(mlp_inputs(np.random.RandomState(6), (M, C), H), dtype)
    args = [a.to(cuda) for a in args]
    before = kernels.LAUNCHES["ln_mlp_fc1"], kernels.LAUNCHES["ln_mlp_fc2"]
    got = TMLP.fused_ln_mlp(*args)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["ln_mlp_fc1"], kernels.LAUNCHES["ln_mlp_fc2"]) == \
        (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    assert_close(got.float(), TMLP.ln_mlp_reference(*args, 1e-6).float(), atol, rtol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """No quiet fallback: a CUDA tensor the kernel cannot take raises."""
    x = torch.zeros(4, 16, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        TLN.fast_layernorm(x, torch.ones(16, device=cuda), torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        TK.skinning(torch.zeros(2, 8, 3, device=cuda, dtype=torch.bfloat16),
                    torch.zeros(8, 24, device=cuda), torch.zeros(2, 24, 4, 4, device=cuda))
    # the bf16 MLP kernel moves 16-byte rows: C = 100 is not a multiple of 8
    args = torch_mlp_args(mlp_inputs(np.random.RandomState(7), (16, 100), 64), torch.bfloat16)
    with pytest.raises(ValueError):
        TMLP.fused_ln_mlp(*(a.to(cuda) for a in args))
