"""The port's kernel modules held against the JAX package's Pallas kernels,
on the CPU.

The JAX kernels run in interpret mode, as tests/test_pallas_fused runs them,
against what the port's wrappers run for a CPU tensor (their plain
versions), in f32 at atol 1e-5 (the Pallas bodies compute in f32 even for
f64 input, and _mlp_kernel's A&S erf is off by up to 1.5e-7). The JAX plain
references and the port's are compared in f64 at atol 1e-9. The kernels
themselves are held against these plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.ops import layernorm as JLN
from maed_tpu.ops import mlp as JMLP
from maed_tpu_torch.ops import layernorm as TLN
from maed_tpu_torch.ops import mlp as TMLP
from torch_port_common import assert_close, ln_inputs, mlp_inputs, to_torch, torch_mlp_args


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JLN, "_INTERPRET", True)
    monkeypatch.setattr(JMLP, "_INTERPRET", True)


def test_layernorm_matches_the_pallas_kernel(interpret):
    args = [a.astype(np.float32) for a in ln_inputs(np.random.RandomState(0))]
    want = JLN.fast_layernorm(*(jnp.asarray(a) for a in args), 1e-6)
    got = TLN.fast_layernorm(*(to_torch(a) for a in args), 1e-6)
    assert_close(got, want, 1e-5)


def test_layernorm_reference_matches_jax_f64():
    args = ln_inputs(np.random.RandomState(1))
    with jax.enable_x64(True):
        want = JLN.layernorm_reference(*(jnp.asarray(a) for a in args), 1e-6)
    got = TLN.layernorm_reference(*(to_torch(a) for a in args), 1e-6)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)


def test_ln_mlp_matches_the_pallas_kernel(interpret):
    args = [a.astype(np.float32) for a in mlp_inputs(np.random.RandomState(2))]
    with jax.default_matmul_precision("highest"):
        want = JMLP.fused_ln_mlp(*(jnp.asarray(a) for a in args))
    got = TMLP.fused_ln_mlp(*torch_mlp_args(args, torch.float32))
    assert_close(got, want, 1e-5)


def test_ln_mlp_reference_matches_jax_f64():
    args = mlp_inputs(np.random.RandomState(3))
    with jax.enable_x64(True):
        want = JMLP.ln_mlp_reference(*(jnp.asarray(a) for a in args), 1e-6)
    got = TMLP.ln_mlp_reference(*torch_mlp_args(args, torch.float64), 1e-6)
    assert got.dtype == torch.float64
    assert_close(got, want, 1e-9)
