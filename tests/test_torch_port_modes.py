"""Every ``st_mode`` of the port's encoder against the JAX package's, on the CPU.

A transformer block (norm1, ``StAttention``, the MLP) and the whole tiny MAED
(1 block, 2 heads, KTD hidden 32, 32 px, a 64-vertex synthetic SMPL), for
each mode of ``ST_MODES``, with the JAX parameters carried across by
``state_dict_from_jax`` and loaded with ``strict=True``: a mode without
``ts_attn`` or ``temp_embed`` must neither miss nor leave over a key.

f64 (JAX under ``jax.enable_x64(True)``) at atol 1e-9 for a block and 1e-8
for the model, as the parallel mode is held in tests/test_torch_port_models.py
and tests/test_torch_port_slice.py. The coupling model is also held in f32 to
the JAX model with ``MAED_FUSED_ATTENTION=1``, whose attention is the Pallas
kernel in interpret mode, at atol 1e-3, rtol 1e-3: at these random weights
either f32 answer lies up to 1e-3 from the f64 one (theta and rotmat come
from normalising near-zero 6D regressor outputs; over clip seeds 2, 5, 6 the
port's f32 answer was 2e-4 to 6e-4 from f64 and JAX's 1e-4 to 1e-3), while JAX
with and without its kernel differ by 1e-5. The attention step by itself is
held at 5e-5 in tests/test_torch_port_kernels.py.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.models import MAED as JMAED
from maed_tpu.models.vit import ST_MODES as J_ST_MODES
from maed_tpu.models.vit import Block as JBlock
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch.core.builder import build_eval_model
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.vit import ST_MODES, TEMP_EMBED_MODES, StAttention
from maed_tpu_torch.models.vit import Block as TBlock
from maed_tpu_torch.ops import attention as TA
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import as_f64, random_params, sub_state_dict
from torch_port_common import assert_close, one_torch_thread, to_torch  # noqa: F401

CONFIG = dict(num_blocks=1, num_heads=2, hidden_dim=32)
SHAPE = (2, 2, 32, 32, 3)   # 2 clips of 2 frames
OUTPUTS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")


def test_st_modes_are_the_jax_packages():
    assert ST_MODES == J_ST_MODES
    with pytest.raises(ValueError, match="st_mode"):
        StAttention(16, 2, "joint")


@pytest.mark.parametrize("seqlen", [1, 2, 4])
@pytest.mark.parametrize("mode", ST_MODES)
def test_block_matches_jax_f64(mode, seqlen):
    """seqlen 1 takes the temporal shortcut (the identity over v) in the
    temporal and series modes too."""
    x = np.random.RandomState(7).randn(8, 5, 64)
    jmod = JBlock(64, 2, st_mode=mode, dtype=jnp.float64)
    params = random_params(
        lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32), seqlen), 4)
    assert ("ts_attn" in params["attn"]) == (mode == "parallel")
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x: jmod.apply(p, x, seqlen))({"params": as_f64(params)}, x)
    tmod = TBlock(64, 2, st_mode=mode, dtype=torch.float64).double()
    tmod.load_state_dict(sub_state_dict(params, "encoder/blocks_0", "encoder.blocks.0."),
                         strict=True)
    got = tmod(to_torch(x), seqlen)
    assert got.shape == (8, 5, 64)
    assert_close(got, want, 1e-9)
    assert_close(tmod(to_torch(x), seqlen, plain=True), want, 1e-9)
    assert (tmod.attn.last_gate is not None) == (mode == "parallel")


def seeded(block, seed):
    """``block`` with every parameter drawn from ``seed`` (a module's norms
    start as uninitialised memory until weights are loaded)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype) * 0.3)
    return block


def test_coupling_of_single_frames_equals_spatial():
    """With T = 1 a clip's tokens are a frame's: the two modes are one function."""
    x = to_torch(np.random.RandomState(8).randn(3, 7, 32))
    blocks = {mode: TBlock(32, 2, st_mode=mode, dtype=torch.float64).double()
              for mode in ("spatial", "coupling")}
    blocks["coupling"].load_state_dict(seeded(blocks["spatial"], 8).state_dict(), strict=True)
    with torch.no_grad():
        assert_close(blocks["coupling"](x, 1), blocks["spatial"](x, 1), 1e-12)


def test_coupling_takes_the_blocked_plain_version_beyond_1024_tokens(monkeypatch):
    """T * N = 6 * 180 = 1080 tokens: the wrapper (CPU) and ``plain=True`` both
    run ``attention_blocked_reference``, and the result is the attention of the
    short-sequence formula in f64."""
    calls = []
    reference = TA.attention_blocked_reference

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return reference(*args, **kw)

    monkeypatch.setattr(TA, "attention_blocked_reference", counted)
    monkeypatch.setattr("maed_tpu_torch.models.vit.attention_blocked_reference", counted)
    rng = np.random.RandomState(9)
    block = seeded(TBlock(16, 2, st_mode="coupling", dtype=torch.float64).double(), 9)
    x = to_torch(rng.randn(6, 180, 16))
    with torch.no_grad():
        got, plain = block(x, 6), block(x, 6, plain=True)
        qkv = block.attn._qkv(x, block.norm1, True)
        q, k, v = (a.transpose(1, 2) for a in qkv.view(1, 1080, 3, 2, 8).unbind(2))
        y = TA._xla_attention(q, k, v, 8 ** -0.5).transpose(1, 2).reshape(6, 180, 16)
        want = block.mlp(x + torch.nn.functional.linear(y, block.attn.proj.weight,
                                                         block.attn.proj.bias), block.norm2)
    assert calls == [(1, 2, 1080, 8)] * 2
    assert_close(got, plain, 0.0)
    assert_close(got, want, 1e-12)


# ------------------------------------------------------------ the whole MAED

def jax_maed(mode, dtype=jnp.float32):
    return JMAED(encoder="ste", st_mode=mode, decoder="ktd", dtype=dtype, **CONFIG)


def jax_params(mode):
    x = np.zeros(SHAPE, np.float32)
    smpl = j_synthetic_smpl(64, 0)
    return random_params(lambda: jax_maed(mode).init(jax.random.PRNGKey(0), x, smpl), 3)


def jax_forward(mode, params, clips, dtype):
    model, smpl = jax_maed(mode, dtype), j_synthetic_smpl(64, 0)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda p, x: model.apply({"params": p}, x, smpl))(params, clips)
    return jax.tree.map(np.asarray, out)


def assert_outputs_close(got, want, atol, rtol=0.0):
    assert set(got) == set(want) == set(OUTPUTS)
    for key in OUTPUTS:
        assert tuple(got[key].shape) == want[key].shape, key
        assert_close(got[key], want[key], atol, rtol, what=key)


F64_CLIPS = np.random.RandomState(1).randn(*SHAPE)


@pytest.fixture(scope="module")
def jax_f64():
    """{mode: (its parameters, JAX's f64 outputs on F64_CLIPS)} for every
    mode, traced and compiled in a thread a mode (XLA compiles them side by
    side)."""
    def one(mode):
        params = jax_params(mode)
        with jax.enable_x64(True):  # the flag is the thread's own
            return params, jax_forward(mode, as_f64(params), F64_CLIPS, jnp.float64)

    with ThreadPoolExecutor(len(ST_MODES)) as pool:
        return dict(zip(ST_MODES, pool.map(one, ST_MODES)))


@pytest.mark.parametrize("mode", ST_MODES)
def test_maed_matches_jax_f64(jax_f64, mode):
    params, want = jax_f64[mode]
    sd = state_dict_from_jax(params)
    assert ("encoder.temp_embed" in sd) == (mode in TEMP_EMBED_MODES)
    assert ("encoder.blocks.0.attn.ts_attn.weight" in sd) == (mode == "parallel")
    clips = F64_CLIPS
    model = MAED(img_size=32, st_mode=mode, dtype=torch.float64, **CONFIG)
    model.load_state_dict(sd, strict=True)
    got = model.double()(to_torch(clips), t_synthetic_smpl(64, 0, device="cpu"))
    assert_outputs_close(got, want, 1e-8)


def test_coupling_maed_matches_jax_through_its_pallas_attention(jax_f64, monkeypatch):
    monkeypatch.setenv("MAED_FUSED_ATTENTION", "1")
    params = jax_f64["coupling"][0]
    clips = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    want = jax_forward("coupling", params, clips, jnp.float32)
    model = MAED(img_size=32, st_mode="coupling", dtype=torch.float32, **CONFIG)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    smpl = t_synthetic_smpl(64, 0, device="cpu")
    assert_outputs_close(model(to_torch(clips), smpl), want, 1e-3, 1e-3)


@pytest.mark.parametrize("mode", ST_MODES)
def test_build_eval_model_builds_every_mode(mode, tmp_path):
    """Seeded weights and the one-time bf16 cast must not assume ``temp_embed``
    or ``ts_attn``; the biases a kernel takes in f32 stay f32 per mode."""
    model, smpl = build_eval_model(img_size=32, st_mode=mode, dtype=torch.bfloat16, device="cpu",
                                   seed=0, allow_synthetic_smpl=True, smpl_dir=str(tmp_path),
                                   **CONFIG)
    names = dict(model.named_parameters())
    assert ("encoder.temp_embed" in names) == (mode in TEMP_EMBED_MODES)
    assert ("encoder.blocks.0.attn.ts_attn.bias" in names) == (mode == "parallel")
    f32 = {name for name, p in names.items()
           if p.dtype == torch.float32 and ".norm" not in name and "mlp.fc" not in name}
    want = set()
    if mode != "temporal":
        want.add("encoder.blocks.0.attn.qkv.bias")
    if mode == "parallel":
        want |= {"encoder.blocks.0.attn.ts_attn.bias", "encoder.blocks.0.attn.proj.bias"}
    assert f32 == want
    clips = torch.from_numpy(np.random.RandomState(3).randint(0, 256, SHAPE).astype(np.uint8))
    out = model(clips, smpl, J_regressor=torch.full((14, 6890), 1 / 6890))
    assert out["kp_3d"].shape == (2, 2, 14, 3)
    assert all(torch.isfinite(out[k]).all() for k in OUTPUTS)
