"""The whole slice: maed_tpu_torch's MAED eval forward against maed_tpu's on
the CPU, at the tiny config of tests/test_golden.py (1 block, 2 heads, KTD
hidden 32, 32 px, 2 frames, a 64-vertex synthetic SMPL), with the JAX
parameters carried across (``load_state_dict(strict=True)``), on all five
outputs: theta, verts, kp_2d, kp_3d and rotmat.

f64 (JAX under ``jax.enable_x64(True)``, parameters f64 on both sides) at
atol 1e-8; f32 at atol 1e-4, rtol 1e-3, with JAX at
``jax.default_matmul_precision("highest")`` (its f32 dots default to a
lower precision on this CPU). Each once with float clips and the in-graph
weight standardization, once with uint8 clips, the standardization folded
and a J14 regressor (the eval path).

uint8 clips: the JAX model gets them normalized by JAX's device_normalize
run op by op. Under jit, XLA fuses its two f32 divisions into multiplies
by reciprocals and an FMA, which rounds some normalized pixels one f32 ulp
away (~1e-5 at theta in f64); op by op, JAX's normalization and the port's
agree bit for bit (test_torch_port_ops::test_device_normalize_matches_jax),
and the port still takes the raw uint8 clips.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.models import MAED as JMAED
from maed_tpu.ops.image import device_normalize as j_device_normalize
from maed_tpu.utils.checkpoint import fold_weight_standardization as j_fold
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu.utils.torch_convert import convert_params_to_state_dict as j_convert
from maed_tpu_torch.core.builder import build_eval_model
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.utils.checkpoint import fold_weight_standardization as t_fold
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import random_params
from torch_port_common import assert_close, to_torch

CONFIG = dict(num_blocks=1, num_heads=2, hidden_dim=32)
SHAPE = (1, 2, 32, 32, 3)
DTYPES = {"f64": (jnp.float64, torch.float64, np.float64, 1e-8, 0.0),
          "f32": (jnp.float32, torch.float32, np.float32, 1e-4, 1e-3)}
OUTPUTS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")


def jax_maed(dtype=jnp.float32, standardize_ws=True):
    return JMAED(encoder="ste", st_mode="parallel", decoder="ktd",
                 standardize_ws=standardize_ws, dtype=dtype, **CONFIG)


def jax_forward(params, clips, smpl, jreg, dtype, standardize_ws):
    model = jax_maed(dtype, standardize_ws)
    clips = np.asarray(j_device_normalize(jnp.asarray(clips)))  # see the module doc
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda p, x: model.apply({"params": p}, x, smpl, J_regressor=jreg))(
            params, clips)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def params():
    x = np.zeros(SHAPE, np.float32)
    smpl = j_synthetic_smpl(64, 0)
    return random_params(lambda: jax_maed().init(jax.random.PRNGKey(0), x, smpl), 0)


def assert_outputs_close(got, want, atol, rtol):
    assert set(got) == set(want) == set(OUTPUTS)
    for key in OUTPUTS:
        assert tuple(got[key].shape) == want[key].shape, key
        assert_close(got[key], want[key], atol, rtol, what=key)


def test_weight_mapping_equals_the_jax_packages(params):
    """utils.weights keeps its own copy of the flax -> torch key mapping (the
    port imports nothing of maed_tpu): key for key and value for value it is
    maed_tpu.utils.torch_convert's."""
    want = j_convert(params)
    got = state_dict_from_jax(params)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_state_dict_has_the_reference_names(params):
    sd = state_dict_from_jax(params)
    assert len(sd) == 235
    assert "encoder.blocks.0.attn.ts_attn.weight" in sd
    assert "encoder.patch_embed.backbone.stages.0.blocks.0.conv1.weight" in sd
    MAED(img_size=32, **CONFIG).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("variant", ["float_clips", "uint8_folded"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_slice_matches_jax(params, dtype, variant):
    jdt, tdt, ndt, atol, rtol = DTYPES[dtype]
    rng = np.random.RandomState(1)
    folded = variant == "uint8_folded"
    if folded:
        clips = rng.randint(0, 256, SHAPE).astype(np.uint8)
        jreg = rng.rand(14, 64)
        jreg = (jreg / jreg.sum(axis=1, keepdims=True)).astype(ndt)
        j_params = j_fold(params)
        # f32: each side folds with its own function. f64: both get JAX's
        # folded weights, since the two f32 folds differ by f32 ulps
        # (test_torch_port_models compares the folds themselves).
        sd = (t_fold(state_dict_from_jax(params)) if dtype == "f32"
              else state_dict_from_jax(jax.tree.map(np.asarray, j_params)))
    else:
        clips = rng.randn(*SHAPE).astype(ndt)
        jreg, j_params, sd = None, params, state_dict_from_jax(params)

    with jax.enable_x64(dtype == "f64"):
        want = jax_forward(jax.tree.map(lambda a: np.asarray(a, ndt), j_params), clips,
                           j_synthetic_smpl(64, 0), jreg, jdt, not folded)

    model = MAED(img_size=32, standardize_ws=not folded, dtype=tdt, **CONFIG)
    model.load_state_dict(sd, strict=True)
    got = model.to(tdt)(to_torch(clips), t_synthetic_smpl(64, 0, device="cpu"),
                        J_regressor=None if jreg is None else to_torch(jreg))
    assert got["theta"].dtype == tdt
    assert_outputs_close(got, want, atol, rtol)


def test_slice_matches_jax_through_its_pallas_kernels(params, monkeypatch):
    """The JAX model with every fused path of this slice switched on
    (GroupNorm, LN + qkv, the temporal head-pair kernel, one-shot spatial
    attention, gate + proj, LN + MLP) and its Pallas kernels in interpret mode, against
    the port, in f32. atol 1e-4, rtol 1e-3 as the plain f32 case: the
    kernels keep f32 moments and scores and sum in other orders."""
    from maed_tpu.ops import groupnorm, mlp, st_attention

    for name in ("MAED_FUSED_GN", "MAED_TEMPORAL_V2", "MAED_FUSED_ATTENTION", "MAED_FUSED_QKV",
                 "MAED_FUSED_GATE"):
        monkeypatch.setenv(name, "1")
    for mod in (groupnorm, mlp, st_attention):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    assert groupnorm.use_fused_groupnorm() and st_attention.use_temporal_v2()
    assert mlp.use_fused_gate()
    clips = np.random.RandomState(5).randn(*SHAPE).astype(np.float32)
    want = jax_forward(params, clips, j_synthetic_smpl(64, 0), None, jnp.float32, True)
    model = MAED(img_size=32, dtype=torch.float32, **CONFIG)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    got = model(to_torch(clips), t_synthetic_smpl(64, 0, device="cpu"))
    assert_outputs_close(got, want, 1e-4, 1e-3)


def test_build_eval_model_matches_jax(params, tmp_path, capsys):
    """The port's entry point with the JAX weights: strict load, folding,
    the loud fallback to the synthetic 6890-vertex body, uint8 clips and a
    J14 regressor, against the JAX model on the same (folded) weights and
    body, in f32."""
    model, smpl = build_eval_model(img_size=32, dtype=torch.float32, device="cpu",
                                   state_dict=state_dict_from_jax(params),
                                   allow_synthetic_smpl=True, smpl_dir=str(tmp_path), **CONFIG)
    assert "SYNTHETIC" in capsys.readouterr().err
    rng = np.random.RandomState(2)
    clips = rng.randint(0, 256, SHAPE).astype(np.uint8)
    jreg = rng.rand(14, 6890).astype(np.float32)
    jreg /= jreg.sum(axis=1, keepdims=True)
    want = jax_forward(j_fold(params), clips, j_synthetic_smpl(6890), jreg, jnp.float32,
                       standardize_ws=False)
    got = model(to_torch(clips), smpl, J_regressor=to_torch(jreg))
    assert_outputs_close(got, want, 1e-4, 1e-3)


def test_build_eval_model_casts_weights_once(tmp_path):
    """In bf16 the builder casts the weights used in bf16 once; the outputs
    are bit for bit those of the model that casts them at every use."""
    kw = dict(img_size=32, device="cpu", seed=0, allow_synthetic_smpl=True,
              smpl_dir=str(tmp_path), **CONFIG)
    model, smpl = build_eval_model(dtype=torch.bfloat16, **kw)
    f32_model, _ = build_eval_model(dtype=torch.float32, **kw)
    per_use = MAED(img_size=32, standardize_ws=False, dtype=torch.bfloat16, **CONFIG)
    per_use.load_state_dict(f32_model.state_dict(), strict=True)
    assert all(p.dtype == torch.float32 for p in per_use.parameters())

    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    f32 = {name for name, dt in dtypes.items() if dt == torch.float32}
    assert f32 == {name for name in dtypes
                   if ".norm" in name
                   or name.endswith(("mlp.fc1.bias", "mlp.fc2.bias", "attn.qkv.bias",
                                     "attn.ts_attn.bias", "attn.proj.bias"))}
    assert all(dt == torch.bfloat16 for name, dt in dtypes.items() if name not in f32)

    clips = torch.from_numpy(np.random.RandomState(4).randint(0, 256, SHAPE).astype(np.uint8))
    jreg = torch.full((14, 6890), 1 / 6890)
    got = model(clips, smpl, J_regressor=jreg)
    want = per_use(clips, smpl, J_regressor=jreg)
    for key in OUTPUTS:
        assert torch.equal(got[key], want[key]), key


def test_build_eval_model_random_weights_follow_the_seed(tmp_path):
    def build(seed):
        return build_eval_model(img_size=32, dtype=torch.float32, device="cpu", seed=seed,
                                allow_synthetic_smpl=True, smpl_dir=str(tmp_path), **CONFIG)

    (a, smpl), (b, _), (c, _) = build(0), build(0), build(1)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    clips = torch.from_numpy(np.random.RandomState(3).randint(0, 256, SHAPE).astype(np.uint8))
    out = a(clips, smpl)
    assert all(torch.isfinite(out[k]).all() for k in OUTPUTS)
