"""maed_tpu_torch's model pieces held against maed_tpu's flax modules on the
CPU, in f64 (JAX under ``jax.enable_x64(True)``, the port in torch.float64)
at atol 1e-9: StdConv at even and odd sizes (TF SAME padding), the SAME
max-pool, GroupNorm, the bottleneck, a parallel-attention block (with the
seqlen == 1 shortcut) and KTD. Parameters are carried across through the
reference-named state_dict, as for the whole model, and are f64 on both
sides (the stem standardizes its weights in their own dtype); the f32
weight folding is compared in f32.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.models import resnetv2 as JR
from maed_tpu.models.ktd import KTD as JKTD
from maed_tpu.models.vit import Block as JBlock
from maed_tpu.utils.checkpoint import fold_weight_standardization as j_fold
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu.utils.torch_convert import convert_params_to_state_dict
from maed_tpu_torch.models import resnetv2 as TR
from maed_tpu_torch.models.ktd import KTD as TKTD
from maed_tpu_torch.models.vit import Block as TBlock
from maed_tpu_torch.utils.checkpoint import fold_weight_standardization as t_fold
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from torch_port_common import assert_close, one_torch_thread, to_torch  # noqa: F401

ATOL64 = 1e-9


def random_params(init_fn, seed):
    """Numpy f32 parameters with the shapes ``init_fn()`` would give, drawn
    from ``seed`` at the scale of each kind of leaf (traced, not compiled)."""
    shapes = jax.eval_shape(init_fn)["params"]
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if "scale" in name:
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if len(shape) <= 1 or "embed" in name or "cls_token" in name:
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def as_f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def sub_state_dict(params, flax_path, torch_prefix, dtype=torch.float64):
    """The port's state_dict of one submodule: its flax parameters placed at
    their path in the full MAED tree, converted by the JAX package's own
    converter, and the torch prefix taken off again."""
    tree = params
    for part in reversed(flax_path.split("/")):
        tree = {part: tree}
    sd = convert_params_to_state_dict(tree)
    assert all(k.startswith(torch_prefix) for k in sd), list(sd)
    return {k[len(torch_prefix):]: to_torch(v, dtype) for k, v in sd.items()}


def nchw(a):
    return to_torch(np.transpose(a, (0, 3, 1, 2)))


def from_nchw(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("kernel, stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_stdconv_matches_jax_f64(size, kernel, stride):
    """Odd sizes and strides exercise the asymmetric TF SAME padding."""
    rng = np.random.RandomState(size + kernel)
    x = rng.randn(2, size, size, 8)
    jmod = JR.StdConv(16, (kernel, kernel), (stride, stride), dtype=jnp.float64)
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32)), 1)
    with jax.enable_x64(True):
        want = jax.jit(jmod.apply)({"params": as_f64(params)}, x)
    tmod = TR.StdConv(8, 16, kernel, stride, dtype=torch.float64)
    tmod.weight.data = to_torch(np.transpose(params["kernel"], (3, 2, 0, 1)), torch.float64)
    got = from_nchw(tmod(nchw(x)))
    assert got.shape == want.shape
    assert_close(got, want, ATOL64)


@pytest.mark.parametrize("size", [32, 33, 7])
def test_max_pool_same_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size, 4)
    with jax.enable_x64(True):
        want = JR.max_pool_same(jnp.asarray(x), 3, 2)
    got = from_nchw(TR.max_pool_same(nchw(x)))
    assert got.shape == want.shape
    assert_close(got, want, 0.0)


@pytest.mark.parametrize("apply_act", [True, False])
def test_groupnorm_matches_jax_f64(apply_act):
    x = np.random.RandomState(5).randn(2, 9, 9, 64) * 3 + 1
    jmod = JR.GroupNormAct(apply_act=apply_act, dtype=jnp.float64)
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32)), 2)
    with jax.enable_x64(True):
        want = jax.jit(jmod.apply)({"params": as_f64(params)}, x)
    tmod = TR.GroupNormAct(64, apply_act=apply_act, dtype=torch.float64)
    tmod.weight.data = to_torch(params["GroupNorm_0"]["scale"], torch.float64)
    tmod.bias.data = to_torch(params["GroupNorm_0"]["bias"], torch.float64)
    assert_close(from_nchw(tmod(nchw(x))), want, ATOL64)


def test_bottleneck_matches_jax_f64():
    """The first block of a stride-2 stage: downsample branch, odd input."""
    x = np.random.RandomState(6).randn(2, 17, 17, 64)
    jmod = JR.Bottleneck(out_chs=256, stride=2, has_downsample=True, dtype=jnp.float64)
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32)), 3)
    with jax.enable_x64(True):
        want = jax.jit(jmod.apply)({"params": as_f64(params)}, x)
    tmod = TR.Bottleneck(64, 256, stride=2, has_downsample=True, dtype=torch.float64).double()
    tmod.load_state_dict(sub_state_dict(params, "encoder/patch_embed/backbone/stage1/block0",
                                        "encoder.patch_embed.backbone.stages.1.blocks.0."),
                         strict=True)
    got = from_nchw(tmod(nchw(x)))
    assert got.shape == want.shape == (2, 9, 9, 256)
    assert_close(got, want, ATOL64)


def unfused_bottleneck(block, x):
    """relu(norm3(y) + shortcut) as separate ops: the JAX model's order, and
    the port's before the sum and the ReLU went into norm3's kernel."""
    shortcut = x if block.downsample is None else block.downsample(x)
    y = block.norm1(block.conv1(x))
    y = block.norm2(block.conv2(y))
    return torch.relu(block.norm3(block.conv3(y)) + shortcut)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2])
def test_bottleneck_residual_fused_into_norm3_is_exact(dtype, depth):
    """A Bottleneck (depth 1) and a 2-block ResNetStage, whose norm3 takes
    the shortcut as its residual and the ReLU after it, equal the unfused
    relu(norm3(y) + shortcut) bit for bit: both round norm3's output and
    then the sum to the dtype."""
    torch.manual_seed(depth)
    stage = TR.ResNetStage(64, 128, depth, 2, dtype=dtype).to(
        torch.float64 if dtype == torch.float64 else torch.float32)
    for p in stage.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    x = torch.randn(2, 64, 11, 11, dtype=torch.float64).to(dtype)
    want = x
    for block in stage.blocks:
        want = unfused_bottleneck(block, want)
    got = stage.blocks[0](x) if depth == 1 else stage(x)
    assert got.dtype == dtype and got.shape == (2, 128, 6, 6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seqlen", [1, 2])
def test_block_matches_jax_f64(seqlen):
    """A parallel-attention block; seqlen 1 takes the temporal shortcut."""
    x = np.random.RandomState(7).randn(4, 5, 64)
    jmod = JBlock(64, 2, st_mode="parallel", dtype=jnp.float64)
    params = random_params(
        lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32), seqlen), 4)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x: jmod.apply(p, x, seqlen))({"params": as_f64(params)}, x)
    tmod = TBlock(64, 2, dtype=torch.float64).double()
    tmod.load_state_dict(sub_state_dict(params, "encoder/blocks_0", "encoder.blocks.0."),
                         strict=True)
    assert_close(tmod(to_torch(x), seqlen), want, ATOL64)


def test_ktd_matches_jax_f64():
    x = np.random.RandomState(8).randn(4, 48)
    jreg = np.random.RandomState(9).rand(14, 64) / 32
    j_smpl, t_smpl = j_synthetic_smpl(64, 0), t_synthetic_smpl(64, 0, device="cpu")
    jmod = JKTD(hidden_dim=32, dtype=jnp.float64)
    params = random_params(
        lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32), j_smpl), 5)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x: jmod.apply(p, x, j_smpl, J_regressor=jreg))(
            {"params": as_f64(params)}, x)
    tmod = TKTD(feat_dim=48, hidden_dim=32, dtype=torch.float64).double()
    tmod.load_state_dict(sub_state_dict(params, "decoder", "decoder."), strict=True)
    got = tmod(to_torch(x), t_smpl, J_regressor=to_torch(jreg))
    assert set(got) == set(want)
    for key in want:
        assert_close(got[key], want[key], ATOL64, what=key)


def test_fold_weight_standardization_matches_jax():
    """Both fold in f32, summing in different orders: they agree to a few
    f32 ulps of the standardized weights (magnitudes up to ~4)."""
    x = np.zeros((1, 33, 33, 64), np.float32)
    jmod = JR.Bottleneck(out_chs=256, stride=2, has_downsample=True)
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), x), 10)
    flax_path, prefix = ("encoder/patch_embed/backbone/stage1/block0",
                         "encoder.patch_embed.backbone.stages.1.blocks.0.")
    tree = {"encoder": {"patch_embed": {"backbone": {"stage1": {"block0": params}}}}}
    want = sub_state_dict(j_fold(tree)["encoder"]["patch_embed"]["backbone"]["stage1"]["block0"],
                          flax_path, prefix, torch.float32)
    got = t_fold({prefix + k: v for k, v in
                  sub_state_dict(params, flax_path, prefix, torch.float32).items()})
    assert sorted(k[len(prefix):] for k in got) == sorted(want)
    for key, value in want.items():
        assert got[prefix + key].dtype == torch.float32
        assert_close(got[prefix + key], value, 2e-6, what=key)
        if value.ndim == 1:  # GroupNorm parameters are not folded
            assert torch.equal(got[prefix + key], value)
