"""The rest of the model surface against the JAX package on the CPU: the stock
ViTs (``PatchEmbed``, a qkv without bias, no pre-logits, MLP ratio 3) in
every ``st_mode``, the pre-activation ResNetV2, ``MAED.extract_feature`` of
both encoders, the factory catalog, the strict loads of a bare ViT's and a
bare ResNetV2's flax trees, and the plan of E's f32 gate product
(``csrc/f32_layout.cuh``, compiled with the host's C++ compiler).

f64 (JAX under ``jax.enable_x64(True)``, the port in torch.float64) at atol
1e-9 for the modules and 1e-8 for the MAED features, as
tests/test_torch_port_models.py and tests/test_torch_port_modes.py hold
theirs. The JAX parameters are traced (``jax.eval_shape``), drawn with numpy
and passed to each jit as arguments; the JAX outputs are computed once a
module. Few items (xdist queues a file by its count of items): the modes
are looped inside one test.
"""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.models import MAED as JMAED
from maed_tpu.models import maed as j_maed_module
from maed_tpu.models import vit as j_vit
from maed_tpu.models.resnet import ResNet50 as JResNet50
from maed_tpu.models.resnetv2 import ResNetV2 as JResNetV2
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch import kernels as TK
from maed_tpu_torch.core.builder import build_encoder
from maed_tpu_torch.models import vit as t_vit
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.resnetv2 import ResNetV2
from maed_tpu_torch.models.vit import ST_MODES, VisionTransformer
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import as_f64, random_params
from torch_port_common import narrow_models, NARROW_STEM_LAYERS, NARROW_RESNET
from torch_port_common import assert_close, one_torch_thread, to_torch  # noqa: F401

# a stock ViT cut to size: 64 px frames of 4 x 4 patches of 16, width 64
STOCK = dict(embed_dim=64, depth=1, num_heads=2, mlp_ratio=3.0, qkv_bias=False, hybrid=False,
             patch_size=16, representation_size=None)
FRAMES, SEQLEN, IMG = 4, 2, 64
# the pre-activation ResNetV2 cut to size (mid widths of 32: GroupNorm(32))
PREACT = dict(layers=(1, 2), channels=(128, 256), stem_chs=32, preact=True)
CLIPS = (2, 2, 32, 32, 3)


def stock_vit_case(mode):
    """The stock ViT of ``mode``: its flax module and f64 parameters."""
    jmod = j_vit.VisionTransformer(st_mode=mode, dtype=jnp.float64, **STOCK)
    x = np.zeros((FRAMES, IMG, IMG, 3), np.float32)
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), x, SEQLEN), 20)
    return jmod, as_f64(params)


def random_stats(init_fn, seed):
    """A batch_stats tree of the shapes ``init_fn()`` gives: means about 0,
    variances in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: (0.1 * rng.randn(*s.shape) if "mean" in jax.tree_util.keystr(path)
                         else 0.5 + rng.rand(*s.shape)), jax.eval_shape(init_fn)["batch_stats"])


@pytest.fixture(scope="module")
def jax_answers():
    """JAX's outputs, once a module: the stock ViT in each mode, the
    pre-activation ResNetV2 and both MAEDs' features, with the parameters
    that made them."""
    rng = np.random.RandomState(21)
    frames = rng.randn(FRAMES, IMG, IMG, 3)
    images = rng.randn(2, 32, 32, 3)
    clips = rng.randn(*CLIPS)
    out = {"frames": frames, "images": images, "clips": clips, "vit": {}}
    with jax.enable_x64(True):
        for mode in ST_MODES:
            jmod, params = stock_vit_case(mode)
            fwd = jax.jit(lambda p, x, m=jmod: m.apply({"params": p}, x, SEQLEN))
            out["vit"][mode] = (params, np.asarray(fwd(params, frames)))
        jres = JResNetV2(dtype=jnp.float64, **PREACT)
        params = as_f64(random_params(
            lambda: jres.init(jax.random.PRNGKey(0), images.astype(np.float32)), 22))
        out["resnetv2"] = (params, np.asarray(jax.jit(
            lambda p, x: jres.apply({"params": p}, x))(params, images)))
        with pytest.MonkeyPatch.context() as mp:  # flax builds submodules at each apply
            mp.setattr(j_vit, "ResNetV2",
                       lambda **kw: JResNetV2(**dict(kw, layers=NARROW_STEM_LAYERS)))
            mp.setattr(j_maed_module, "ResNet50", functools.partial(JResNet50, **NARROW_RESNET))
            for encoder in ("ste", "cnn"):
                model = JMAED(encoder=encoder, num_blocks=1, num_heads=2, hidden_dim=32,
                              dtype=jnp.float64)

                def init(model=model):  # the decoder's too: the port's MAED loads them
                    return model.init(jax.random.PRNGKey(0), clips.astype(np.float32),
                                      j_synthetic_smpl(64, 0))

                variables = {"params": as_f64(random_params(init, 23))}
                if encoder == "cnn":
                    variables["batch_stats"] = as_f64(random_stats(init, 24))
                feat = jax.jit(lambda v, x, m=model: m.apply(
                    v, x, method=JMAED.extract_feature))(variables, clips)
                out[encoder] = (variables, np.asarray(feat))
    return out


def test_factories_are_the_jax_catalog():
    """Every factory of the JAX package's catalog has a namesake in the port
    with the same hyperparameters (the flax fields), st_mode and the rest
    passed through; built on the meta device, none initialised."""
    names = [n for n in dir(j_vit) if n.startswith("vit_")]
    assert sorted(names) == sorted(t_vit.FACTORIES) and len(names) == 11
    fields = ("embed_dim", "depth", "num_heads", "mlp_ratio", "qkv_bias", "hybrid",
              "patch_size", "representation_size", "st_mode")
    for name in names:
        kw = dict(num_blocks=3, num_heads=4) if name.startswith("vit_custom") else {}
        jmod = getattr(j_vit, name)(st_mode="coupling", **kw)
        with torch.device("meta"):
            tmod = t_vit.FACTORIES[name](st_mode="coupling", dtype=torch.bfloat16, **kw)
        for field in fields:
            assert getattr(tmod, field) == getattr(jmod, field), (name, field)
        assert tmod.dtype == torch.bfloat16
        # pos_embed: the tokens of the factory's frame size, and the cls token
        side = tmod.img_size // tmod.patch_size if not tmod.hybrid else 14
        assert tmod.img_size == (384 if name.endswith("_384") else 224), name
        assert tmod.pos_embed.shape == (1, side * side + 1, tmod.embed_dim), name
    with torch.device("meta"):
        assert t_vit.vit_large_patch16_384().pos_embed.shape[1] == 577
        assert t_vit.vit_base_patch32_384().pos_embed.shape[1] == 145
        assert t_vit.vit_small_patch16_224().blocks[0].attn.qkv.bias is None


def test_stock_vit_matches_jax_f64(jax_answers):
    """Each st_mode of the stock ViT (64 px, patch 16, a qkv without bias,
    MLP ratio 3, the normed cls token out), its flax tree loaded strictly:
    through the wrappers (their plain versions on the CPU) and plain=True."""
    frames = to_torch(jax_answers["frames"])
    for mode in ST_MODES:
        params, want = jax_answers["vit"][mode]
        model = VisionTransformer(st_mode=mode, img_size=IMG, dtype=torch.float64,
                                  **STOCK).double()
        model.load_state_dict(state_dict_from_jax(params, root="vit"), strict=True)
        assert "blocks.0.attn.qkv.bias" not in model.state_dict()
        got = model(frames, SEQLEN)
        assert got.shape == (FRAMES, STOCK["embed_dim"]), mode
        assert_close(got, want, 1e-9, what=mode)
        assert_close(model(frames, SEQLEN, plain=True), want, 1e-9, what=mode)


def test_preact_resnetv2_matches_jax_f64(jax_answers):
    """The pre-activation ResNetV2 (no stem norm, norm1 + ReLU before conv1
    and the downsample, y + shortcut after conv3, a final norm), its flax
    tree loaded strictly, in NCHW."""
    params, want = jax_answers["resnetv2"]
    model = ResNetV2(dtype=torch.float64, **PREACT).double()
    model.load_state_dict(state_dict_from_jax(params, root="resnetv2"), strict=True)
    assert "norm.weight" in model.state_dict() and "stem.norm.weight" not in model.state_dict()
    got = model(to_torch(jax_answers["images"]).permute(0, 3, 1, 2))
    assert_close(got.permute(0, 2, 3, 1), want, 1e-9)


@pytest.mark.parametrize("encoder", ["ste", "cnn"])
def test_extract_feature_matches_jax_f64(jax_answers, monkeypatch, encoder):
    """``MAED.extract_feature`` of both encoders (the narrow stems of
    tests/torch_port_common.py on both sides): (N, T, 768) from the ViT,
    (N, T, 128) from the narrow ResNet-50 on its running statistics."""
    variables, want = jax_answers[encoder]
    narrow_models(monkeypatch)
    model = MAED(encoder=encoder, num_blocks=1, num_heads=2, hidden_dim=32, img_size=32,
                 dtype=torch.float64).double()
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats")), strict=True)
    got = model.extract_feature(to_torch(jax_answers["clips"]))
    assert got.shape == want.shape == CLIPS[:2] + (768 if encoder == "ste" else 128,)
    assert_close(got, want, 1e-8)


def test_bare_trees_load_strictly(monkeypatch):
    """The flax trees of a bare hybrid ViT (with pre-logits; the narrow stem
    on both sides) and of a 4-stage pre-activation ResNetV2 load with
    strict=True, every value at its key: nothing missing, nothing left
    over."""
    narrow_models(monkeypatch)
    monkeypatch.setattr(j_vit, "ResNetV2",
                        lambda **kw: JResNetV2(**dict(kw, layers=NARROW_STEM_LAYERS)))
    hybrid = j_vit.VisionTransformer(embed_dim=32, depth=1, num_heads=2)
    params = random_params(lambda: hybrid.init(jax.random.PRNGKey(0),
                                               np.zeros((2, 32, 32, 3), np.float32), 2), 25)
    with torch.device("meta"):
        model = VisionTransformer(embed_dim=32, depth=1, num_heads=2, img_size=32)
    sd = state_dict_from_jax(params, root="vit")
    model.load_state_dict(sd, strict=True, assign=True)
    np.testing.assert_array_equal(model.pre_logits.fc.weight.detach().numpy(),
                                  np.asarray(params["pre_logits"]["kernel"]).T)
    resnet = JResNetV2(layers=(1, 1, 1, 1), channels=(128, 128, 128, 128), stem_chs=32,
                       preact=True)
    params = random_params(lambda: resnet.init(jax.random.PRNGKey(0),
                                               np.zeros((1, 32, 32, 3), np.float32)), 26)
    model = build_encoder(functools.partial(ResNetV2, layers=(1, 1, 1, 1),
                                            channels=(128, 128, 128, 128), stem_chs=32,
                                            preact=True),
                          dtype=torch.float32, device="cpu",
                          state_dict=state_dict_from_jax(params, root="resnetv2"))
    assert len(model.stages) == 4
    np.testing.assert_array_equal(model.norm.weight.detach().numpy(),
                                  params["norm"]["GroupNorm_0"]["scale"])
    with pytest.raises(ValueError, match="root"):
        state_dict_from_jax(params, root="resnet")


class GatePlan(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in ("tm", "tiles_m", "tiles_n", "splits", "steps",
                                                  "rows", "bytes")]


def test_f32_gate_plan_and_thread_map(tmp_path):
    """E's f32 gate product (``f32_layout.cuh``, compiled for the host): at
    each frame tile (32, 64, 128) the threads' frames and pairs cover the
    tile once, w_ts' rows of a tile are laid out once each, and two CTAs fit
    an SM; every plan over BT 1-300 and C 1-1536 (on 132 SMs, 16 and 1, and
    with the splits capped lower) takes the narrowest tile that holds BT,
    1 to the cap of splits, each at least one k-step, that cover the k-steps
    and whose reductions cover the tile's rows. The flagship's: 128-frame
    tiles, 32 of them, 8 splits."""
    shim = tmp_path / "shim.cpp"
    shim.write_text(
        '#include "f32_layout.cuh"\n'
        'using namespace maed_f32;\n'
        'extern "C" GatePlan plan(int BT, int K, int sms, int cap) {\n'
        '  return gate_f32_plan(BT, K, sms, cap);\n}\n'
        'extern "C" int row_of(int tm, int w, int l, int i) { return gate_row(tm, w, l, i); }\n'
        'extern "C" int pair_of(int l, int j) { return gate_pair(l, j); }\n'
        'extern "C" int w_row(int n) { return gate_w_row(n); }\n'
        'extern "C" int bm(int tm) { return gate_bm(tm); }\n'
        'extern "C" int consts() { return (kGaThreads * 1000 + kGaBN) * 100 + kGaBK; }\n')
    lib = tmp_path / "gate.so"
    subprocess.run([shutil.which("c++") or "g++", "-std=c++17", "-shared", "-fPIC",
                    "-I", str(TK.CSRC_DIR), str(shim), "-o", str(lib)], check=True)
    lib = ctypes.CDLL(str(lib))
    lib.plan.restype = GatePlan
    assert lib.consts() == (256 * 1000 + 48) * 100 + 32
    for tm in (1, 2, 4):
        covered = np.zeros((lib.bm(tm), 24), int)
        for w in range(8):
            for lane in range(32):
                for i in range(tm):
                    for j in range(3):
                        covered[lib.row_of(tm, w, lane, i), lib.pair_of(lane, j)] += 1
        assert lib.bm(tm) == 32 * tm and (covered == 1).all(), tm
    assert sorted(lib.w_row(n) for n in range(48)) == list(range(48))
    assert [lib.w_row(2 * p) + 24 for p in range(24)] == [lib.w_row(2 * p + 1) for p in range(24)]
    p = lib.plan(128, 1536, 132, 8)
    assert (p.tm, p.tiles_m, p.tiles_n, p.splits, p.steps, p.rows) == (4, 1, 32, 8, 6, 16)
    assert 0 < 2 * (p.bytes + 1024) <= 233472
    for sms, cap in ((132, 8), (132, 5), (16, 8), (1, 8)):
        for BT in (1, 7, 32, 33, 64, 65, 128, 129, 300):
            for C in range(1, 1537, 7):
                K = 2 * C
                p = lib.plan(BT, K, sms, cap)
                k_steps = -(-K // 32)
                case = (sms, cap, BT, C, p.tm, p.tiles_m, p.tiles_n, p.splits, p.steps, p.rows)
                assert p.tm == (1 if BT <= 32 else 2 if BT <= 64 else 4), case
                assert p.tiles_m == -(-BT // (32 * p.tm)) and p.tiles_n == -(-K // 48), case
                assert 1 <= p.splits <= cap, case
                assert (p.splits - 1) * p.steps < k_steps <= p.splits * p.steps, case
                assert p.splits * p.rows >= 32 * p.tm > (p.splits - 1) * p.rows, case
                assert p.bytes == lib.plan(BT, K, 132, 8).bytes, case
    assert lib.plan(0, 16, 132, 8).splits == 0 and lib.plan(4, 15, 132, 8).splits == 0
