"""maed_tpu_torch's stage-1 model against maed_tpu's on the CPU: the
ResNet-50 'cnn' encoder with BatchNorm, the iterative decoder, the
cnn + ktd / cnn + iterative MAED, one stage-1 train step, the BatchNorm
buffers in the ``.pth.tar`` round trip and the published-backbone import.

Inputs are made with numpy from a seed and go through both sides in f64
(JAX under ``jax.enable_x64``), held at atol 1e-8 plus rtol 1e-8 unless a
test says otherwise. The ResNet is narrow: ``layers (1, 1, 1, 1)``,
``channels (16, 32, 64, 128)``, at 32 px; each side's MAED builds that
width through ``monkeypatch`` of the ``ResNet50`` its module imports
(nothing in either package changes). The decoders' dropout is 0 where a training forward is
compared (the two sides draw their masks from different generators). JAX
runs each function under one ``jax.jit`` with the parameters as
arguments.

A training forward must leave flax's running statistics: a tenth of the
way to the batch's mean and *biased* variance (``torch.nn.BatchNorm2d``
would store the unbiased one, n / (n - 1) larger); the ResNet and train
step tests compare ``batch_stats`` after it, and
``test_batchnorm_update_is_flaxs`` holds one layer to flax's own
``nn.BatchNorm`` on the (2, 3, 3, 4) input where the two variances differ
by 18/17.
"""

import functools
from pathlib import Path

import flax.linen as fnn
import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.core.loss import LossWeights as JLossWeights
from maed_tpu.models import MAED as JMAED
from maed_tpu.models import maed as j_maed_module
from maed_tpu.models.ktd import KTD as JKTD
from maed_tpu.models.resnet import BottleneckV1 as JBottleneck
from maed_tpu.models.resnet import ResNet50 as JResNet50
from maed_tpu.models.spin import IterativeRegressor as JIterative
from maed_tpu.models.spin import load_mean_params as j_load_mean_params
from maed_tpu.parallel import train_step as JS
from maed_tpu.utils.pretrained import apply_pretrained_backbone as j_apply_pretrained
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu.utils.torch_convert import convert_params_to_state_dict as j_convert
from maed_tpu_torch.core.builder import (build_eval_model, build_train_model, load_weights,
                                         model_config)
from maed_tpu_torch.core.config import update_cfg
from maed_tpu_torch.core.loss import LossWeights
from maed_tpu_torch.models import maed as t_maed_module
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.resnet import BatchNorm, Bottleneck, ResNet50
from maed_tpu_torch.models.spin import IterativeRegressor, load_mean_params
from maed_tpu_torch.parallel import train_step as TS
from maed_tpu_torch.utils import checkpoint as ckpt
from maed_tpu_torch.utils.pretrained import apply_pretrained_backbone
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import random_params
from torch_port_common import Ranks, assert_close, one_torch_thread, to_torch  # noqa: F401

ATOL = RTOL = 1e-8
LAYERS, CHANNELS = (1, 1, 1, 1), (16, 32, 64, 128)
RES, T, NV = 32, 2, 64
OUTPUTS = ("theta", "verts", "kp_2d", "kp_3d", "rotmat")


def random_stats(init_fn, seed):
    """A batch_stats tree of the shapes ``init_fn()`` gives: means about 0,
    variances in [0.5, 1.5)."""
    shapes = jax.eval_shape(init_fn)["batch_stats"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: (0.1 * rng.randn(*s.shape) if "mean" in jax.tree_util.keystr(path)
                         else 0.5 + rng.rand(*s.shape)), shapes)


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# where the tested submodule sits: its flax path, its torch prefix
AT_BLOCK, AT_ENCODER = ("encoder/layer1_0", "encoder.layer1.0."), ("encoder", "encoder.")


def port_state(params, stats, at):
    """The port's state_dict of the submodule ``at`` (flax path, torch
    prefix), made by the JAX package's own converter from its parameters
    and batch_stats placed at that path."""
    flax_path, prefix = at
    for part in reversed(flax_path.split("/")):
        params, stats = {part: params}, {part: stats}
    return {k[len(prefix):]: to_torch(v) for k, v in j_convert(params, stats).items()}


def assert_stats_close(model, want_stats, at):
    """Every running_mean / running_var of ``model``, the submodule ``at``
    (or a dict of them by its state_dict names), against a flax batch_stats
    tree."""
    want = port_state({}, f64(want_stats), at)
    got = {k: v for k, v in (model if isinstance(model, dict) else model.state_dict()).items()
           if "running" in k}
    assert set(got) == {k for k in want if "running" in k}
    for k, v in got.items():
        assert_close(v, want[k], ATOL, RTOL, what=k)


# --- BatchNorm, the bottleneck and the ResNet ---------------------------------

def test_batchnorm_update_is_flaxs():
    """One training forward of flax's nn.BatchNorm(momentum=0.9, eps=1e-5)
    and of the port's on the same (2, 3, 3, 4) input: the outputs, and the
    running statistics 0.9 * init + 0.1 * the batch's mean and biased
    variance (18 values a channel: the unbiased one is 18/17 of it)."""
    x = np.random.RandomState(0).randn(2, 3, 3, 4) * 2 + 1
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                        dtype=jnp.float64, param_dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = f64(mod.init(jax.random.PRNGKey(0), x))  # flax's statistics start f32
        want, upd = mod.apply(variables, x, mutable=["batch_stats"])
    stats = upd["batch_stats"]
    np.testing.assert_allclose(stats["var"], 0.9 + 0.1 * x.var(axis=(0, 1, 2)), rtol=1e-12)
    bn = BatchNorm(4).double()
    bn.reset_()
    got = bn(to_torch(x).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
    assert_close(got, want, ATOL, RTOL)
    assert_close(bn.running_mean, stats["mean"], 1e-12, 1e-12)
    assert_close(bn.running_var, stats["var"], 1e-12, 1e-12)
    assert int(bn.num_batches_tracked) == 1
    # eval mode normalizes by the running statistics and leaves them
    before = bn.running_var.clone()
    with jax.enable_x64(True):
        want_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                                  dtype=jnp.float64, param_dtype=jnp.float64).apply(
            {"params": variables["params"], "batch_stats": stats}, x)
    got_eval = bn(to_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(got_eval, want_eval, ATOL, RTOL)
    assert torch.equal(bn.running_var, before) and int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("downsample", [False, True], ids=["identity", "downsample"])
def test_bottleneck_matches_jax(downsample, train):
    """BottleneckV1 (stride 2 with the downsample, 1 without), its output
    and, in training, its new running statistics."""
    in_chs, out_chs, stride = (16, 32, 2) if downsample else (32, 32, 1)
    x = np.random.RandomState(1).randn(2, 8, 8, in_chs)
    jmod = JBottleneck(out_chs=out_chs, stride=stride, has_downsample=downsample,
                       dtype=jnp.float64)

    def init():
        return jmod.init(jax.random.PRNGKey(0), x.astype(np.float32))

    params, stats = f64(random_params(init, 2)), f64(random_stats(init, 3))
    with jax.enable_x64(True):
        out = jmod.apply({"params": params, "batch_stats": stats}, x,
                         use_running_average=not train, mutable=["batch_stats"])
    want, new_stats = out[0], out[1].get("batch_stats", stats)
    tmod = Bottleneck(in_chs, out_chs, stride, downsample, dtype=torch.float64).double()
    tmod.load_state_dict(port_state(params, stats, AT_BLOCK), strict=True)
    got = tmod(to_torch(x).permute(0, 3, 1, 2), train=train).permute(0, 2, 3, 1)
    assert_close(got, want, ATOL, RTOL)
    assert_stats_close(tmod, new_stats, AT_BLOCK)


def narrow_jax_resnet(dtype=jnp.float64):
    return JResNet50(layers=LAYERS, channels=CHANNELS, dtype=dtype)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet50_matches_jax(train):
    """The narrow ResNet50: features (B, 128), and after a training forward
    every layer's batch_stats (the test an unbiased running_var fails)."""
    x = np.random.RandomState(4).randn(4, RES, RES, 3)
    jmod = narrow_jax_resnet()

    def init():
        return jmod.init(jax.random.PRNGKey(0), x.astype(np.float32))

    params, stats = f64(random_params(init, 5)), f64(random_stats(init, 6))
    with jax.enable_x64(True):
        want, upd = jax.jit(lambda p, s, x: jmod.apply(
            {"params": p, "batch_stats": s}, x, use_running_average=not train,
            mutable=["batch_stats"]))(params, stats, x)
    new_stats = upd.get("batch_stats", stats)
    tmod = ResNet50(LAYERS, CHANNELS, dtype=torch.float64).double()
    tmod.load_state_dict(port_state(params, stats, AT_ENCODER), strict=True)
    got = tmod(to_torch(x), train=train)
    assert got.shape == (4, CHANNELS[-1])
    assert_close(got, want, ATOL, RTOL)
    assert_stats_close(tmod, new_stats, AT_ENCODER)
    tracked = {int(v) for k, v in tmod.state_dict().items() if k.endswith("num_batches_tracked")}
    assert tracked == {int(train)}


# --- the iterative decoder ----------------------------------------------------

def test_mean_params_equal_the_jax_packages(tmp_path):
    """The fallback without the file, and a written smpl_mean_params.npz,
    read the same as the JAX package reads them."""
    np.testing.assert_array_equal(load_mean_params(str(tmp_path / "absent")),
                                  np.concatenate(j_load_mean_params(str(tmp_path / "absent"))))
    rng = np.random.RandomState(0)
    np.savez(tmp_path / "smpl_mean_params.npz", pose=rng.randn(144), shape=rng.randn(10),
             cam=rng.randn(3))
    got = load_mean_params(str(tmp_path))
    np.testing.assert_array_equal(got, np.concatenate(j_load_mean_params(str(tmp_path))))
    np.testing.assert_array_equal(got, got.astype(np.float32))  # the file's values, in f32
    reg = IterativeRegressor(feat_dim=8, hidden_dim=16, data_dir=str(tmp_path))
    assert torch.equal(reg.init_params, torch.from_numpy(got))
    assert "init_params" not in reg.state_dict()  # not a weight: the converter writes none


def test_iterative_regressor_matches_jax():
    """Three refinement steps from the mean parameters, then SMPL: the five
    outputs in eval mode."""
    rng = np.random.RandomState(7)
    x = rng.randn(6, 24)
    smpl = j_synthetic_smpl(NV, 0)
    jmod = JIterative(hidden_dim=32, dtype=jnp.float64)

    def init():
        return jmod.init(jax.random.PRNGKey(0), x.astype(np.float32), smpl)

    params = f64(random_params(init, 8))
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x: jmod.apply({"params": p}, x, smpl))(params, x)
    sd = {k[len("decoder."):]: to_torch(v) for k, v in j_convert({"decoder": params}).items()}
    tmod = IterativeRegressor(feat_dim=24, hidden_dim=32, dtype=torch.float64).double()
    tmod.load_state_dict(sd, strict=True)
    got = tmod(to_torch(x), t_synthetic_smpl(NV, 0, device="cpu"))
    for key in OUTPUTS:
        assert_close(got[key], want[key], ATOL, RTOL, what=key)


def test_iterative_dropout_draws_from_the_generator():
    """Training at rate 0.5: the masks come from the generator (one seed,
    one answer; another seed, another), and eval mode drops nothing."""
    reg = IterativeRegressor(feat_dim=8, hidden_dim=64, dtype=torch.float64).double()
    for p in reg.parameters():
        torch.nn.init.normal_(p, 0.0, 0.1, generator=torch.Generator().manual_seed(p.numel()))
    smpl = t_synthetic_smpl(NV, 0, device="cpu")
    x = torch.randn(4, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(0))

    def run(seed=None):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return reg(x, smpl, train=seed is not None, generator=g)["theta"]

    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    assert not torch.allclose(run(1), run())
    with pytest.raises(ValueError, match="Generator"):
        reg(x, smpl, train=True)


# --- MAED cnn + ktd and cnn + iterative ---------------------------------------

def jax_stage1_maed(monkeypatch, decoder, seed):
    """The JAX MAED (cnn + ``decoder``) with the narrow ResNet50 and the
    decoder's dropout at 0, and its parameters and batch_stats (f64, from
    ``seed``). ``monkeypatch`` patches the ResNet50 and decoders its module
    builds for the rest of the test: flax builds the submodules in
    ``setup``, at each init and apply."""
    monkeypatch.setattr(j_maed_module, "ResNet50",
                        functools.partial(JResNet50, layers=LAYERS, channels=CHANNELS))
    monkeypatch.setattr(j_maed_module, "KTD", functools.partial(JKTD, drop=0.0))
    monkeypatch.setattr(j_maed_module, "IterativeRegressor",
                        functools.partial(JIterative, drop=0.0))
    model = JMAED(encoder="cnn", decoder=decoder, hidden_dim=32, dtype=jnp.float64)

    def init():
        return model.init(jax.random.PRNGKey(0), np.zeros((1, T, RES, RES, 3), np.float32),
                          j_synthetic_smpl(NV, 0))

    return model, f64(random_params(init, seed)), f64(random_stats(init, seed + 1))


def port_stage1_maed(monkeypatch, decoder):
    """The port's MAED with the same narrow ResNet50 (patched into its module
    as on the JAX side) and the decoder's dropout at 0, in f64."""
    monkeypatch.setattr(t_maed_module, "ResNet50",
                        functools.partial(ResNet50, layers=LAYERS, channels=CHANNELS))
    return MAED(encoder="cnn", decoder=decoder, hidden_dim=32, img_size=RES, decoder_drop=0.0,
                smpl_dir="absent", dtype=torch.float64).double()


@pytest.mark.parametrize("decoder", ["ktd", "iterative"])
def test_maed_stage1_matches_jax(monkeypatch, decoder):
    """2 clips x 2 frames at 32 px: the eval forward's five outputs, then a
    training forward's outputs and new batch_stats (the decoder's dropout
    at 0 on both sides)."""
    model, params, stats = jax_stage1_maed(monkeypatch, decoder, 10)
    clips = np.random.RandomState(11).randn(2, T, RES, RES, 3)
    smpl = j_synthetic_smpl(NV, 0)

    def both(p, s, x):
        ev = model.apply({"params": p, "batch_stats": s}, x, smpl)
        tr, upd = model.apply({"params": p, "batch_stats": s}, x, smpl, deterministic=False,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
        return ev, tr, upd["batch_stats"]

    with jax.enable_x64(True):
        want_eval, want_train, new_stats = jax.jit(both)(params, stats, clips)
    tmod = port_stage1_maed(monkeypatch, decoder)
    tmod.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    t_smpl = t_synthetic_smpl(NV, 0, device="cpu")
    got = tmod(to_torch(clips), t_smpl)
    for key in OUTPUTS:
        assert_close(got[key], want_eval[key], ATOL, RTOL, what=f"eval {key}")
    tmod.train()
    got = tmod(to_torch(clips), t_smpl, generator=torch.Generator().manual_seed(0))
    for key in OUTPUTS:
        assert_close(got[key], want_train[key], ATOL, RTOL, what=f"train {key}")
    assert_stats_close(tmod.encoder, new_stats["encoder"], AT_ENCODER)


# --- one stage-1 train step ---------------------------------------------------

class _Optim:
    OPTIM, LR, WD, MOMENTUM = "Adam", 1e-3, 1e-5, 0.9
    WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES, GRAD_ACCUM_STEPS = 2, 0.1, [4, 6], 1


FIRST_LR = 1e-3 * 0.1


def image_batch(seed, n=4):
    """An image-only batch, as stage 1's step gets it."""
    rng = np.random.RandomState(seed)

    def kp(*shape):
        a = rng.randn(*shape)
        a[..., -1] = 1.0
        return a

    return {"image": rng.randn(n, RES, RES, 3), "kp_2d": kp(n, 49, 3), "kp_3d": kp(n, 49, 4),
            "theta": rng.randn(n, 85) * 0.1, "w_smpl": np.ones(n)}


@pytest.fixture(scope="module")
def jax_stage1_step(tmp_path_factory):
    """JAX's make_train_step(has_batch_stats=True) on ``image_batch(21)``
    (cnn + ktd, the dropout at 0): the parameters and batch_stats it starts
    from, its metrics, its gradient (read back from Adam's first moment),
    and the parameters and batch_stats after its update. The port's two
    ranks on halves of the batch, from the same parameters, run while JAX
    compiles (``ranks``)."""
    with pytest.MonkeyPatch.context() as mp:
        model, params, stats = jax_stage1_maed(mp, "ktd", 20)
        batch = image_batch(21)
        halves = [{k: to_torch(v[2 * r:2 * r + 2]) for k, v in batch.items()} for r in range(2)]
        job = dict(model=dict(encoder="cnn", decoder="ktd", hidden_dim=32, img_size=RES,
                              decoder_drop=0.0, smpl_dir="absent"),
                   resnet=dict(layers=LAYERS, channels=CHANNELS), num_verts=NV,
                   state_dict=state_dict_from_jax(params, stats),
                   optim={k: v for k, v in vars(_Optim).items() if k.isupper()},
                   calls=[(None, halves)])
        # then tp = 2: both ranks on the whole batch, the one data rank's
        whole = [{k: to_torch(v) for k, v in batch.items()}]
        ranks = Ranks([job, dict(job, mesh=dict(tp=2), calls=[(None, whole)])],
                      tmp_path_factory.mktemp("two_ranks"))
        smpl = j_synthetic_smpl(NV, 0)
        with jax.enable_x64(True):
            tx = JS.make_optimizer(_Optim, 10)
            state = JS.TrainState(params=params, opt_state=jax.jit(tx.init)(params),
                                  batch_stats=stats, step=jnp.zeros((), jnp.int32),
                                  rng=jax.random.PRNGKey(0))
            step = JS.make_train_step(model, tx, smpl, JLossWeights(), has_batch_stats=True,
                                      donate=False)
            new, metrics = step(state, None, batch)
            mu = next(s for s in new.opt_state if isinstance(s, optax.ScaleByAdamState)).mu
            grads = jax.tree.map(lambda m, p: np.asarray(m) / (1 - 0.9) - _Optim.WD * p, mu,
                                 params)
            return dict(params=params, stats=stats, ranks=ranks,
                        metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                        new_params=jax.tree.map(np.asarray, new.params),
                        new_stats=jax.tree.map(np.asarray, new.batch_stats))


def assert_stage1_step(got_metrics, grads, params, stats_of, want):
    """A stage-1 step's loss terms at rtol 1e-10, every gradient at 1e-9 x
    the largest, every parameter after Adam's first update (at 1e-10 plus
    what the two gradients' own difference moves that steep update by, as
    tests/test_torch_port_train.py holds it), and the new batch_stats
    (``stats_of``: the module that holds them), against JAX's."""
    assert set(got_metrics) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(float(got_metrics[k]), v, rtol=1e-10, atol=0, err_msg=k)
    want_g, p0 = state_dict_from_jax(want["grads"]), state_dict_from_jax(want["params"])
    want_p = state_dict_from_jax(want["new_params"])
    largest = max(float(v.abs().max()) for v in want_g.values())
    assert set(params) == set(want_g)
    for k, p in params.items():
        assert_close(grads[k], want_g[k], 1e-9 * largest, what=k)
        g, eps = want_g[k] + _Optim.WD * p0[k], 1e-8
        limit = 1e-10 + FIRST_LR * eps / (g.abs() + eps) ** 2 * (grads[k] - want_g[k]).abs()
        assert bool(((p - want_p[k]).abs() <= limit).all()), k
    assert_stats_close(stats_of, want["new_stats"]["encoder"], AT_ENCODER)


def test_stage1_train_step_matches_jax(monkeypatch, jax_stage1_step):
    """make_train_step on an image-only batch of four (cnn + ktd, the
    dropout at 0) against JAX's, as ``assert_stage1_step`` holds it."""
    want = jax_stage1_step
    tmod = port_stage1_maed(monkeypatch, "ktd").train()
    tmod.load_state_dict(state_dict_from_jax(want["params"], want["stats"]), strict=True)
    opt = TS.make_optimizer(_Optim, 10, tmod.parameters())
    tstep = TS.make_train_step(tmod, opt, t_synthetic_smpl(NV, 0, device="cpu"), LossWeights())
    got = tstep(None, {k: to_torch(v) for k, v in image_batch(21).items()})
    named = dict(tmod.named_parameters())
    assert_stage1_step(got, {k: p.grad for k, p in named.items()},
                       {k: p.detach() for k, p in named.items()}, tmod.encoder, want)


def test_tp2_ranks_match_jax_on_the_whole_batch(jax_stage1_step):
    """Stage 1 at tp = 2 (``parallel.mesh``): the ResNet and KTD are
    replicated, both ranks take the whole batch of the one data rank, and
    BatchNorm's moments and the loss's sums run over the data group (a
    sum over the tp group would count the batch twice), so the step is
    JAX's, as ``assert_stage1_step`` holds it; both ranks end equal bit for
    bit."""
    want = jax_stage1_step
    ranks = [results[1] for results in want["ranks"].results()]
    got = ranks[0]
    (metrics,) = got["metrics"]
    encoder_stats = {k[len("encoder."):]: v for k, v in got["stats"].items()}
    assert_stage1_step(metrics, got["grads"], got["params"], encoder_stats, want)
    assert ranks[1]["same_as_rank0"]


def test_two_ranks_on_halves_match_jax_on_the_whole_batch(jax_stage1_step):
    """Data parallel stage 1: two gloo ranks, each on two of the four
    images, against JAX's step on all four, as ``assert_stage1_step`` holds
    it. JAX's BatchNorm (no axis_name) takes the moments of the whole
    'dp'-sharded batch, so the port's must sum the ranks' moments: with
    each rank's own, the loss terms, the gradient and the running
    statistics all move. Both ranks end with the same parameters and
    statistics, bit for bit."""
    want = jax_stage1_step
    ranks = [results[0] for results in want["ranks"].results()]
    got = ranks[0]
    (metrics,) = got["metrics"]
    encoder_stats = {k[len("encoder."):]: v for k, v in got["stats"].items()}
    assert_stage1_step(metrics, got["grads"], got["params"], encoder_stats, want)
    assert ranks[1]["same_as_rank0"]


# --- checkpoints and the eval model -------------------------------------------

def test_model_config_of_the_two_stages():
    """configs/config_stage1.yaml builds the ResNet-50 + KTD, the stage-2
    config the STE + KTD."""
    configs = Path(__file__).resolve().parent.parent / "configs"
    base = dict(decoder="ktd", num_blocks=6, num_heads=12, hidden_dim=1024, img_size=224)
    assert model_config(update_cfg(str(configs / "config_stage1.yaml"))) == dict(
        base, encoder="cnn", st_mode="vanilla")
    assert model_config(update_cfg(str(configs / "config_stage2.yaml"))) == dict(
        base, encoder="ste", st_mode="parallel")
    with pytest.raises(NotImplementedError, match="encoder"):
        MAED(encoder="resnet18")


def test_pth_tar_round_trip_keeps_the_batchnorm_buffers(tmp_path):
    """The full-size stage-1 model (cnn + ktd, 32 px) after one training
    forward: its .pth.tar holds every BatchNorm buffer, num_batches_tracked
    included, which load strictly into build_eval_model; the eval model
    normalizes by them as the trained model in eval mode does."""
    kw = dict(encoder="cnn", decoder="ktd", hidden_dim=32, img_size=RES, device="cpu",
              allow_synthetic_smpl=True, smpl_dir="absent")
    model, smpl = build_train_model(seed=3, **kw)
    clips = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (1, T, RES, RES, 3),
                                                              dtype=np.uint8))
    with torch.no_grad():
        model(clips, smpl, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert int(sd["encoder.layer4.2.bn3.num_batches_tracked"]) == 1
    assert not torch.equal(sd["encoder.bn1.running_var"], torch.ones(64))
    path = ckpt.save_checkpoint(str(tmp_path), {"state_dict": sd, "epoch": 0,
                                                "performance": 1.0}, name="stage1")
    loaded = load_weights(path)
    assert loaded.keys() == sd.keys()
    for k, v in sd.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    eval_model, _ = build_eval_model(state_dict=loaded, dtype=torch.float32, **kw)
    assert not eval_model.training
    for k, v in eval_model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    model.eval()
    want = model(clips, smpl)
    got = eval_model(clips, smpl)
    for key in OUTPUTS:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("decoder", ["ktd", "iterative"])
def test_bf16_eval_model_keeps_batchnorm_in_f32(decoder):
    """build_eval_model(bf16) of the stage-1 model: the convs and dense
    weights cast to bf16, BatchNorm's affine and statistics f32; its
    forward ends finite."""
    model, smpl = build_eval_model(encoder="cnn", decoder=decoder, hidden_dim=32, img_size=RES,
                                   dtype=torch.bfloat16, device="cpu", seed=1,
                                   allow_synthetic_smpl=True, smpl_dir="absent")
    for name, t in model.state_dict().items():
        if ".bn" in name or ".downsample.1." in name:
            want = torch.long if name.endswith("num_batches_tracked") else torch.float32
        else:
            want = torch.bfloat16
        assert t.dtype == want, name
    clips = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (1, T, RES, RES, 3),
                                                              dtype=np.uint8))
    out = model(clips, smpl)
    assert out["verts"].shape == (1, T, 6890, 3)
    assert all(torch.isfinite(v.float()).all() for v in out.values())


def test_weights_of_the_cnn_models_load_strictly(monkeypatch):
    """state_dict_from_jax of a cnn + iterative parameter tree and its
    batch_stats loads strictly into the port's model; every
    num_batches_tracked is int64 0."""
    _, params, stats = jax_stage1_maed(monkeypatch, "iterative", 30)
    sd = state_dict_from_jax(params, stats)
    port_stage1_maed(monkeypatch, "iterative").load_state_dict(sd, strict=True)
    tracked = [v for k, v in sd.items() if k.endswith("num_batches_tracked")]
    assert len(tracked) == 4 * 4 + 1 and all(
        v.dtype == torch.int64 and int(v) == 0 for v in tracked)


# --- the published backbone ---------------------------------------------------

STAGE2 = dict(encoder="ste", st_mode="parallel", decoder="ktd", num_heads=2, hidden_dim=32)




def npz_entries(encoder):
    """A published in21k .npz (TF/JAX naming) holding ``encoder``'s weights:
    the inverse of the importer's mapping, with q, k and v split and the
    attention's out kernel as (h, d, C); MAED's own gate and temp_embed are
    not in it, and a classifier head is."""
    C, heads = 768, STAGE2["num_heads"]
    out = {"head/kernel": np.ones((C, 3), np.float32)}
    bb = encoder["patch_embed"]["backbone"]
    out["resnet/root_block/standardized_conv2d/kernel"] = bb["stem_conv"]["kernel"]
    for leaf, tf in (("scale", "gamma"), ("bias", "beta")):
        out[f"resnet/group_norm/{tf}"] = bb["stem_norm"]["GroupNorm_0"][leaf]
    for stage in (k for k in bb if k.startswith("stage")):
        for block, mods in bb[stage].items():
            unit = f"resnet/block{int(stage[5:]) + 1}/unit{int(block[5:]) + 1:02d}"
            for i, abc in enumerate("abc"):
                out[f"{unit}/{abc}/standardized_conv2d/kernel"] = mods[f"conv{i + 1}"]["kernel"]
                for leaf, tf in (("scale", "gamma"), ("bias", "beta")):
                    out[f"{unit}/{abc}/group_norm/{tf}"] = mods[f"norm{i + 1}"]["GroupNorm_0"][leaf]
            if "downsample" in mods:
                ds = mods["downsample"]
                out[f"{unit}/a/proj/standardized_conv2d/kernel"] = ds["conv"]["kernel"]
                for leaf, tf in (("scale", "gamma"), ("bias", "beta")):
                    out[f"{unit}/a/proj/group_norm/{tf}"] = ds["norm"]["GroupNorm_0"][leaf]
    for leaf in ("kernel", "bias"):
        out[f"embedding/{leaf}"] = encoder["patch_embed"]["proj"][leaf]
        out[f"pre_logits/{leaf}"] = encoder["pre_logits"][leaf]
    out["cls"] = encoder["cls_token"]
    out["Transformer/posembed_input/pos_embedding"] = encoder["pos_embed"]
    for leaf in ("scale", "bias"):
        out[f"Transformer/encoder_norm/{leaf}"] = encoder["norm"][leaf]
    for name in (k for k in encoder if k.startswith("blocks_")):
        blk, base = encoder[name], f"Transformer/encoderblock_{name[7:]}"
        for leaf in ("scale", "bias"):
            out[f"{base}/LayerNorm_0/{leaf}"] = blk["norm1"][leaf]
            out[f"{base}/LayerNorm_2/{leaf}"] = blk["norm2"][leaf]
        for i, fc in enumerate(("fc1", "fc2")):
            for leaf in ("kernel", "bias"):
                out[f"{base}/MlpBlock_3/Dense_{i}/{leaf}"] = blk["mlp"][fc][leaf]
        attn = f"{base}/MultiHeadDotProductAttention_1"
        out[f"{attn}/out/kernel"] = blk["attn"]["proj"]["kernel"].reshape(heads, C // heads, C)
        out[f"{attn}/out/bias"] = blk["attn"]["proj"]["bias"]
        qkv_k, qkv_b = blk["attn"]["qkv"]["kernel"], blk["attn"]["qkv"]["bias"]
        for i, n in enumerate(("query", "key", "value")):
            out[f"{attn}/{n}/kernel"] = qkv_k[:, i * C:(i + 1) * C].reshape(C, heads, C // heads)
            out[f"{attn}/{n}/bias"] = qkv_b[i * C:(i + 1) * C].reshape(heads, C // heads)
    return out


@pytest.fixture(scope="module")
def backbone_files(tmp_path_factory):
    """The model's init (1 block), a published init of 2 blocks as .npz and
    as a timm .pth (reference names, a classifier head, none of MAED's own
    parameters), both of seeded random weights."""
    d = tmp_path_factory.mktemp("backbone")
    model = JMAED(num_blocks=2, **STAGE2)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, T, RES, RES, 3), np.float32),
        j_synthetic_smpl(NV, 0)))

    def zeros():  # traced once above; each draw below retraces only this
        return jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)

    published = random_params(zeros, 41)
    init = random_params(zeros, 40)
    del init["encoder"]["blocks_1"]
    np.savez(d / "in21k.npz", **npz_entries(published["encoder"]))
    timm = {k[len("encoder."):]: v for k, v in state_dict_from_jax(published).items()
            if k.startswith("encoder.") and "ts_attn" not in k and "temp_embed" not in k}
    timm.update({"head.weight": torch.ones(3, 768), "head.bias": torch.zeros(3)})
    torch.save(timm, d / "in21k.pth")
    return init, published, d


@pytest.mark.parametrize("suffix", ["npz", "pth"])
def test_init_backbone_matches_jax(backbone_files, suffix):
    """--init_backbone's function against the JAX package's
    apply_pretrained_backbone then state_dict_from_jax: every weight equal.
    Each mapped tensor equals its source; block 1 of the file and its head
    are left out; the gate, temp_embed and the decoder keep their init."""
    init, published, d = backbone_files
    path = str(d / f"in21k.{suffix}")
    want = {k: to_torch(v) for k, v in j_convert(j_apply_pretrained(init, path)).items()}
    model = MAED(num_blocks=1, num_heads=2, hidden_dim=32, img_size=RES)
    model.load_state_dict(state_dict_from_jax(init), strict=True)
    unused = apply_pretrained_backbone(model, path)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    source, start = state_dict_from_jax(published), state_dict_from_jax(init)
    kept = ("ts_attn", "temp_embed", "decoder.")
    for k, v in got.items():
        assert torch.equal(v, (start if any(s in k for s in kept) else source)[k]), k
    assert any(".blocks.1." in u for u in unused)
