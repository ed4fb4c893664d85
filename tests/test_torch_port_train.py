"""maed_tpu_torch's stage-2 training against maed_tpu's on the CPU, at the
tiny config of tests/test_train.py (1 block, 2 heads, KTD hidden 32, 32 px,
T = 2, a 64-vertex synthetic SMPL; two 2D clips, two 3D clips, one of them
with a partial SMPL selection, and two images a step):

- the warmup/milestone schedule equals JAX's at every step of a run
  crossing the warmup and both milestones (exactly, f64 on both sides);
- Adam with L2, SGD with momentum, and Adam with GRAD_ACCUM_STEPS = 2 equal
  optax's ``make_optimizer`` over 3 updates of a toy parameter dict, in f64
  (rtol 1e-12, atol 1e-15: the two sum the same terms in other orders);
- one whole train step, port against ``make_train_step``, in f64 with the
  JAX parameters carried across: the total loss and every merged term at
  rtol 1e-10, every parameter's gradient at atol 1e-9 x the largest
  gradient, every parameter after the Adam update at atol 1e-10 plus what
  the two gradients' own difference moves Adam's first update by where it
  is steep (|g| near eps; ``_assert_params``); for GRAD_ACCUM_STEPS = 2 (two
  calls, the second updating) and for one update a call; the same steps
  in two gloo processes, each on its half of the batches (data parallel,
  ``parallel.dist``), against JAX's on the whole batches; the same two
  processes at tp = 2 (``parallel.mesh``: each ViT block split over them,
  one head each, both on the whole batches) against JAX's step, and with
  every dropout and drop-path rate positive against the port's one-process
  step with the same masks. A parallel block
  in training with every dropout rate positive against the JAX block's
  stochastic path at 1e-9. KTD's dropout is 0 on both sides here; the JAX model gets it
  through ``monkeypatch`` of the ``KTD`` its ``MAED`` builds;
- dropout: train mode at rate 0 equals eval mode bit for bit; KTD's 0.5
  zeroes about half (within 5 binomial standard deviations) and keeps x /
  0.5 exactly; two steps from one generator seed are identical;
- ``torch.autograd.gradcheck`` (fast mode) in f64 of every kernel's
  autograd Function through its CPU path.

JAX is compiled once, for the step with one update a call, with the
parameters as jit arguments, and called from the same state on two batches.
Each call gives its loss terms, its updated parameters and, through Adam's
first moment after one update (mu = (1 - b1) (g + wd p)), its gradient.
With GRAD_ACCUM_STEPS = 2 the port's two calls see those same parameters
(the first call does not update), so the expected update is what
``make_optimizer``'s MultiSteps transform (k = 2) makes of JAX's two
gradients (a jit of the transform alone).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

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
from maed_tpu.models.vit import Block as JBlock
from maed_tpu.parallel import train_step as JS
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch.core.builder import build_train_model
from maed_tpu_torch.core.loss import LossWeights
from maed_tpu_torch.models.ktd import KTD
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.models.vit import Block
from maed_tpu_torch.ops import attention as TA
from maed_tpu_torch.ops import groupnorm as TGN
from maed_tpu_torch.ops import layernorm as TLN
from maed_tpu_torch.ops import mlp as TMLP
from maed_tpu_torch.ops import skinning as TK
from maed_tpu_torch.ops import st_attention as TST
from maed_tpu_torch.parallel import train_step as TS
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import as_f64, random_params, sub_state_dict
from torch_port_common import Ranks, assert_close, one_torch_thread, to_torch  # noqa: F401

CONFIG = dict(num_blocks=1, num_heads=2, hidden_dim=32)
T, RES = 2, 32
LOSS_RTOL, GRAD_ATOL, PARAM_ATOL = 1e-10, 1e-9, 1e-10
OPT_RTOL, OPT_ATOL = 1e-12, 1e-15
FIRST_LR = 1e-3 * 0.1  # _Optim's rate in the first warmup epoch


class _Optim:
    OPTIM = "Adam"
    LR = 1e-3
    WD = 1e-5
    MOMENTUM = 0.9
    WARMUP_EPOCH = 2
    WARMUP_FACTOR = 0.1
    MILESTONES = [4, 6]
    GRAD_ACCUM_STEPS = 1


def _optim(**kw):
    return type("Optim", (_Optim,), kw)


def test_schedule_matches_jax_at_every_step():
    spe, epochs = 7, 8  # warmup epochs 0-1, milestones at epochs 4 and 6
    sched = TS.warmup_milestone_schedule(1e-3, 2, 0.1, [4, 6], spe)
    p = torch.nn.Parameter(torch.zeros(1, dtype=torch.float64))
    opt = TS.make_optimizer(_Optim, spe, [p])
    with jax.enable_x64(True):
        jsched = JS.warmup_milestone_schedule(1e-3, 2, 0.1, [4, 6], spe)
        want = [float(jsched(jnp.asarray(s, jnp.int32))) for s in range(spe * epochs)]
    got, lrs = [], []
    for s in range(spe * epochs):
        got.append(sched(s))
        lrs.append(opt.optimizer.param_groups[0]["lr"])
        opt.step()  # no gradient: the schedule steps, the parameter stays
    assert got == want
    assert lrs == want
    per_epoch = [want[e * spe] for e in range(epochs)]
    assert per_epoch == pytest.approx([1e-4, 2e-4, 1e-3, 1e-3, 1e-4, 1e-4, 1e-5, 1e-5])


def test_grad_accum_that_does_not_divide_the_epoch_warns():
    p = torch.nn.Parameter(torch.zeros(1))
    with pytest.warns(UserWarning, match="does not divide"):
        TS.make_optimizer(_optim(GRAD_ACCUM_STEPS=3), 10, [p])


def _toy(rng):
    return {"a": rng.randn(3, 4), "b": rng.randn(5)}


@pytest.mark.parametrize("optim, accum", [("adam", 1), ("sgd", 1), ("adam", 2)])
def test_optimizer_matches_optax(optim, accum):
    """3 updates (3 * accum calls) of a toy dict from the same gradients, at
    a schedule of 2 updates an epoch that crosses the first warmup epoch."""
    cfg = _optim(OPTIM=optim, GRAD_ACCUM_STEPS=accum, WD=0.1)
    rng = np.random.RandomState(0)
    params = _toy(rng)
    grads = [_toy(rng) for _ in range(3 * accum)]
    spe = 2 * accum
    with jax.enable_x64(True):
        tx = JS.make_optimizer(cfg, spe)
        jp = jax.tree.map(jnp.asarray, params)
        state = tx.init(jp)
        want = []
        for g in grads:
            updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, updates)
            want.append(jax.tree.map(np.asarray, jp))
    tp = {k: torch.nn.Parameter(to_torch(v)) for k, v in params.items()}
    opt = TS.make_optimizer(cfg, spe, list(tp.values()))
    for g, w in zip(grads, want):
        opt.zero_grad()
        loss = sum((tp[k] * to_torch(g[k])).sum() for k in tp)
        (loss / opt.accum_steps).backward()
        opt.step()
        for k in tp:
            assert_close(tp[k], w[k], OPT_ATOL, OPT_RTOL, what=k)


# --- one whole train step, port against JAX --------------------------------

def _kp(rng, *shape):
    kp = rng.randn(*shape)
    kp[..., -1] = 1.0
    return kp


def _batches(seed):
    """A video batch (two 2D clips, then two 3D clips, T frames; the second
    3D clip's SMPL target selected on its first frame only) and an image
    batch of two frames, as numpy f64, in make_train_step's layout."""
    rng = np.random.RandomState(seed)
    vid = {"images": rng.randn(4, T, RES, RES, 3),
           "target_2d": {"kp_2d": _kp(rng, 2, T, 49, 3)},
           "target_3d": {"kp_2d": _kp(rng, 2, T, 49, 3), "kp_3d": _kp(rng, 2, T, 49, 4),
                         "theta": rng.randn(2, T, 85) * 0.1,
                         "w_smpl": np.array([[1.0] * T, [1.0] + [0.0] * (T - 1)])}}
    img = {"image": rng.randn(2, RES, RES, 3), "kp_2d": _kp(rng, 2, 49, 3),
           "kp_3d": _kp(rng, 2, 49, 4), "theta": rng.randn(2, 85) * 0.1,
           "w_smpl": np.ones(2)}
    return vid, img


def _halves(seed, world=2):
    """Rank r's slice of ``_batches(seed)``: the r-th 2D clip, the r-th 3D
    clip and the r-th image, as f64 tensors."""
    vid, img = _batches(seed)
    vids, imgs = [], []
    for r in range(world):
        vids.append(_tree({"images": vid["images"][[r, world + r]],
                           "target_2d": {"kp_2d": vid["target_2d"]["kp_2d"][r:r + 1]},
                           "target_3d": {k: v[r:r + 1] for k, v in vid["target_3d"].items()}},
                          to_torch))
        imgs.append(_tree({k: v[r:r + 1] for k, v in img.items()}, to_torch))
    return vids, imgs


def _tree(batch, convert):
    return {k: _tree(v, convert) if isinstance(v, dict) else convert(v) for k, v in batch.items()}


def _adam_mu(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState)).mu


# the rates of the tp = 2 step with dropout (KTD's too)
TP_RATES = dict(drop_rate=0.1, attn_drop_rate=0.2, drop_path_rate=0.3, decoder_drop=0.5)


def start_two_ranks(params, tmp_path):
    """The port's step in two gloo processes, from ``params``: data
    parallel, each on its half of the batches (one 2D clip, one 3D clip,
    one image), one update on batch 1, and GRAD_ACCUM_STEPS = 2 over
    batches 1 and 2; then tensor parallel (tp = 2, one data rank: both on
    the whole of batch 1), one update, without dropout and with TP_RATES;
    started now, their results read by the test."""
    halves = [_halves(1), _halves(2)]
    whole = [tuple([_tree(b, to_torch)] for b in _batches(1))]
    job = dict(model=dict(img_size=RES, decoder_drop=0.0, **CONFIG),
               state_dict=state_dict_from_jax(params), num_verts=64)
    optim = {k: v for k, v in vars(_Optim).items() if k.isupper()}
    tp = dict(job, optim=optim, calls=whole, mesh=dict(tp=2))
    return Ranks([dict(job, optim=optim, calls=halves[:1]),
                  dict(job, optim=dict(optim, GRAD_ACCUM_STEPS=2), calls=halves), tp,
                  dict(tp, model=dict(job["model"], **TP_RATES))], tmp_path)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX step (one compile) from the same state on batches 1 and 2:
    the parameters it starts from, and per batch the metrics, the gradient
    and the parameters after the update; and the parameters that
    GRAD_ACCUM_STEPS = 2 makes of the two gradients. The two ranks of
    ``start_two_ranks`` run while JAX compiles the step, and the
    accumulation's optimizer compiles beside it in a thread (for the
    parameters' shapes)."""
    x = np.zeros((1, T, RES, RES, 3), np.float32)
    smpl = j_synthetic_smpl(64, 0)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            ThreadPoolExecutor(1) as pool:
        mp.setattr(j_maed_module, "KTD", functools.partial(JKTD, drop=0.0))
        model = JMAED(encoder="ste", st_mode="parallel", decoder="ktd", dtype=jnp.float64,
                      **CONFIG)
        params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              random_params(lambda: model.init(jax.random.PRNGKey(0), x, smpl),
                                            0))
        ranks = start_two_ranks(params, tmp_path_factory.mktemp("two_ranks"))
        tx2 = JS.make_optimizer(_optim(GRAD_ACCUM_STEPS=2), 10)

        def two_calls(p, grads):
            opt_state = tx2.init(p)
            for g in grads:
                updates, opt_state = tx2.update(g, opt_state, p)
                p = optax.apply_updates(p, updates)
            return p

        def compile_two_calls():
            with jax.enable_x64(True):  # the flag is the thread's own
                spec = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
                return jax.jit(two_calls).lower(spec, [spec, spec]).compile()

        two_calls_compiled = pool.submit(compile_two_calls)
        tx = JS.make_optimizer(_Optim, 10)
        state = JS.TrainState(params=params, opt_state=jax.jit(tx.init)(params), batch_stats={},
                              step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
        step = JS.make_train_step(model, tx, smpl, JLossWeights(), donate=False)
        runs = []
        for seed in (1, 2):
            new, m = step(state, *_batches(seed))
            grads = jax.tree.map(lambda mu, p: np.asarray(mu) / (1 - 0.9) - _Optim.WD * p,
                                 _adam_mu(new.opt_state), params)
            runs.append(dict(metrics={k: float(v) for k, v in m.items()}, grads=grads,
                             params=jax.tree.map(np.asarray, new.params)))
        accum_params = two_calls_compiled.result()(params, [run["grads"] for run in runs])
        mean_grads = jax.tree.map(lambda a, b: (a + b) / 2, runs[0]["grads"], runs[1]["grads"])
    return dict(params=params, runs=runs, mean_grads=mean_grads, ranks=ranks,
                accum_params=jax.tree.map(np.asarray, accum_params))


def _port_model(params, decoder_drop=0.0, **rates):
    """The port's MAED in f64, parameters too (as JAX's: the stem
    standardizes its weights in their own dtype), in training mode."""
    model = MAED(img_size=RES, decoder_drop=decoder_drop, dtype=torch.float64, **CONFIG,
                 **rates).double()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.train()


def _port_step(model, accum, generator=None):
    opt = TS.make_optimizer(_optim(GRAD_ACCUM_STEPS=accum), 10, model.parameters())
    smpl = t_synthetic_smpl(64, 0, device="cpu")
    return TS.make_train_step(model, opt, smpl, LossWeights(), generator)


def _run(step, seed):
    vid, img = _batches(seed)
    return step(_tree(vid, to_torch), _tree(img, to_torch))


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=LOSS_RTOL, atol=0, err_msg=k)


def _state(model):
    """(every parameter's value, every parameter's .grad) by name."""
    named = dict(model.named_parameters())
    return ({k: p.detach() for k, p in named.items()}, {k: p.grad for k, p in named.items()})


def _assert_grads(grads, want_tree, scale=1.0):
    """Every parameter's gradient (``grads`` by name) times ``scale``
    against the JAX gradient."""
    want = state_dict_from_jax(want_tree)
    largest = max(np.abs(v.numpy()).max() for v in want.values())
    assert set(grads) == set(want)
    for k, v in want.items():
        assert grads[k] is not None, k
        assert_close(grads[k] * scale, v, GRAD_ATOL * largest, what=k)


def _assert_params(state, want_tree, start=None, grads_tree=None):
    """Every parameter of ``state`` (values, gradients) against JAX's at
    PARAM_ATOL, plus, after a first Adam update of lr * g / (|g| + eps) from
    ``start`` with the JAX gradient ``grads_tree`` (g = that gradient + WD *
    the parameter), what the two gradients' own difference moves that
    update by: lr * eps / (|g| + eps)^2 * |g_port - g_jax|. The update is
    steep where |g| nears eps = 1e-8, so there a difference of gradients at
    f64 rounding (far inside GRAD_ATOL) moves a parameter by more than
    1e-10."""
    want = state_dict_from_jax(want_tree)
    if grads_tree is not None:
        grads, p0 = state_dict_from_jax(grads_tree), state_dict_from_jax(start)
    params, port_grads = state
    for k, p in params.items():
        diff = (p - want[k]).abs()
        limit = torch.full_like(diff, PARAM_ATOL)
        if grads_tree is not None:
            g, eps = grads[k] + _Optim.WD * p0[k], 1e-8
            limit += FIRST_LR * eps / (g.abs() + eps) ** 2 * (port_grads[k] - grads[k]).abs()
        assert bool((diff <= limit).all()), (k, float((diff - limit).max()))


def test_train_step_matches_jax_with_grad_accumulation(jax_run):
    """GRAD_ACCUM_STEPS = 2: the first call's loss terms and its gradient
    (held halved), no update; the second call's terms, the mean gradient and
    the update."""
    model = _port_model(jax_run["params"])
    step = _port_step(model, accum=2)
    first, second = jax_run["runs"]
    _assert_metrics(_run(step, 1), first["metrics"])
    _assert_grads(_state(model)[1], first["grads"], scale=2.0)
    _assert_params(_state(model), jax_run["params"])
    _assert_metrics(_run(step, 2), second["metrics"])
    _assert_grads(_state(model)[1], jax_run["mean_grads"])
    _assert_params(_state(model), jax_run["accum_params"], jax_run["params"],
                   jax_run["mean_grads"])


def test_train_step_matches_jax(jax_run):
    """One update a call, on the mixed video + image batch: the loss terms,
    the gradient and the updated parameters (the second batch's terms and
    gradient are held by the accumulation test)."""
    model = _port_model(jax_run["params"])
    run = jax_run["runs"][0]
    _assert_metrics(_run(_port_step(model, accum=1), 1), run["metrics"])
    _assert_grads(_state(model)[1], run["grads"])
    _assert_params(_state(model), run["params"], jax_run["params"], run["grads"])
    assert TS.debug_nan_params(model) == []
    next(model.parameters()).grad[0] = float("nan")
    assert TS.debug_nan_params(model) == [next(iter(dict(model.named_parameters())))]


# --- data parallel: two gloo ranks on halves of the batches -------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_on_halves_match_jax_on_the_whole_batch(jax_run, accum):
    """Data parallel, as the JAX step over its 'dp' mesh: two ranks, each on
    half of the batches, against JAX's step on the whole batches. The loss
    terms averaged over the ranks at LOSS_RTOL (loss_pose and loss_shape
    divide by the global count of selected rows: the second 3D clip's
    w_smpl selects one frame of T, so per-rank counts would differ; the
    theta norm takes the global sum), the gradient averaged over the ranks
    at GRAD_ATOL x the largest, the parameters after the update as
    ``_assert_params`` holds them; for one update a call and for
    GRAD_ACCUM_STEPS = 2 (the second call averages the two calls' summed
    gradients over the ranks and updates). Both ranks end with the same
    parameters and gradients, bit for bit."""
    ranks = [results[accum - 1] for results in jax_run["ranks"].results()]
    got = ranks[0]
    runs = jax_run["runs"][:accum]
    assert len(got["metrics"]) == accum
    for metrics, run in zip(got["metrics"], runs):
        _assert_metrics(metrics, run["metrics"])
    grads = runs[0]["grads"] if accum == 1 else jax_run["mean_grads"]
    params = runs[0]["params"] if accum == 1 else jax_run["accum_params"]
    _assert_grads(got["grads"], grads)
    _assert_params((got["params"], got["grads"]), params, jax_run["params"], grads)
    assert ranks[1]["same_as_rank0"]


# --- tensor parallel: two gloo ranks, each block split over them --------------

def test_tp2_step_matches_jax_on_the_whole_batch(jax_run):
    """tp = 2 (``parallel.mesh``; CONFIG's two heads, one a rank; fc1 and fc2
    split at 1536 hidden columns each): the step on the whole batch 1
    against JAX's, as the data-parallel ranks are held: the loss terms at
    LOSS_RTOL, every parameter's gradient gathered to its full name (the
    replicated ones summed over the group: ts_attn, the norms, proj's and
    fc2's biases) at GRAD_ATOL x the largest, the updated parameters as
    ``_assert_params`` holds them; both ranks end equal bit for bit."""
    ranks = [results[2] for results in jax_run["ranks"].results()]
    got, run = ranks[0], jax_run["runs"][0]
    (metrics,) = got["metrics"]
    _assert_metrics(metrics, run["metrics"])
    _assert_grads(got["grads"], run["grads"])
    for name in ("encoder.blocks.0.attn.ts_attn.weight", "encoder.blocks.0.norm1.weight",
                 "encoder.blocks.0.attn.proj.bias", "encoder.blocks.0.mlp.fc2.bias",
                 "encoder.blocks.0.attn.qkv.weight", "encoder.blocks.0.mlp.fc1.weight"):
        assert got["grads"][name].shape == state_dict_from_jax(run["grads"])[name].shape
    _assert_params((got["params"], got["grads"]), run["params"], jax_run["params"], run["grads"])
    assert ranks[1]["same_as_rank0"]


def test_tp2_step_with_dropout_equals_the_one_process_step(jax_run):
    """tp = 2 with every dropout and drop-path rate positive (TP_RATES): the
    ranks draw each mask whole from the data rank's generator (seed 0) and
    take their heads' or hidden columns' part, so their step equals the
    port's one-process step from generator seed 0: the loss terms at
    LOSS_RTOL, the gradient at GRAD_ATOL x the largest, the parameters at
    PARAM_ATOL plus Adam's steep-update allowance."""
    got = jax_run["ranks"].results()[0][3]
    model = _port_model(jax_run["params"], **TP_RATES)
    want = _run(_port_step(model, 1, torch.Generator().manual_seed(0)), 1)
    (metrics,) = got["metrics"]
    _assert_metrics(metrics, {k: float(v) for k, v in want.items()})
    params, grads = _state(model)
    largest = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        assert_close(got["grads"][name], g, GRAD_ATOL * largest, what=name)
    start = state_dict_from_jax(jax_run["params"])
    for name, p in params.items():
        g, eps = grads[name] + _Optim.WD * start[name], 1e-8
        limit = PARAM_ATOL + FIRST_LR * eps / (g.abs() + eps) ** 2 * (
            got["grads"][name] - grads[name]).abs()
        assert bool(((got["params"][name] - p).abs() <= limit).all()), name


# --- dropout -----------------------------------------------------------------

def _clips(seed, n=1):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 256, (n, T, RES, RES, 3),
                                                                dtype=np.uint8))


def test_train_forward_at_rate_0_equals_the_eval_forward(jax_run):
    model = _port_model(jax_run["params"]).eval()
    smpl = t_synthetic_smpl(64, 0, device="cpu")
    clips = _clips(3)
    want = model(clips, smpl)
    model.train()
    got = model(clips, smpl, generator=torch.Generator().manual_seed(0))
    assert got["theta"].requires_grad and not want["theta"].requires_grad
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_ktd_dropout_at_half():
    """KTD's trunk in a training forward: of n entries, the zeroed count lies
    within 5 binomial standard deviations (sqrt(n / 4)) of n / 2, and every
    kept entry is exactly x / 0.5; another generator seed draws other masks.
    Without train, nothing is dropped."""
    torch.manual_seed(0)
    ktd = KTD(feat_dim=16, hidden_dim=1024, dtype=torch.float64).double()
    seen = []
    ktd.dropout.register_forward_hook(lambda mod, args, out: seen.append((args[0], out)))
    smpl = t_synthetic_smpl(64, 0, device="cpu")
    x = torch.randn(64, 16, dtype=torch.float64)
    with torch.no_grad():
        ktd(x, smpl, train=True, generator=torch.Generator().manual_seed(1))
        assert len(seen) == 2
        for inp, out in seen:
            n = inp.numel()
            zeroed = int(((out == 0) & (inp != 0)).sum())
            assert abs(zeroed - n / 2) <= 5 * (n / 4) ** 0.5, (zeroed, n)
            kept = out != 0
            assert torch.equal(out[kept], inp[kept] / 0.5)
        masks = [out != 0 for _, out in seen]
        seen.clear()
        ktd(x, smpl, train=True, generator=torch.Generator().manual_seed(2))
        assert not torch.equal(seen[0][1] != 0, masks[0])
        seen.clear()
        ktd(x, smpl)
        assert all(torch.equal(inp, out) for inp, out in seen)


def test_two_steps_from_one_generator_seed_are_identical(jax_run):
    """With KTD's dropout at 0.5: the same seed gives the same metrics and
    parameters bit for bit (that another seed draws other masks:
    test_ktd_dropout_at_half)."""
    def run(seed):
        model = _port_model(jax_run["params"], decoder_drop=0.5)
        metrics = _run(_port_step(model, 1, torch.Generator().manual_seed(seed)), 1)
        return metrics, [p.detach().clone() for p in model.parameters()]

    (ma, pa), (mb, pb) = run(5), run(5)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


# positive, so that every dropout takes its training path, yet below what a
# uniform draw can fall short of: every entry is kept (scaled by 1 + 1e-12)
TINY_RATE = 1e-12


@pytest.mark.parametrize("seqlen", [1, 2])
def test_block_training_path_matches_jax_f64(seqlen):
    """A parallel block in training with its dropout, attention dropout and
    drop-path rates positive (TINY_RATE): the port's unfused forms (the
    attention branches' plain versions with dropout on their probabilities,
    no seqlen == 1 shortcut, the plain gate, proj and MLP, the residuals
    added outside) against the JAX Block's stochastic path, in f64 at 1e-9;
    then against the port's fused training forward at rate 0."""
    x = np.random.RandomState(7).randn(4, 5, 64)
    rates = dict(drop=TINY_RATE, attn_drop=TINY_RATE, drop_path=TINY_RATE)
    jmod = JBlock(64, 2, st_mode="parallel", dtype=jnp.float64, **rates)
    params = random_params(
        lambda: jmod.init(jax.random.PRNGKey(0), x.astype(np.float32), seqlen), 4)
    with jax.enable_x64(True):
        want = jax.jit(lambda p, x, key: jmod.apply(p, x, seqlen, deterministic=False,
                                                    rngs={"dropout": key}))(
            {"params": as_f64(params)}, x, jax.random.PRNGKey(1))
    sd = sub_state_dict(params, "encoder/blocks_0", "encoder.blocks.0.")
    tmod = Block(64, 2, dtype=torch.float64, **rates).double()
    tmod.load_state_dict(sd, strict=True)
    got = tmod(to_torch(x), seqlen, train=True, generator=torch.Generator().manual_seed(0))
    assert_close(got, want, 1e-9)
    fused = Block(64, 2, dtype=torch.float64).double()
    fused.load_state_dict(sd, strict=True)
    assert_close(got, fused(to_torch(x), seqlen, train=True), 1e-9)


def test_dropout_needs_a_generator(jax_run):
    model = _port_model(jax_run["params"], decoder_drop=0.5)
    with pytest.raises(ValueError, match="Generator"):
        model(_clips(4), t_synthetic_smpl(64, 0, device="cpu"))


def test_build_train_model_casts_at_use(tmp_path):
    """f32 master weights in training mode, the standardization in the
    forward; a bf16 step through them keeps the parameters and their
    gradients f32 and ends finite."""
    model, smpl = build_train_model(img_size=RES, dtype=torch.bfloat16, device="cpu", seed=0,
                                    allow_synthetic_smpl=True, smpl_dir=str(tmp_path), **CONFIG)
    assert model.training and model.encoder.patch_embed.backbone.stem.conv.standardize
    opt = TS.make_optimizer(_Optim, 10, model.parameters())
    step = TS.make_train_step(model, opt, smpl, LossWeights(), torch.Generator().manual_seed(0))
    vid, img = _batches(5)
    metrics = step(_tree(vid, lambda a: to_torch(a, torch.float32)),
                   _tree(img, lambda a: to_torch(a, torch.float32)))
    assert all(torch.isfinite(v) for v in metrics.values())
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    assert TS.debug_nan_params(model) == []


# --- the kernels' autograd Functions -------------------------------------------

def _f64(rng, *shape, scale=1.0, requires_grad=True):
    return torch.tensor(rng.randn(*shape) * scale, dtype=torch.float64,
                        requires_grad=requires_grad)


def _gate_out(*args):
    return TMLP.fused_gate_proj(*args)[0]


def _gradcheck_cases():
    rng = np.random.RandomState(9)
    qkv = _f64(rng, 4, 5, 3, 2, 8, scale=0.5)
    q, k, v = (_f64(rng, 2, 2, 6, 8, scale=0.5) for _ in range(3))
    A = _f64(rng, 2, 24, 4, 4, scale=0.3)
    W = torch.tensor(rng.rand(7, 24), dtype=torch.float64)
    return {
        "fast_layernorm": (TLN.fast_layernorm, (_f64(rng, 3, 16, scale=2.0), _f64(rng, 16),
                                                _f64(rng, 16), 1e-6)),
        "fused_ln_dense": (TMLP.fused_ln_dense, (_f64(rng, 2, 3, 8), _f64(rng, 8), _f64(rng, 8),
                                                 _f64(rng, 12, 8), _f64(rng, 12), 1e-6)),
        "fused_ln_mlp": (TMLP.fused_ln_mlp, (_f64(rng, 2, 3, 8), _f64(rng, 8), _f64(rng, 8),
                                             _f64(rng, 16, 8), _f64(rng, 16), _f64(rng, 8, 16),
                                             _f64(rng, 8), 1e-6)),
        "fused_gate_proj": (_gate_out, (_f64(rng, 2, 3, 4), _f64(rng, 2, 3, 4),
                                        _f64(rng, 2, 3, 4), _f64(rng, 8, 8), _f64(rng, 8),
                                        _f64(rng, 4, 4), _f64(rng, 4))),
        "spatial_attention_btc": (TST.spatial_attention_btc, (qkv, 8 ** -0.5)),
        "spatial_attention": (TST.spatial_attention, (qkv, 8 ** -0.5)),
        "temporal_attention_fused": (TST.temporal_attention_fused, (qkv, 2, 8 ** -0.5)),
        "temporal_attention": (TST.temporal_attention, (qkv, 4, 8 ** -0.5)),
        "fused_groupnorm": (TGN.fused_groupnorm, (_f64(rng, 2, 3, 3, 8), _f64(rng, 8),
                                                  _f64(rng, 8), 4, 1e-5, False)),
        "fused_groupnorm_residual_relu": (
            TGN.fused_groupnorm, (_f64(rng, 2, 3, 3, 8), _f64(rng, 8), _f64(rng, 8), 4, 1e-5,
                                  True, _f64(rng, 2, 3, 3, 8))),
        "skinning": (TK.skinning, (_f64(rng, 2, 7, 3), W, A)),
        "fused_attention": (TA.fused_attention, (q, k, v, 8 ** -0.5)),
        "attention_blocked": (TA.attention_blocked, (q, k, v, 8 ** -0.5)),
    }


GRADCHECK = _gradcheck_cases()


@pytest.mark.parametrize("name", list(GRADCHECK))
def test_function_gradcheck(name):
    """The Function's backward (autograd through the plain version on the
    saved inputs) against finite differences of its forward, in f64 (in
    gradcheck's fast mode: the Jacobians projected on random vectors)."""
    fn, args = GRADCHECK[name]
    out = fn(*args)
    assert type(out.grad_fn).__name__ == "_RecomputeBackward", out.grad_fn
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)
    with torch.no_grad():
        assert fn(*args).grad_fn is None


def test_gate_weights_and_views_under_grad():
    """fused_gate_proj's alpha goes out detached; fused_attention refuses to
    write into a view under grad and still does without it."""
    args = GRADCHECK["fused_gate_proj"][1]
    out, alpha = TMLP.fused_gate_proj(*args)
    assert out.requires_grad and not alpha.requires_grad
    q, k, v, scale = GRADCHECK["fused_attention"][1]
    with pytest.raises(ValueError, match="autograd"):
        TA.fused_attention(q, k, v, scale, out=torch.empty(q.shape, dtype=q.dtype))
    with torch.no_grad():
        out = torch.empty(q.shape, dtype=q.dtype)
        assert TA.fused_attention(q, k, v, scale, out=out) is out
