"""The port's eval protocol against the JAX package's, on the CPU: Procrustes
alignment, the metrics, the sequence merge and interpolation, the regressor
loading, and the windowed ``Evaluator`` over the tiny MAED.

``batch_similarity_transform`` and ``eval_metrics`` in f64 (JAX under
``jax.enable_x64(True)``) at atol 1e-9. The Evaluators: with a forward that
echoes the frame index the accumulators are equal bit for bit (host numpy on
both sides); with the tiny coupling model on each side (1 block, 2 heads, KTD
hidden 32, 32 px, a 64-vertex body, JAX weights carried over) in f32 the
accumulators agree at atol 1e-3, rtol 1e-3 (at random weights either side's
f32 theta and rotmat lie up to 1e-3 from the f64 answer: see
tests/test_torch_port_modes.py), and the five metrics, means over joints and
frames of distances between such points, at 0.1 mm + 1e-3 relative.
"""

import functools
from types import SimpleNamespace

import joblib
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.core import config as j_config
from maed_tpu.core import evaluate as JE
from maed_tpu.models import MAED as JMAED
from maed_tpu.ops import metrics as JM
from maed_tpu.ops.image import apply_device_preproc as j_apply_device_preproc
from maed_tpu.ops import smpl as JS
from maed_tpu.ops.procrustes import batch_similarity_transform as j_similarity
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch.core import evaluate as TE
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.ops import metrics as TM
from maed_tpu_torch.ops.image import apply_device_preproc, device_normalize
from maed_tpu_torch.ops.joints import H36M_TO_J14, J49_TO_J14
from maed_tpu_torch.ops.procrustes import batch_similarity_transform as t_similarity
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import random_params
from torch_port_common import assert_close, one_torch_thread, to_torch  # noqa: F401

METRICS = ("mpjpe", "pa-mpjpe", "pve", "accel", "accel_err")


# ------------------------------------------------------ Procrustes, metrics

def point_sets(seed, n=6, k=14):
    """Point sets S1, S2 (n, k, 3): a similarity transform of S1 plus noise;
    set 1 mirrored, so that the best orthogonal map is a reflection and the
    sign fix is taken; set 2 nearly planar."""
    rng = np.random.RandomState(seed)
    S1 = rng.randn(n, k, 3)
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    S2 = 1.7 * S1 @ q + rng.randn(n, 1, 3) + 0.05 * rng.randn(n, k, 3)
    S2[1] = S1[1] * np.array([1.0, 1.0, -1.0]) + 0.01 * rng.randn(k, 3)
    S1[2, :, 2] *= 1e-3
    return S1, S2


def test_batch_similarity_transform_matches_jax_f64():
    S1, S2 = point_sets(0)
    with jax.enable_x64(True):
        want = np.asarray(j_similarity(jnp.asarray(S1), jnp.asarray(S2)))
        K = np.einsum("bni,bnj->bij", S1 - S1.mean(1, keepdims=True), S2 - S2.mean(1, keepdims=True))
    U, _, Vh = np.linalg.svd(K)
    assert np.linalg.det(U @ Vh)[1] < 0 < np.linalg.det(U @ Vh)[0]  # set 1 needs the sign fix
    got = t_similarity(to_torch(S1), to_torch(S2))
    assert got.dtype == torch.float64 and got.shape == S1.shape
    assert_close(got, want, 1e-9)
    # a similarity transform of S1 (a proper rotation) is recovered exactly
    rot = np.linalg.qr(np.random.RandomState(1).randn(3, 3))[0]
    rot[:, 0] *= np.linalg.det(rot)
    exact = 0.5 * S1 @ rot + 2.0
    assert_close(t_similarity(to_torch(S1), to_torch(exact)), exact, 1e-9)


def test_batch_similarity_transform_of_a_constant_set_is_nan_as_in_jax():
    S1, S2 = point_sets(2, n=3)
    S1[1] = 0.25  # exactly representable, so the variance is exactly 0: the scale is 0 / 0
    with jax.enable_x64(True):
        want = np.asarray(j_similarity(jnp.asarray(S1), jnp.asarray(S2)))
    got = t_similarity(to_torch(S1), to_torch(S2)).numpy()
    assert np.isnan(want[1]).all() and np.isnan(got[1]).all()
    assert_close(got[[0, 2]], want[[0, 2]], 1e-9)


@pytest.mark.parametrize("with_vis", [False, True])
def test_eval_metrics_match_jax_f64(with_vis):
    """With ``vis``: joint 5 invisible in frames 1 and 3, joint 0 everywhere;
    the invisible joints leave the per-frame mean (select semantics)."""
    pred, target = point_sets(3, n=7)
    vis = None
    if with_vis:
        vis = np.ones((7, 14, 1))
        vis[[1, 3], 5] = 0.0
        vis[:, 0] = 0.0
    with jax.enable_x64(True):
        want = JM.eval_metrics(jnp.asarray(pred), jnp.asarray(target),
                               None if vis is None else jnp.asarray(vis))
        want = {k: np.asarray(v) for k, v in want.items()}
        want_pve = np.asarray(JM.vert_error(jnp.asarray(pred), jnp.asarray(target)))
        want_pa = np.asarray(JM.pa_mpjpe(jnp.asarray(pred), jnp.asarray(target)))
        want_mp = np.asarray(JM.mpjpe(jnp.asarray(pred), jnp.asarray(target)))
    got = TM.eval_metrics(to_torch(pred), to_torch(target), None if vis is None else to_torch(vis))
    assert set(got) == set(want) == {"mpjpe", "pa_mpjpe", "accel", "accel_err"}
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert_close(got[key], want[key], 1e-9, what=key)
    assert_close(TM.vert_error(to_torch(pred), to_torch(target)), want_pve, 1e-9)
    assert_close(TM.pa_mpjpe(to_torch(pred), to_torch(target)), want_pa, 1e-9)
    assert_close(TM.mpjpe(to_torch(pred), to_torch(target)), want_mp, 1e-9)
    if with_vis:
        # an error on an invisible joint changes nothing
        moved = pred.copy()
        moved[1, 5] += 0.4
        again = TM.eval_metrics(to_torch(moved), to_torch(target), to_torch(vis))
        assert_close(again["mpjpe"], got["mpjpe"], 1e-12)


# ----------------------------------------------------- host-side sequences

def test_merge_and_interpolate_equal_jax():
    rng = np.random.RandomState(4)
    clips = [rng.randn(3, 4, 5, 2) for _ in range(4)]
    merged = TE.merge_sequence(clips)
    np.testing.assert_array_equal(merged, JE.merge_sequence(clips))
    assert merged.shape == (48, 5, 2)
    np.testing.assert_array_equal(merged[:16:4], clips[0][0])
    seq = rng.randn(24, 7)
    assert TE.interpolate_sequence(seq, 8, 8) is seq
    for orig, interp in ((16, 8), (15, 8), (12, 4)):
        got = TE.interpolate_sequence(seq, orig, interp)
        np.testing.assert_array_equal(got, JE.interpolate_sequence(seq, orig, interp))
        assert got.shape == (24 // interp * orig, 7)


def test_load_eval_regressor_required_semantics(tmp_path, capsys):
    with pytest.raises(FileNotFoundError, match="J_regressor_h36m"):
        TE.load_eval_regressor("3dpw", data_dir=str(tmp_path))
    assert TE.load_eval_regressor("3dpw", data_dir=str(tmp_path), allow_missing=True) is None
    assert "NOT comparable" in capsys.readouterr().err
    assert TE.load_eval_regressor("mpii3d", data_dir=str(tmp_path)) is None
    assert TE.load_eval_regressor("testset", data_dir=str(tmp_path)) is None
    jreg = np.abs(np.random.RandomState(5).rand(17, 99))
    np.save(tmp_path / "J_regressor_h36m.npy", jreg)
    got = TE.load_eval_regressor("h36m", data_dir=str(tmp_path))
    assert got.dtype == np.float32 and got.shape == (17, 99)
    np.testing.assert_array_equal(got, JE.load_eval_regressor("h36m", data_dir=str(tmp_path)))
    assert TE.DATA_DIR == j_config.DATA_DIR


# ----------------------------------------------------------- the Evaluator

POOL, IMG, VERTS = 8, 32, 64
N_VALID = 3 * POOL - 2 * 5  # each batch of Windows switches 2 + 3 frames off


@functools.lru_cache(maxsize=None)
def gt_body():
    """The JAX SMPL forward of the windows' GT theta, jitted once (eagerly it
    runs op by op at every window batch)."""
    smpl = j_synthetic_smpl(VERTS, 0)
    return jax.jit(lambda betas, pose: JS.smpl_forward(smpl, betas, pose_axis_angle=pose))


class Windows:
    """Two batches of POOL-frame windows, 2 and then 1 (the ragged last
    batch), uint8 frames that carry a running frame index in pixel (0, 0, 0);
    some frames are off in ``valid``; GT theta random, GT joints from the JAX
    SMPL on that theta: ``joints`` of them ('49', 'j14' through ``jreg`` and
    the protocol's selection, or 'native14' from the 49), confidence 1.
    With ``raw``, DATASET.DEVICE_CROP's windows instead: uint8 source frames
    of raw x raw and each frame's eval affine to IMG x IMG (``trans``)."""

    def __init__(self, joints, jreg=None, seed=6, raw=None):
        self.joints, self.jreg, self.seed, self.raw = joints, jreg, seed, raw

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        first = 0
        for n in (2, 1):
            images = rng.randint(0, 256, (n, POOL, IMG, IMG, 3)).astype(np.uint8)
            images[:, :, 0, 0, 0] = first + np.arange(n * POOL).reshape(n, POOL)
            theta = np.zeros((n, POOL, 85), np.float32)
            theta[..., 3:75] = rng.randn(n, POOL, 72) * 0.2
            theta[..., 75:] = rng.randn(n, POOL, 10) * 0.5
            flat = theta.reshape(-1, 85)
            out = gt_body()(jnp.asarray(flat[:, 75:]), jnp.asarray(flat[:, 3:75]))
            if self.joints == "49":
                kp = np.asarray(out["joints"])
            elif self.joints == "native14":
                kp = np.asarray(out["joints"])[:, J49_TO_J14]
            else:
                kp = np.einsum("jv,bvk->bjk", self.jreg, np.asarray(out["vertices"]))[:, H36M_TO_J14]
            kp = kp.reshape(n, POOL, -1, 3).astype(np.float32)
            kp3d = np.concatenate([kp, np.ones(kp.shape[:-1] + (1,), np.float32)], axis=-1)
            valid = np.ones((n, POOL), bool)
            valid[0, :2] = False
            valid[-1, -3:] = False
            batch = {"images": images, "kp_3d": kp3d, "kp_2d": kp3d[..., :3].copy(),
                     "theta": theta, "valid": valid,
                     "instance_id": first + np.arange(n * POOL).reshape(n, POOL),
                     "bbox": rng.rand(n, POOL, 4).astype(np.float32)}
            if self.raw:
                batch["images"] = rng.randint(0, 256, (n, POOL, self.raw, self.raw, 3)
                                              ).astype(np.uint8)
                batch["trans"] = exact_crops(rng, (n, POOL), self.raw)
            yield batch
            first += n * POOL


def exact_crops(rng, lead, raw):
    """Axis-aligned crop affines to IMG x IMG whose warp every side computes
    exactly: scale 0.5, 1 or 2 and a source offset of whole pixels, so every
    bilinear tap weight is 0, 0.5 or 1 and every sum of taps is exact. Then
    the two packages' forwards see the same crops, and the protocol is held
    as tightly as on cropped clips (the warps' own f32 rounding, which the
    random-weight model would amplify, is held in
    tests/test_torch_port_image.py)."""
    scale = rng.choice([0.5, 1.0, 2.0], lead)
    span = raw - IMG / scale  # room for the source window
    offset = np.floor(rng.rand(2, *lead) * (span + 1))
    trans = np.zeros(lead + (2, 3), np.float32)
    trans[..., 0, 0] = trans[..., 1, 1] = scale
    trans[..., 0, 2], trans[..., 1, 2] = -offset * scale
    return trans


def echo(images, xp):
    """A forward whose outputs all carry the frame index of pixel (0, 0, 0)."""
    N, T = images.shape[:2]
    fid = images[:, :, 0, 0, 0].astype(xp.float32) if xp is jnp else images[:, :, 0, 0, 0].float()

    def mk(shape):
        lead = fid.reshape((N, T) + (1,) * len(shape))
        return (jnp.broadcast_to(lead, (N, T) + shape) if xp is jnp
                else lead.expand((N, T) + shape))

    return {"verts": mk((VERTS, 3)), "kp_3d": mk((49, 3)), "kp_2d": mk((49, 2)),
            "theta": mk((85,)), "rotmat": mk((24, 3, 3))}


def concatenated(evaluator):
    return {k: np.concatenate(v, axis=0) for k, v in evaluator.accumulators.items()}


@pytest.mark.parametrize("interp", [1, 2])
def test_evaluator_reassembles_windows_as_jax(interp):
    """Striding, padding of the ragged batch to batch_size 2 and its removal,
    re-interleaving, interpolation, the valid mask and the side accumulators,
    with an echo forward: equal to JAX's bit for bit."""
    kw = dict(seqlen=2, interp=interp, dataset_name="testset", batch_size=2, verbose=False)
    j_ev = JE.Evaluator(j_synthetic_smpl(VERTS, 0))
    t_ev = TE.Evaluator(t_synthetic_smpl(VERTS, 0, device="cpu"))
    shapes = []
    j_ev.inference(lambda x, jreg: echo(x, jnp), Windows("49"), **kw)

    def t_forward(x, jreg):
        shapes.append(tuple(x.shape))
        assert jreg is None and x.dtype == torch.uint8 and x.is_contiguous()
        return echo(x, torch)

    t_ev.inference(t_forward, Windows("49"), **kw)
    sample_freq = POOL // interp // 2
    assert shapes == [(2, 2, IMG, IMG, 3)] * (2 * sample_freq)
    want, got = concatenated(j_ev), concatenated(t_ev)
    assert set(got) == set(want) >= {"pred_verts", "pred_j3d", "pred_j2d", "pred_theta",
                                     "pred_rotmat", "target_j3d", "target_j2d", "target_theta",
                                     "instance_id", "bboxes"}
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["pred_theta"]) == N_VALID
    if interp == 1:
        np.testing.assert_array_equal(got["pred_theta"][:, 0], got["instance_id"])


CONFIG = dict(num_blocks=1, num_heads=2, hidden_dim=32)


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny coupling MAED on both sides with the same weights: the JAX one
    as ``(apply(variables, images, J_regressor), variables)``, the Evaluator's
    contract that jits the forward once for every call of its shapes (the
    weights are arguments, not constants baked into each executable), the
    port's as a forward ``(images, J_regressor) -> dict``."""
    x = np.zeros((2, 2, IMG, IMG, 3), np.float32)
    j_smpl, t_smpl = j_synthetic_smpl(VERTS, 0), t_synthetic_smpl(VERTS, 0, device="cpu")
    j_model = JMAED(encoder="ste", st_mode="coupling", decoder="ktd", **CONFIG)
    params = random_params(lambda: j_model.init(jax.random.PRNGKey(0), x, j_smpl), 0)
    t_model = MAED(img_size=IMG, st_mode="coupling", **CONFIG)
    t_model.load_state_dict(state_dict_from_jax(params), strict=True)

    def j_apply(variables, images, jreg):
        with jax.default_matmul_precision("highest"):
            return j_model.apply(variables, images, j_smpl, J_regressor=jreg)

    return ((j_apply, {"params": params}), j_smpl), \
        (lambda images, jreg: t_model(images, t_smpl, J_regressor=jreg), t_smpl)


@pytest.fixture(scope="module")
def j_evaluator(tiny_models):
    """One JAX Evaluator for every case, as a training run keeps one for its
    validations: its jitted forward and GT-vertex rebuild compile once per
    shape, not once per case."""
    (_, j_smpl), _ = tiny_models
    return JE.Evaluator(j_smpl)


def regressor17(seed=7):
    jreg = np.random.RandomState(seed).rand(17, VERTS)
    return (jreg / jreg.sum(axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case, interp", [("j14", 1), ("j14", 2), ("native14", 1), ("49", 1),
                                         ("j14_device_crop", 1)])
def test_evaluator_run_matches_jax(tiny_models, j_evaluator, tmp_path, monkeypatch, capsys,
                                   case, interp):
    """``Evaluator.run`` on both sides over the same windows (ragged last
    batch, a valid mask): '3dpw' with an h36m-style (17, V) regressor and the
    J14 selection, at interp 1 and 2; '3dpw' without its regressor file
    (``allow_missing_regressor``) and a 14-joint GT, which takes the native
    bank's J49_TO_J14; a dataset without a protocol and the 49-joint GT.
    'j14_device_crop': the 'j14' protocol over DEVICE_CROP windows (72 x 72
    raw frames and their affines, :func:`exact_crops`), each side's forward
    cropping on its device as the CLIs do (JAX's at the highest matmul
    precision)."""
    ((j_apply, variables), _), (t_forward, t_smpl) = tiny_models
    monkeypatch.setattr(j_config, "DATA_DIR", str(tmp_path))  # no regressor file there
    crop = case == "j14_device_crop"
    case = "j14" if crop else case
    jreg = regressor17() if case == "j14" else None
    kw = dict(seqlen=2, interp=interp, batch_size=2, verbose=False, J_regressor=jreg,
              dataset_name="testset" if case == "49" else "3dpw",
              allow_missing_regressor=case == "native14")
    if crop:
        def j_forward(variables, pack, jreg):
            with jax.default_matmul_precision("highest"):
                images = j_apply_device_preproc(pack, IMG, IMG)
            return j_apply(variables, images, jreg)

        def forward(pack, jreg):
            return t_forward(apply_device_preproc(pack, IMG, IMG), jreg)
    else:
        j_forward, forward = j_apply, t_forward
    j_ev, t_ev = j_evaluator, TE.Evaluator(t_smpl)
    raw = 72 if crop else None
    want_metrics, want_n = j_ev.run(j_forward, Windows(case, jreg, raw=raw), variables=variables,
                                    **kw)
    got_metrics, got_n = t_ev.run(forward, Windows(case, jreg, raw=raw), data_dir=str(tmp_path),
                                  **kw)
    if case == "native14":
        assert "NOT comparable" in capsys.readouterr().err
    assert got_n == want_n == N_VALID
    want, got = concatenated(j_ev), concatenated(t_ev)
    assert set(got) == set(want)
    assert got["pred_j3d"].shape == (got_n, 49 if case == "49" else 14, 3)
    assert got["pred_verts"].shape == (got_n, VERTS, 3)
    for key in want:
        assert got[key].shape == want[key].shape, key
        if key.startswith("pred_"):
            assert_close(got[key], want[key], 1e-3, 1e-3, what=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tuple(got_metrics) == tuple(want_metrics) == METRICS
    for key in METRICS:
        assert np.isfinite(got_metrics[key]) and got_metrics[key] > 0
        assert_close(got_metrics[key], want_metrics[key], 0.1, 1e-3, what=key)


def test_evaluator_gt_verts_match_jax(tiny_models, j_evaluator):
    _, (_, t_smpl) = tiny_models
    rng = np.random.RandomState(8)
    theta = np.zeros((7, 85), np.float32)
    theta[:, 3:] = rng.randn(7, 82) * 0.3
    want = j_evaluator._gt_verts(theta)
    got = TE.Evaluator(t_smpl)._gt_verts(theta)
    assert got.shape == (7, VERTS, 3)
    assert_close(got, want, 1e-5)


def test_evaluator_errors_and_what_is_not_ported(tiny_models, tmp_path):
    (_, _), (t_forward, t_smpl) = tiny_models
    ev = TE.Evaluator(t_smpl)
    windows = list(Windows("49"))
    # a DEVICE_CROP pack runs through the protocol: the forward is handed
    # {'frames', 'trans'} sub-clips, crops them (here a full-frame identity
    # crop) and answers as it does on the cropped clips
    packs = []

    def crop_forward(pack, jreg):
        packs.append({k: tuple(v.shape) for k, v in pack.items()})
        return t_forward(apply_device_preproc(pack, IMG, IMG), jreg)

    identity = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (2, POOL, 1, 1))
    ev.inference(crop_forward, [dict(windows[0], trans=identity)], seqlen=2,
                 dataset_name="testset", verbose=False)
    assert packs == [{"frames": (2, 2, IMG, IMG, 3), "trans": (2, 2, 2, 3)}] * (POOL // 2)
    via_pack = concatenated(ev)
    ev.inference(lambda x, jreg: t_forward(device_normalize(x), jreg), [windows[0]], seqlen=2,
                 dataset_name="testset", verbose=False)
    cropped = concatenated(ev)
    assert set(via_pack) == set(cropped)
    for key in cropped:
        assert_close(via_pack[key], cropped[key], 1e-5, what=key)
    assert ev.sync_metrics({"mpjpe": 1.0}, 3) == ({"mpjpe": 1.0}, 3)
    # GT-free input: predictions accumulate, evaluate has nothing to score
    blind = dict(windows[0])
    blind["kp_3d"] = blind["kp_3d"] * np.array([1, 1, 1, 0], np.float32)
    ev.inference(lambda x, jreg: echo(x, torch), [blind], seqlen=2, dataset_name="testset",
                 verbose=False)
    assert "pred_verts" in ev.accumulators and "target_j3d" not in ev.accumulators
    # the predictions are saved all the same
    ev.save_result(str(tmp_path))
    saved = joblib.load(tmp_path / "inference.pkl")
    assert saved["pred_verts"].shape == np.concatenate(ev.accumulators["pred_verts"]).shape
    with pytest.raises(RuntimeError, match="no ground truth"):
        ev.evaluate()
    # GT presence must not flip between batches
    with pytest.raises(RuntimeError, match="lost GT joints"):
        ev.inference(lambda x, jreg: echo(x, torch), [windows[0], blind], seqlen=2,
                     dataset_name="testset", verbose=False)
    # a 3dpw GT of 20 joints has no mapping from the native bank
    odd = dict(windows[0], kp_3d=np.ones((2, POOL, 20, 4), np.float32))
    with pytest.raises(ValueError, match="no J49 mapping"):
        ev.inference(lambda x, jreg: echo(x, torch), [odd], seqlen=2, dataset_name="3dpw",
                     verbose=False, allow_missing_regressor=True, data_dir="absent")


def test_count_attn_returns_the_parallel_gates(tiny_models):
    """The parallel mode's gate toward the spatial branch per block, as the JAX
    Evaluator reads it from the sown intermediates (f32 behind the whole stem:
    1e-4, the f32 bound of tests/test_torch_port_slice.py); another mode has
    none. The JAX model's apply is handed over jitted: eagerly it runs op by
    op, its Pallas kernels interpreted."""
    j_smpl, t_smpl = j_synthetic_smpl(VERTS, 0), t_synthetic_smpl(VERTS, 0, device="cpu")
    clips = np.random.RandomState(9).randn(1, 2, IMG, IMG, 3).astype(np.float32)
    j_model = JMAED(encoder="ste", st_mode="parallel", decoder="ktd", **CONFIG)
    params = random_params(lambda: j_model.init(jax.random.PRNGKey(0), clips, j_smpl), 1)
    def apply(variables, images):
        with jax.default_matmul_precision("highest"):  # at trace time, inside the jit
            return j_model.apply(variables, images, j_smpl, mutable=["intermediates"])

    apply = jax.jit(apply)
    jitted = SimpleNamespace(
        apply=lambda variables, images, smpl, mutable: apply(variables, images))
    want = JE.Evaluator(j_smpl).count_attn(jitted, {"params": params}, clips, j_smpl, 2)
    t_model = MAED(img_size=IMG, st_mode="parallel", **CONFIG)
    t_model.load_state_dict(state_dict_from_jax(params), strict=True)
    ev = TE.Evaluator(t_smpl)
    got = ev.count_attn(t_model, to_torch(clips), t_smpl)
    assert list(got) == list(want) == ["encoder/blocks_0/attn"]
    assert got["encoder/blocks_0/attn"].shape == (2, 768)
    assert_close(got["encoder/blocks_0/attn"], want["encoder/blocks_0/attn"], 1e-4)
    coupling = MAED(img_size=IMG, st_mode="coupling", **CONFIG)
    assert ev.count_attn(coupling, to_torch(clips), t_smpl) == {}
