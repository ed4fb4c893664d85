"""maed_tpu_torch.core.loss against maed_tpu.core.loss on the CPU, in f64
(JAX under ``jax.enable_x64(True)``) at atol 1e-12: every loss function,
on the same numpy inputs made from a seed. The SMPL losses with a w_smpl
that zeroes rows, the video loss with and without 2D clips (n2d > 0 and
n2d = 0) and with the acceleration term, the image loss with and without
kp_3d, the merge, and the adversarial and smoothness losses the recipe does
not use. Pure functions: no model, no jit."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from maed_tpu.core import loss as JL
from maed_tpu_torch.core import loss as TL
from torch_port_common import assert_close, to_torch

ATOL = 1e-12


def _kp(rng, *shape, conf_last=True):
    a = rng.randn(*shape)
    if conf_last:
        a[..., -1] = rng.rand(*shape[:-1])
    return a


def _both(fn_j, fn_t, *arrays, **kw):
    """(JAX result, port result) of the same function on the same arrays."""
    with jax.enable_x64(True):
        want = fn_j(*(None if a is None else jnp.asarray(a) for a in arrays), **kw)
        want = jax.tree.map(np.asarray, want)
    got = fn_t(*(None if a is None else to_torch(a) for a in arrays), **kw)
    return want, got


def _assert_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], want[k], ATOL, what=k)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree(g, w)
    else:
        assert_close(got, want, ATOL)


@pytest.mark.parametrize("shape", [(3, 4, 49, 3), (5, 49, 3)])
def test_keypoint_losses(shape):
    rng = np.random.RandomState(0)
    pred2, gt2 = rng.randn(*shape[:-1], 2), _kp(rng, *shape)
    _assert_tree(*reversed(_both(JL.keypoint_2d_loss, TL.keypoint_2d_loss, pred2, gt2)))
    pred3, gt3 = rng.randn(*shape), _kp(rng, *shape[:-1], 4)
    _assert_tree(*reversed(_both(JL.keypoint_3d_loss, TL.keypoint_3d_loss, pred3, gt3)))


@pytest.mark.parametrize("mask", ["none", "ones", "some_zero", "all_zero"])
def test_smpl_losses(mask):
    rng = np.random.RandomState(1)
    pp, pg = rng.randn(2, 3, 72) * 0.5, rng.randn(2, 3, 72) * 0.5
    sp, sg = rng.randn(2, 3, 10), rng.randn(2, 3, 10)
    w = {"none": None, "ones": np.ones((2, 3)),
         "some_zero": np.array([[1.0, 0.0, 1.0], [0.0, 0.0, 1.0]]),
         "all_zero": np.zeros((2, 3))}[mask]
    want, got = _both(JL.smpl_losses, TL.smpl_losses, pp, sp, pg, sg, w)
    _assert_tree(got, want)


def test_accl_theta_norm_and_smooth_losses():
    rng = np.random.RandomState(2)
    pred, gt = rng.randn(2, 6, 49, 3), _kp(rng, 2, 6, 49, 4)
    theta = rng.randn(2, 6, 85)
    for fj, ft, args in ((JL.accl_loss, TL.accl_loss, (pred, gt)),
                         (JL.theta_norm_loss, TL.theta_norm_loss, (theta,)),
                         (JL.smooth_pose_loss, TL.smooth_pose_loss, (theta,)),
                         (JL.smooth_shape_loss, TL.smooth_shape_loss, (theta,))):
        want, got = _both(fj, ft, *args)
        _assert_tree(got, want)


def test_adversarial_losses():
    rng = np.random.RandomState(3)
    real, fake = rng.randn(5, 1), rng.randn(5, 1)
    for fj, ft, args in ((JL.encoder_disc_l2_loss, TL.encoder_disc_l2_loss, (fake,)),
                         (JL.adv_disc_l2_loss, TL.adv_disc_l2_loss, (real, fake)),
                         (JL.encoder_disc_wasserstein_loss, TL.encoder_disc_wasserstein_loss,
                          (fake,)),
                         (JL.adv_disc_wasserstein_loss, TL.adv_disc_wasserstein_loss,
                          (real, fake))):
        want, got = _both(fj, ft, *args)
        _assert_tree(got, want)


def _preds(rng, n, T):
    return {"kp_2d": rng.randn(n, T, 49, 2), "kp_3d": rng.randn(n, T, 49, 3),
            "theta": rng.randn(n, T, 85) * 0.5}


def _as(tree, convert):
    return {k: _as(v, convert) if isinstance(v, dict) else convert(v) for k, v in tree.items()}


def _loss_both(fn_j, fn_t, *trees, weights):
    with jax.enable_x64(True):
        want = fn_j(*(None if t is None else _as(t, jnp.asarray) for t in trees),
                    JL.LossWeights(*weights))
        want = jax.tree.map(np.asarray, want)
    got = fn_t(*(None if t is None else _as(t, to_torch) for t in trees),
               TL.LossWeights(*weights))
    return want, got


@pytest.mark.parametrize("n2d", [0, 2])
@pytest.mark.parametrize("accl", [0.0, 0.5])
def test_video_loss(n2d, accl):
    rng = np.random.RandomState(4 + n2d)
    n3d, T = 3, 5
    w_smpl = np.ones((n3d, T))
    w_smpl[1, 2:] = 0.0
    data_3d = {"kp_2d": _kp(rng, n3d, T, 49, 3), "kp_3d": _kp(rng, n3d, T, 49, 4),
               "theta": rng.randn(n3d, T, 85) * 0.5, "w_smpl": w_smpl}
    data_2d = {"kp_2d": _kp(rng, n2d, T, 49, 3)} if n2d else None
    weights = (60.0, 30.0, 0.001, 1.0, 1.0, accl)
    want, got = _loss_both(JL.video_loss, TL.video_loss, _preds(rng, n2d + n3d, T), data_3d,
                           data_2d, weights=weights)
    assert ("loss_accl" in got[1]) == (accl > 0)
    _assert_tree(got, want)


@pytest.mark.parametrize("with_kp3d", [True, False])
def test_image_loss(with_kp3d):
    rng = np.random.RandomState(6)
    n = 4
    target = {"kp_2d": _kp(rng, n, 49, 3), "theta": rng.randn(n, 85) * 0.5,
              "w_smpl": np.zeros(n)}  # ignored for images: the SMPL losses run over every row
    if with_kp3d:
        target["kp_3d"] = _kp(rng, n, 49, 4)
    want, got = _loss_both(JL.image_loss, TL.image_loss, _preds(rng, n, 1), target,
                           weights=(60.0, 30.0, 0.001, 1.0, 1.0, 0.0))
    assert ("loss_kp_3d" in got[1]) == with_kp3d
    _assert_tree(got, want)


def test_merge_loss():
    rng = np.random.RandomState(7)
    vid = {"loss_kp_2d": rng.rand(), "loss_kp_3d": rng.rand(), "loss_accl": rng.rand()}
    img = {"loss_kp_2d": rng.rand(), "loss_norm": rng.rand()}
    with jax.enable_x64(True):
        want = JL.merge_loss(jnp.asarray(1.5), {k: jnp.asarray(v) for k, v in vid.items()},
                             jnp.asarray(2.5), {k: jnp.asarray(v) for k, v in img.items()},
                             0.75, 0.25)
        want = jax.tree.map(np.asarray, want)
    got = TL.merge_loss(torch.tensor(1.5, dtype=torch.float64),
                        {k: torch.tensor(v, dtype=torch.float64) for k, v in vid.items()},
                        torch.tensor(2.5, dtype=torch.float64),
                        {k: torch.tensor(v, dtype=torch.float64) for k, v in img.items()},
                        0.75, 0.25)
    _assert_tree(got, want)


def test_loss_weights_equal_the_jax_packages():
    assert TL.LossWeights() == tuple(JL.LossWeights())
    assert TL.LossWeights._fields == JL.LossWeights._fields
