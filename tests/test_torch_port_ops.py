"""maed_tpu_torch's ops held against maed_tpu's on the CPU: the copied joint
tables, the SMPL files and synthetic body, geometry, SMPL, skinning (kernel
A: its plain version against the Pallas kernel), the decoder's output head
and device_normalize.

f64 cases run JAX under ``jax.enable_x64(True)`` and the port in
torch.float64, at atol 1e-9: both sides compute the same formulas, so they
differ by rounding only.
"""

import inspect
import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse
import torch

from maed_tpu.models.heads import regressor_output as j_regressor_output
from maed_tpu.ops import geometry as JG
from maed_tpu.ops import image as JI
from maed_tpu.ops import joints as JJ
from maed_tpu.ops import smpl as JS
from maed_tpu.ops.smpl_pallas import skinning as j_skinning
from maed_tpu.utils import smpl_io as JIO
from maed_tpu_torch.models.heads import regressor_output as t_regressor_output
from maed_tpu_torch.ops import geometry as TG
from maed_tpu_torch.ops import image as TI
from maed_tpu_torch.ops import joints as TJ
from maed_tpu_torch.ops import smpl as TS
from maed_tpu_torch.ops import skinning as TK
from maed_tpu_torch.utils import smpl_io as TIO
from torch_port_common import assert_close, to_torch

ATOL64 = 1e-9


def random_rotmats(rng, n):
    """Random rotations plus the 180-degree turns about each axis, so that
    every case of rotmat_to_quat is taken."""
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    flips = np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    return np.concatenate([q, flips, np.eye(3)[None]]).astype(np.float64)


def test_joint_tables_equal_the_originals():
    for name in ("JOINT_MAP", "JOINT_NAMES", "JOINT_SELECT", "VERTEX_JOINT_IDS",
                 "SMPL_PARENTS", "H36M_TO_J17", "H36M_TO_J14", "H36M_TO_MPII3D", "OP_TO_J14",
                 "J49_TO_J14", "J49_TO_MPII3D", "J49_TO_H36M", "REGRESSOR_DICT", "JID_DICT"):
        assert getattr(TJ, name) == getattr(JJ, name), name
    np.testing.assert_array_equal(TI.IMAGENET_MEAN, JI.IMAGENET_MEAN)
    np.testing.assert_array_equal(TI.IMAGENET_STD, JI.IMAGENET_STD)


def assert_same_smpl(t_model, j_model):
    for field in TS.SMPLModel._fields:
        got, want = getattr(t_model, field), getattr(j_model, field)
        if field == "parents":
            assert got == want
        else:
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=field)


def test_entry_points_default_to_the_card():
    """The body-model loaders and the model builder place their tensors on the
    card unless the caller asks for another device (``Evaluator`` takes its
    device from the body model), as the port's entry points do."""
    from maed_tpu_torch.core.builder import build_eval_model

    for fn in (TIO.load_smpl_model, TIO.synthetic_smpl_model, TIO.find_smpl_model,
               TS.make_model, build_eval_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


@pytest.mark.parametrize("num_verts, seed", [(64, 0), (6890, 3)])
def test_synthetic_smpl_is_identical(num_verts, seed):
    assert_same_smpl(TIO.synthetic_smpl_model(num_verts, seed, device="cpu"),
                     JIO.synthetic_smpl_model(num_verts, seed))


def test_smpl_files_load_as_in_jax(tmp_path, capsys):
    rng = np.random.RandomState(0)
    V = 50
    data = {
        "v_template": rng.randn(V, 3), "shapedirs": rng.randn(V, 3, 10),
        "posedirs": rng.randn(V, 3, 207), "weights": rng.rand(V, 24),
        "J_regressor": scipy.sparse.csc_matrix(rng.rand(24, V)),
        "f": rng.randint(0, V, (20, 3)),
    }
    with open(tmp_path / "SMPL_NEUTRAL.pkl", "wb") as f:
        pickle.dump(data, f)
    np.save(tmp_path / "J_regressor_extra.npy", rng.rand(9, V))
    loaded = TIO.find_smpl_model(str(tmp_path), allow_synthetic=False, device="cpu")
    assert_same_smpl(loaded, JIO.load_smpl_model(str(tmp_path)))

    missing = str(tmp_path / "absent")
    with pytest.raises(FileNotFoundError):
        TIO.find_smpl_model(missing, allow_synthetic=False, device="cpu")
    fallback = TIO.find_smpl_model(missing, device="cpu")
    assert "SYNTHETIC" in capsys.readouterr().err
    assert_same_smpl(fallback, JIO.synthetic_smpl_model(num_verts=6890))


def _geometry_cases(rng):
    joints = rng.randn(3, 49, 3) * 0.3
    cam = np.concatenate([0.5 + rng.rand(3, 1), 0.2 * rng.randn(3, 2)], axis=1)
    quats = rng.randn(6, 4)
    quats[0, 1:] = 0.0          # sin_sq == 0: the small-angle branch
    quats[1, 0] = -abs(quats[1, 0])  # cos_theta < 0
    rot = random_rotmats(rng, 5)
    bad = np.concatenate([rot, np.full((1, 3, 3), np.nan)])  # NaN maps to 0
    points = rng.randn(2, 7, 3)
    trans = np.array([[0.1, -0.2, 5.0], [0.0, 0.3, 7.0]])
    center = rng.randn(2, 2)
    return {
        "quat_to_rotmat": ((rng.randn(5, 7, 4),), {}),
        "rodrigues": ((np.concatenate([rng.randn(5, 3), np.zeros((1, 3))]),), {}),
        "rotmat_to_quat": ((rot,), {}),
        "quat_to_aa": ((quats,), {}),
        "rotmat_to_aa": ((bad,), {}),
        "rot6d_to_rotmat": ((rng.randn(4, 24 * 6),), {}),
        "perspective_projection": ((points, trans), {"focal_length": 1000.0}),
        "perspective_projection_rotated": ((points, trans, 1000.0, center, rot[:2]), {}),
        "weak_perspective_projection": ((joints, cam), {}),
    }


@pytest.mark.parametrize("name", list(_geometry_cases(np.random.RandomState(0))))
def test_geometry_matches_jax_f64(name):
    args, kwargs = _geometry_cases(np.random.RandomState(0))[name]
    fn = name.replace("_rotated", "")
    with jax.enable_x64(True):
        want = getattr(JG, fn)(*(jnp.asarray(a) for a in args), **kwargs)
    got = getattr(TG, fn)(*(to_torch(a) for a in args), **kwargs)
    assert got.dtype == torch.float64
    assert_close(got, want, ATOL64, what=name)


def _smpl_inputs(rng, B=3):
    betas = rng.randn(B, 10) * 0.5
    rotmats = random_rotmats(rng, B * 24)[: B * 24].reshape(B, 24, 3, 3)
    return betas, rotmats


@pytest.mark.parametrize("piece", ["blend_shapes", "vertices2joints", "batch_rigid_transform",
                                   "lbs", "smpl_forward_rotmats", "smpl_forward_axis_angle"])
def test_smpl_matches_jax_f64(piece):
    rng = np.random.RandomState(1)
    betas, rotmats = _smpl_inputs(rng)
    j_model = JIO.synthetic_smpl_model(64, 0)
    t_model = TIO.synthetic_smpl_model(64, 0, device="cpu")
    verts = rng.randn(3, 64, 3)
    joints = rng.randn(3, 24, 3)
    aa = rng.randn(3, 72) * 0.4
    with jax.enable_x64(True):
        J = jnp.asarray
        want = {
            "blend_shapes": lambda: JS.blend_shapes(J(betas), j_model.shapedirs),
            "vertices2joints": lambda: JS.vertices2joints(j_model.J_regressor, J(verts)),
            "batch_rigid_transform": lambda: JS.batch_rigid_transform(
                J(rotmats), J(joints), j_model.parents),
            "lbs": lambda: JS.lbs(j_model, J(betas), J(rotmats)),
            "smpl_forward_rotmats": lambda: JS.smpl_forward(
                j_model, J(betas), pose_rotmats=J(rotmats)),
            "smpl_forward_axis_angle": lambda: JS.smpl_forward(
                j_model, J(betas), pose_axis_angle=J(aa)),
        }[piece]()
    T = to_torch
    got = {
        "blend_shapes": lambda: TS.blend_shapes(T(betas), t_model.shapedirs.double()),
        "vertices2joints": lambda: TS.vertices2joints(t_model.J_regressor.double(), T(verts)),
        "batch_rigid_transform": lambda: TS.batch_rigid_transform(
            T(rotmats), T(joints), t_model.parents),
        "lbs": lambda: TS.lbs(t_model, T(betas), T(rotmats)),
        "smpl_forward_rotmats": lambda: TS.smpl_forward(
            t_model, T(betas), pose_rotmats=T(rotmats)),
        "smpl_forward_axis_angle": lambda: TS.smpl_forward(
            t_model, T(betas), pose_axis_angle=T(aa)),
    }[piece]()
    got_leaves = list(got.values()) if isinstance(got, dict) else (
        list(got) if isinstance(got, tuple) else [got])
    want_leaves = list(want.values()) if isinstance(want, dict) else (
        list(want) if isinstance(want, tuple) else [want])
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == torch.float64
        assert_close(g, w, ATOL64, what=piece)


@pytest.mark.parametrize("B, V", [(4, 300), (2, 1111)])
def test_skinning_matches_the_pallas_kernel(B, V):
    """Kernel A's plain version (what skinning() runs for a CPU tensor)
    against the Pallas kernel, which interprets on the CPU. f32, atol 1e-5
    (m): the two sum the 24 joints in different orders."""
    rng = np.random.RandomState(2)
    v_posed = rng.randn(B, V, 3).astype(np.float32)
    W = rng.rand(V, 24).astype(np.float32)
    W /= W.sum(axis=1, keepdims=True)
    A = (rng.randn(B, 24, 4, 4) * 0.3).astype(np.float32)
    A[:, :, 3] = [0, 0, 0, 1]
    with jax.default_matmul_precision("highest"):
        want = j_skinning(jnp.asarray(v_posed), jnp.asarray(W), jnp.asarray(A))
    got = TK.skinning(to_torch(v_posed), to_torch(W), to_torch(A))
    assert_close(got, want, 1e-5)


@pytest.mark.parametrize("with_regressor", [False, True])
def test_regressor_output_matches_jax_f64(with_regressor):
    rng = np.random.RandomState(3)
    nt = 4
    pose6d, shape = rng.randn(nt, 144), rng.randn(nt, 10) * 0.5
    cam = np.concatenate([0.6 + rng.rand(nt, 1), 0.1 * rng.randn(nt, 2)], axis=1)
    jreg = rng.rand(14, 64) / 64 if with_regressor else None
    j_model = JIO.synthetic_smpl_model(64, 0)
    t_model = TIO.synthetic_smpl_model(64, 0, device="cpu")
    with jax.enable_x64(True):
        want = j_regressor_output(j_model, jnp.asarray(pose6d), jnp.asarray(shape),
                                  jnp.asarray(cam), None if jreg is None else jnp.asarray(jreg))
    got = t_regressor_output(t_model, to_torch(pose6d), to_torch(shape), to_torch(cam),
                             None if jreg is None else to_torch(jreg))
    assert set(got) == set(want)
    for key in want:
        assert_close(got[key], want[key], ATOL64, what=key)


def test_device_normalize_matches_jax():
    rng = np.random.RandomState(4)
    u8 = rng.randint(0, 256, (2, 3, 5, 5, 3)).astype(np.uint8)
    got = TI.device_normalize(to_torch(u8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JI.device_normalize(jnp.asarray(u8))))
    floats = to_torch(rng.randn(2, 4, 3))
    assert TI.device_normalize(floats) is floats


def test_kernel_wrappers_raise_without_a_kernel_for_the_device():
    """A wrapper takes the plain version only for a CPU tensor; any other
    device without a kernel raises instead of falling back."""
    from maed_tpu_torch.ops.layernorm import fast_layernorm
    from maed_tpu_torch.ops.mlp import fused_ln_mlp

    def meta(*shape):
        return torch.empty(shape, device="meta")

    with pytest.raises(ValueError, match="no kernel"):
        TK.skinning(meta(2, 8, 3), meta(8, 24), meta(2, 24, 4, 4))
    with pytest.raises(ValueError, match="no kernel"):
        fast_layernorm(meta(4, 16), meta(16), meta(16))
    with pytest.raises(ValueError, match="no kernel"):
        fused_ln_mlp(meta(4, 16), meta(16), meta(16), meta(64, 16), meta(64),
                     meta(16, 64), meta(16))
