"""maed_tpu_torch.ops.image (the on-device crop of DATASET.DEVICE_CROP) and
the host half of that mode, data.transforms.DeviceCropPack, against the JAX
package's on the CPU.

Every function of ``maed_tpu/ops/image.py`` on seeded uint8 frames, with
both warps (the separable products of axis-aligned affines and the gather
of rotated ones), at atol 1e-4 in normalized units (JAX's products at
``jax.default_matmul_precision("highest")``: its f32 dots are coarser by
default on this CPU); the affines and keypoints at 1e-6, the eval crop's
affine bit for bit. DeviceCropPack against JAX's: the frames bit for bit,
trans and kp_2d at 1e-6. Then the crop on the fixture JPEGs of
tests/torch_port_data (what chip_smoke.py crops on the card) against the
host's uint8 crop within 0.05, the JAX package's bound
(tests/test_device_preproc.py::test_device_crop_pack_schema).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maed_tpu.data import transforms as JT
from maed_tpu.ops import image as JI
from maed_tpu_torch import native
from maed_tpu_torch.data import transforms as TT
from maed_tpu_torch.ops import image as TI
from torch_port_common import assert_close, one_torch_thread, to_torch  # noqa: F401

FIXTURE_DIR = Path(__file__).resolve().parent / "torch_port_data"
T, H, W, OUT = 3, 40, 52, 24


def frames_and_affines(seed, rotated):
    """T uint8 frames (H, W, 3) and their forward crop affines: the eval
    protocol's (axis-aligned, scale 1.3 around a bbox) or, rotated, the
    train augmentation's (gen_crop_trans with a rotation)."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (T, H, W, 3)).astype(np.uint8)
    bbox = np.stack([rng.uniform([W * 0.3, H * 0.3, 18, 18], [W * 0.7, H * 0.7, 40, 40])
                     for _ in range(T)]).astype(np.float32)
    if rotated:
        trans = np.stack([TT.gen_crop_trans(b, (1.3, 1.3), float(r), (0.0, 0.0), OUT, OUT)
                          for b, r in zip(bbox, rng.uniform(-30, 30, T))]).astype(np.float32)
    else:
        trans = JI.crop_trans_for_bbox(bbox, OUT, OUT)
    return frames, trans, bbox


def jax_highest(fn, *args, **kw):
    with jax.default_matmul_precision("highest"):
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


def test_invert_affine_and_the_eval_affine_match_jax():
    for rotated in (False, True):
        _, trans, bbox = frames_and_affines(0, rotated)
        got = TI.invert_affine(to_torch(trans))
        assert_close(got, np.asarray(JI.invert_affine(jnp.asarray(trans))), 1e-6)
        # inverse of the inverse
        assert_close(TI.invert_affine(got), trans, 1e-4, 1e-5)
    np.testing.assert_array_equal(TI.crop_trans_for_bbox(bbox, OUT, 20),
                                  JI.crop_trans_for_bbox(bbox, OUT, 20))
    np.testing.assert_array_equal(TI.crop_trans_for_bbox(bbox, OUT, 20, scale=1.1),
                                  JI.crop_trans_for_bbox(bbox, OUT, 20, scale=1.1))


def test_interp_matrix_matches_jax():
    rng = np.random.RandomState(1)
    starts, steps = rng.uniform(-5, 30, 4).astype(np.float32), rng.uniform(0.3, 2, 4).astype(np.float32)
    got = TI._interp_matrix(to_torch(starts), to_torch(steps), 17, 29)
    want = np.asarray(JI._interp_matrix(jnp.asarray(starts), jnp.asarray(steps), 17, 29))
    assert got.shape == (4, 17, 29)
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("rotated", [False, True])
def test_affine_crop_normalize_matches_jax_both_warps(rotated):
    """Axis-aligned affines: the separable path (given, and inferred from the
    values); rotated ones: the gather (given, and inferred). Each against
    JAX's same path; on axis-aligned affines the two paths also agree."""
    frames, trans, _ = frames_and_affines(2, rotated)
    want = jax_highest(lambda f, m: JI.affine_crop_normalize(f, m, OUT, OUT - 4,
                                                             separable=not rotated),
                       frames, trans)
    for separable in (not rotated, None):
        got = TI.affine_crop_normalize(to_torch(frames), to_torch(trans), OUT, OUT - 4,
                                       separable=separable)
        assert got.dtype == torch.float32 and got.shape == (T, OUT, OUT - 4, 3)
        assert_close(got, want, 1e-4, what=f"separable={separable}")
    if not rotated:
        gathered = TI.affine_crop_normalize(to_torch(frames), to_torch(trans), OUT, OUT - 4,
                                            separable=False)
        want_gather = jax_highest(lambda f, m: JI.affine_crop_normalize(
            f, m, OUT, OUT - 4, separable=False), frames, trans)
        assert_close(gathered, want_gather, 1e-4)
        assert_close(gathered, want, 1e-4)
    # float frames in 0..255 take the same path as uint8
    floats = TI.affine_crop_normalize(to_torch(frames).float(), to_torch(trans), OUT, OUT - 4,
                                      separable=not rotated)
    assert_close(floats, want, 1e-4)


def test_normalize_keypoints_matches_jax():
    _, trans, _ = frames_and_affines(3, True)
    kp = np.random.RandomState(3).uniform(0, 50, (T, 49, 3)).astype(np.float32)
    got = TI.normalize_keypoints(to_torch(kp), to_torch(trans), OUT)
    want = np.asarray(JI.normalize_keypoints(jnp.asarray(kp), jnp.asarray(trans), OUT))
    assert_close(got, want, 1e-5)
    assert_close(got[..., 2], kp[..., 2], 0.0)


def test_batch_crop_normalize_and_apply_device_preproc_match_jax():
    clips = [frames_and_affines(4 + n, False) for n in range(2)]
    frames = np.stack([c[0] for c in clips])
    trans = np.stack([c[1] for c in clips])
    want = jax_highest(lambda f, m: JI.batch_crop_normalize(f, m, OUT, OUT), frames, trans)
    got = TI.batch_crop_normalize(to_torch(frames), to_torch(trans), OUT, OUT)
    assert got.shape == (2, T, OUT, OUT, 3)
    assert_close(got, want, 1e-4)
    pack = {"frames": to_torch(frames), "trans": to_torch(trans)}
    assert_close(TI.apply_device_preproc(pack, OUT, OUT), got, 0.0)
    want_pack = jax_highest(lambda f, m: JI.apply_device_preproc({"frames": f, "trans": m},
                                                                 OUT, OUT), frames, trans)
    assert_close(TI.apply_device_preproc(pack, OUT, OUT), want_pack, 1e-4)
    crops = to_torch(frames)
    assert TI.apply_device_preproc(crops, OUT, OUT) is crops  # cropped clips pass through


@pytest.mark.parametrize("as_bytes", [False, True])
def test_device_crop_pack_matches_jax(as_bytes):
    """The raw frames bit for bit (JPEG bytes: the port's decoder against
    cv2's, equal on these frames), trans and kp_2d at 1e-6, the other keys
    passed through."""
    rng = np.random.RandomState(5)
    paths = sorted(FIXTURE_DIR.glob("frame_*.jpg"))
    blobs = [p.read_bytes() for p in paths]
    clip = blobs if as_bytes else [native.decode(b) for b in blobs]
    inst = {"clip": clip, "bbox": rng.uniform([180, 130, 90, 90], [300, 230, 200, 200], (4, 4)),
            "kp_2d": rng.uniform(0, 400, (4, 49, 3)).astype(np.float32), "pose": np.ones(3)}
    got = TT.build_eval_transforms(32, 24, device_crop=True)(dict(inst))
    want = JT.build_eval_transforms(32, 24, device_crop=True)(dict(inst))
    assert set(got) == set(want)
    assert got["clip"].dtype == np.uint8 and got["clip"].shape == (4, 360, 480, 3)
    np.testing.assert_array_equal(got["clip"], want["clip"])
    assert got["trans"].dtype == np.float32
    assert_close(got["trans"], want["trans"], 1e-6)
    assert_close(got["kp_2d"], want["kp_2d"], 1e-6)
    assert got["pose"] is inst["pose"]
    with pytest.raises(ValueError, match="bboxes"):
        TT.DeviceCropPack(32, 32)({"clip": clip}, rng)
    mixed = [native.decode(blobs[0]), native.decode(blobs[1])[:, :400]]
    with pytest.raises(ValueError, match="uniform source frame sizes"):
        TT.DeviceCropPack(32, 32)({"clip": mixed, "bbox": inst["bbox"][:2]}, rng)


def test_device_crop_of_the_fixture_frames_is_the_host_crop():
    """What chip_smoke.py checks on the card, here on the CPU at a smaller
    crop: the fixture JPEGs cropped by the separable warp from the pack
    against the default path's host uint8 crop (the native library, then
    device_normalize), within 0.05."""
    rng = np.random.RandomState(6)
    clip = [native.decode(p.read_bytes()) for p in sorted(FIXTURE_DIR.glob("frame_*.jpg"))]
    inst = {"clip": clip, "bbox": rng.uniform([180, 130, 120, 120], [300, 230, 220, 220], (4, 4))}
    pack = TT.build_eval_transforms(56, 56, device_crop=True)(dict(inst))
    host = TT.build_eval_transforms(56, 56, device_normalize=True)(dict(inst))["clip"]
    got = TI.apply_device_preproc({"frames": to_torch(pack["clip"][None]),
                                   "trans": to_torch(pack["trans"][None])}, 56, 56)[0]
    want = TI.device_normalize(to_torch(host))
    err = (got - want).abs().max().item()
    assert got.shape == want.shape == (4, 56, 56, 3)
    assert err < 0.05, err
