"""maed_tpu_torch's data path against maed_tpu's on the CPU: chunks,
keypoints, the native library, transforms, datasets and loaders. Inputs
come from a numpy seed and ``tests/fixtures.py``'s synthetic DBs (JPEG
frames written by cv2).

- chunks and keypoints: exact, over every keypoint format;
- the affine of a crop: the bits of cv2.getAffineTransform;
- transforms and datasets with the same RandomState: keypoints, theta,
  flip and erase decisions and ``valid`` equal at 1e-6; the eval path's
  pixels (FusedCropNormalize, the same C++) bit for bit; the train path's
  pixels, whose crop was cv2.warpAffine in JAX and is the native crop here,
  within 0.05 after normalization, the JAX package's own bound
  (tests/test_data.py::test_fused_native_crop_matches_cv2_path);
  rotation-matrix poses against JAX's ``rotmat_to_aa`` at 1e-5;
- loaders: the batch order for (seed, epoch, rank, world) equals JAX's,
  ``iter_from(e, k)`` is the tail of ``iter(e)``, 0 and 2 workers give the
  same batches, ``InfiniteLoader.state``/``restore`` round-trips, and
  ``get_data_loaders`` gives JAX's batches;
- DBs read as plain pickles or with joblib; a joblib DB without joblib
  raises and says so;
- the fixture frames of ``tests/torch_port_data`` (what chip_smoke.py
  decodes on the card) are what :func:`make_fixture_frames` makes, and
  their stored cv2 pixels are what cv2 decodes from them.
"""

import hashlib
import pickle
import sys
from itertools import product
from pathlib import Path

import cv2
import joblib
import numpy as np
import pytest

from fixtures import make_image_db, make_video_db
from maed_tpu.core.config import get_cfg_defaults as j_cfg_defaults
from maed_tpu.data import chunks as JC
from maed_tpu.data import dataset as JD
from maed_tpu.data import keypoints as JK
from maed_tpu.data import loaders as JL
from maed_tpu.data import transforms as JT
from maed_tpu_torch import native
from maed_tpu_torch.core.config import get_cfg_defaults as t_cfg_defaults
from maed_tpu_torch.data import chunks as TC
from maed_tpu_torch.data import dataset as TD
from maed_tpu_torch.data import keypoints as TK
from maed_tpu_torch.data import loaders as TL
from maed_tpu_torch.data import transforms as TT

FIXTURE_DIR = Path(__file__).resolve().parent / "torch_port_data"
STD = np.array([0.229, 0.224, 0.225])
PIXEL_BOUND = 0.05  # after normalization: the JAX package's bound for its two crops


def make_fixture_frames(out_dir, n=4, h=360, w=480, seed=0):
    """How tests/torch_port_data was made: n frames of blurred seeded noise
    (compress-friendly, like tests/test_data.py's decode test), written by
    cv2 as JPEG at quality 95 (4:2:0), and decoded.npz with what cv2 decodes
    from them: each frame's sha256, a subsample (every 6th row and column),
    a crop box per frame and FusedCropNormalize's 112^2 crop of cv2's pixels
    (float16). chip_smoke.py holds the card's decoder to that crop."""
    rng = np.random.RandomState(seed)
    out_dir = Path(out_dir)
    frames = []
    for k in range(n):
        img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3), np.uint8), (5, 5), 2)
        ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                               [cv2.IMWRITE_JPEG_QUALITY, 95])
        assert ok
        (out_dir / f"frame_{k}.jpg").write_bytes(enc.tobytes())
        frames.append(cv2.cvtColor(cv2.imdecode(enc, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    bbox = np.stack([rng.uniform([w * 0.4, h * 0.4, 120, 120], [w * 0.6, h * 0.6, 200, 200])
                     for _ in range(n)]).astype(np.float32)
    crop = TT.FusedCropNormalize(112, 112)({"clip": frames, "bbox": bbox}, rng)["clip"]
    np.savez_compressed(out_dir / "decoded.npz",
                        sha256=np.array([hashlib.sha256(f.tobytes()).hexdigest() for f in frames]),
                        sub=np.stack([f[::6, ::6] for f in frames]), bbox=bbox,
                        crop=crop.astype(np.float16))


def cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def assert_pixels_close(got, want, bound=PIXEL_BOUND):
    """got, want: uint8 clips or normalized f32 clips."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == np.uint8:
        diff = np.abs(got.astype(np.float64) - want) / 255.0 / STD
    else:
        diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() < bound, diff.max()


def assert_items(got, want, pixels="exact"):
    """Two dataset items (or batches): every field equal at 1e-6, the
    pixels bit for bit or within the bound."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if key in ("images", "image"):
            if pixels == "exact":
                assert g.dtype == w.dtype and np.array_equal(g, w)
            else:
                assert_pixels_close(g, w)
        elif isinstance(w, np.ndarray) and w.dtype.kind in "fiub":
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=key)
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w)), key


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dbs")
    return {
        "video": make_video_db(d / "v", n_videos=2, frames_per_video=12, img_size=48, seed=0),
        "video2d": make_video_db(d / "v2", n_videos=2, frames_per_video=10, img_size=48, seed=3,
                                 with_3d=False, with_smpl=False),
        "image": make_image_db(d / "i", n_images=8, img_size=48),
    }


def dataset_cfg(mod_defaults, **overrides):
    d = mod_defaults().DATASET
    d.update(WIDTH=32, HEIGHT=32, SEQLEN=4, SAMPLE_POOL=8, RANDOM_CROP_P=0.5, ROT_JITTER=20,
             SIZE_JITTER=0.1, ERASE_PROB=0.5, ERASE_FILL=True, ERASE_KP=True, **overrides)
    return d


# --------------------------------------------------------------------------- #
# chunks, keypoints
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("seqlen, stride, pad", [(4, 2, True), (8, 8, True), (5, 1, False),
                                                 (16, 8, True)])
def test_chunks_equal_jax(seqlen, stride, pad):
    rng = np.random.RandomState(seqlen)
    names = np.repeat(np.array(["b", "a", "c", "d"]), [1, 13, 7, 20])
    assert TC.split_into_chunks(names, seqlen, stride, pad) == \
        JC.split_into_chunks(names, seqlen, stride, pad)
    pool = list(range(100, 132))
    for mode in [(True, False), (False, True), (False, False)]:
        seeds = rng.randint(1 << 30)
        assert TC.gen_sample_index(pool, 8, 4, *mode, np.random.RandomState(seeds)) == \
            JC.gen_sample_index(pool, 8, 4, *mode, np.random.RandomState(seeds))


@pytest.mark.parametrize("src", sorted(JK.JOINT_FORMATS))
def test_keypoints_equal_jax_every_format(src):
    rng = np.random.RandomState(len(src))
    assert TK.JOINT_FORMATS == JK.JOINT_FORMATS
    n = len(JK.JOINT_FORMATS[src])
    joints = rng.randn(3, n, 3)
    for dst, flip in product(sorted(JK.JOINT_FORMATS), (False, True)):
        assert np.array_equal(TK.convert_kps(joints, src, dst, flip),
                              JK.convert_kps(joints, src, dst, flip)), (dst, flip)
        assert TK.get_perm_idxs(src, dst) == JK.get_perm_idxs(src, dst)
        assert TK.get_joint_names(dst, flip) == JK.get_joint_names(dst, flip)
    kp2 = rng.rand(2, 49, 3) * 200
    assert np.array_equal(TK.keypoint_2d_hflip(kp2.copy(), 224), JK.keypoint_2d_hflip(kp2.copy(), 224))
    kp3 = rng.randn(2, 49, 4)
    assert np.array_equal(TK.keypoint_3d_hflip(kp3.copy()), JK.keypoint_3d_hflip(kp3.copy()))
    pose = rng.randn(2, 72)
    assert np.array_equal(TK.smpl_pose_hflip(pose.copy()), JK.smpl_pose_hflip(pose.copy()))
    vis = rng.rand(2, 49) > 0.3
    assert np.array_equal(TK.convert_kps_to_mask(kp2[..., :2], vis, 14),
                          JK.convert_kps_to_mask(kp2[..., :2], vis, 14))


# --------------------------------------------------------------------------- #
# the native library, the affine, the transforms
# --------------------------------------------------------------------------- #

def test_native_decode_is_cv2s_and_raises_on_corrupt_data(dbs):
    assert native.decoder() == "libjpeg"  # this machine has libjpeg
    for path in list(dbs["video"]["img_name"][:3]) + [FIXTURE_DIR / "frame_0.jpg"]:
        assert np.array_equal(native.decode(Path(path).read_bytes()), cv2_rgb(path))
    with pytest.raises(IOError):
        native.decode(b"not a jpeg")
    with pytest.raises(IOError):  # a truncated file
        native.clip_decode_crop_u8([(FIXTURE_DIR / "frame_1.jpg").read_bytes()[:200]],
                                   np.eye(2, 3)[None], 8, 8)
    with pytest.raises(IOError):
        TD.read_img(str(FIXTURE_DIR / "decoded.npz"))


def test_fixture_frames_are_what_the_generator_and_cv2_make(tmp_path):
    make_fixture_frames(tmp_path)
    stored = np.load(FIXTURE_DIR / "decoded.npz")
    fresh = np.load(tmp_path / "decoded.npz")
    for k in range(len(stored["sha256"])):
        name = f"frame_{k}.jpg"
        assert (tmp_path / name).read_bytes() == (FIXTURE_DIR / name).read_bytes()
        rgb = cv2_rgb(FIXTURE_DIR / name)
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == stored["sha256"][k]
        assert np.array_equal(rgb[::6, ::6], stored["sub"][k])
    for key in ("sha256", "sub", "bbox", "crop"):
        assert np.array_equal(stored[key], fresh[key]), key


def test_affine_has_cv2s_bits():
    rng = np.random.RandomState(0)
    for _ in range(300):
        src = (rng.rand(3, 2) * 400).astype(np.float32)
        dst = (rng.rand(3, 2) * 224).astype(np.float32)
        assert np.array_equal(TT.affine_from_points(src, dst), cv2.getAffineTransform(src, dst))
    for _ in range(100):
        bbox = rng.rand(4) * [300, 300, 200, 200] + [10, 10, 20, 20]
        args = (bbox, (rng.uniform(1, 1.6),) * 2, rng.uniform(-30, 30),
                tuple(rng.uniform(-0.1, 0.1, 2)), 224, 224)
        assert np.array_equal(TT.gen_crop_trans(*args), JT.gen_crop_trans(*args))
    with pytest.raises(ValueError):
        TT.affine_from_points(np.zeros((3, 2)), np.ones((3, 2)))


def raw_inst(rng, T=4, size=(60, 80), with_bbox=True):
    frames = [cv2.GaussianBlur(rng.randint(0, 256, size + (3,), np.uint8), (3, 3), 1)
              for _ in range(T)]
    inst = {"clip": frames, "kp_2d": np.concatenate([rng.rand(T, 49, 2) * 60, rng.rand(T, 49, 1)], -1),
            "kp_3d": rng.randn(T, 49, 4), "pose": rng.randn(T, 72) * 0.3,
            "shape": rng.randn(T, 10), "cam": np.tile([1.0, 0, 0], (T, 1))}
    if with_bbox:
        inst["bbox"] = np.tile([40.0, 30.0, 40.0, 40.0], (T, 1)) + rng.randn(T, 4)
    return inst


@pytest.mark.parametrize("seed", range(4))
def test_crop_video_matches_cv2s(seed):
    rng = np.random.RandomState(seed)
    inst = raw_inst(rng)
    args = (32, 32, 30.0, 0.2, 0.5, 0.5)
    got = TT.CropVideo(*args)(dict(inst), np.random.RandomState(seed))
    want = JT.CropVideo(*args)(dict(inst), np.random.RandomState(seed))
    np.testing.assert_allclose(got["kp_2d"], want["kp_2d"], atol=1e-6, rtol=0)
    assert_pixels_close(np.stack(got["clip"]), np.stack(want["clip"]))


@pytest.mark.parametrize("color_jitter", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_train_transforms_match_jax(seed, color_jitter):
    """The whole train stack (crop, jitter, erase with random fill and
    keypoint zeroing, flip, stack) with one RandomState: every draw is
    shared, so the keypoints, pose, erase and flip decisions are equal and
    the pixels differ by the two crops' rounding only."""
    rng = np.random.RandomState(10 + seed)
    inst = raw_inst(rng)
    got = TT.build_train_transforms(dataset_cfg(t_cfg_defaults), color_jitter)(
        dict(inst), np.random.RandomState(seed))
    want = JT.build_train_transforms(dataset_cfg(j_cfg_defaults), color_jitter)(
        dict(inst), np.random.RandomState(seed))
    for key in ("kp_2d", "kp_3d", "pose", "shape", "cam"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=0, err_msg=key)
    assert got["clip"].dtype == want["clip"].dtype == np.uint8
    assert_pixels_close(got["clip"], want["clip"])


@pytest.mark.parametrize("device_normalize", [False, True])
@pytest.mark.parametrize("as_bytes", [False, True])
def test_fused_crop_normalize_bit_equal_jax(dbs, as_bytes, device_normalize):
    rng = np.random.RandomState(1)
    paths = dbs["video"]["img_name"][:4]
    clip = [Path(p).read_bytes() if as_bytes else cv2_rgb(p) for p in paths]
    inst = {"clip": clip, "bbox": dbs["video"]["bbox"][:4] + rng.randn(4, 4),
            "kp_2d": dbs["video"]["joints2D"][:4]}
    got = TT.build_eval_transforms(32, 32, device_normalize=device_normalize)(dict(inst))
    want = JT.build_eval_transforms(32, 32, device_normalize=device_normalize)(dict(inst))
    assert got["clip"].dtype == want["clip"].dtype
    assert np.array_equal(got["clip"], want["clip"])
    assert np.array_equal(got["kp_2d"], want["kp_2d"])
    no_bbox = {k: v for k, v in inst.items() if k != "bbox"}
    got = TT.build_eval_transforms(48, 48, device_normalize=device_normalize)(dict(no_bbox))
    want = JT.build_eval_transforms(48, 48, device_normalize=device_normalize)(dict(no_bbox))
    assert np.array_equal(got["clip"], want["clip"])


def test_device_crop_pack_schema_matches_jax(dbs):
    """DATASET.DEVICE_CROP: an eval item of the dataset carries the raw uint8
    source frames and their crop affines (``trans``), equal to JAX's (the
    frames bit for bit, the rest at 1e-6); its keypoints are those of the
    host-cropped item, whose crop took the same affines; a loader batch
    stacks the pack."""
    kw = dict(seqlen=4, sample_pool=4, overlap=0, random_sample=False, random_start=False,
              db=dbs["video"], verbose=False)
    got_ds = TD.VideoDataset("3dpw", "test", TT.build_eval_transforms(32, 32, device_crop=True),
                             **kw)
    want_ds = JD.VideoDataset("3dpw", "test", JT.build_eval_transforms(32, 32, device_crop=True),
                              **kw)
    cropped = TD.VideoDataset("3dpw", "test", TT.build_eval_transforms(32, 32), **kw)
    for index in range(0, len(want_ds), 2):
        got = got_ds.__getitem__(index, rng=np.random.RandomState(index))
        want = want_ds.__getitem__(index, rng=np.random.RandomState(index))
        assert got["images"].shape == (4, 48, 48, 3) and got["trans"].shape == (4, 2, 3)
        assert_items(got, want)
        host = cropped.__getitem__(index, rng=np.random.RandomState(index))
        assert host["images"].shape == (4, 32, 32, 3)
        np.testing.assert_allclose(got["kp_2d"], host["kp_2d"], atol=1e-5)
    batch = next(iter(TL.ShardedLoader(got_ds, 2, shuffle=False, drop_last=False)))
    assert batch["images"].shape == (2, 4, 48, 48, 3) and batch["trans"].shape == (2, 4, 2, 3)


def test_collate_names_device_crop_for_mixed_frame_sizes():
    """A DEVICE_CROP batch whose samples come from sources of two sizes
    cannot stack into one device array: the collate says so, and which mode
    takes such data, instead of numpy's ragged-shape error."""
    sample = {"images": np.zeros((4, 48, 64, 3), np.uint8), "trans": np.zeros((4, 2, 3))}
    other = dict(sample, images=np.zeros((4, 40, 64, 3), np.uint8))
    assert TL.collate([sample, dict(sample)])["images"].shape == (2, 4, 48, 64, 3)
    with pytest.raises(ValueError, match="DEVICE_CROP needs uniform source frame sizes.*"
                                         "DEVICE_PREPROC"):
        TL.collate([sample, other])
    # cropped clips (no affines) are stacked as before
    assert TL.collate([{"images": np.zeros((2, 3))}] * 2)["images"].shape == (2, 2, 3)


# --------------------------------------------------------------------------- #
# datasets
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("set_name, mode", [("train", (True, False)), ("train", (False, True)),
                                            ("val", (False, False)), ("test", (False, False))])
def test_video_dataset_matches_jax(dbs, set_name, mode):
    db = dbs["video"]
    if set_name == "train":
        tfs = [m.build_train_transforms(dataset_cfg(d)) for m, d in
               ((TT, t_cfg_defaults), (JT, j_cfg_defaults))]
    else:
        tfs = [m.build_eval_transforms(32, 32) for m in (TT, JT)]
    kw = dict(seqlen=4, sample_pool=8, overlap=0.5, random_sample=mode[0], random_start=mode[1],
              db=db, verbose=False)
    got_ds = TD.VideoDataset("3dpw", set_name, tfs[0], **kw)
    want_ds = JD.VideoDataset("3dpw", set_name, tfs[1], **kw)
    assert len(got_ds) == len(want_ds)
    for index in range(0, len(want_ds), 3):
        got = got_ds.__getitem__(index, rng=np.random.RandomState(index))
        want = want_ds.__getitem__(index, rng=np.random.RandomState(index))
        assert_items(got, want, pixels="close" if set_name == "train" else "exact")


def test_image_dataset_matches_jax(dbs):
    """Poses stored as rotation matrices go through the port's rotmat_to_aa
    on a CPU tensor, JAX's through jnp: 1e-5."""
    db = dict(dbs["image"])
    from maed_tpu.ops.geometry import rodrigues as j_rodrigues

    rot = np.asarray(j_rodrigues(db["pose"].reshape(-1, 3))).reshape(len(db["pose"]), 24 * 9)
    tfs = [m.build_train_transforms(dataset_cfg(d), color_jitter=False) for m, d in
           ((TT, t_cfg_defaults), (JT, j_cfg_defaults))]
    for pose in (db["pose"], rot.astype(np.float32)):
        db["pose"] = pose
        got_ds = TD.ImageDataset("coco", "train", tfs[0], db=db, verbose=False)
        want_ds = JD.ImageDataset("coco", "train", tfs[1], db=db, verbose=False)
        for index in range(len(want_ds)):
            got = got_ds.__getitem__(index, rng=np.random.RandomState(index))
            want = want_ds.__getitem__(index, rng=np.random.RandomState(index))
            np.testing.assert_allclose(got["theta"], want["theta"], atol=1e-5, rtol=0)
            got["theta"] = want["theta"]
            assert_items(got, want, pixels="close")


def test_load_db_reads_pickle_and_joblib(dbs, tmp_path, monkeypatch):
    db = dbs["video2d"]
    pickle.dump(db, open(tmp_path / "a_train_db.pt", "wb"))
    joblib.dump(db, tmp_path / "b_train_db.pt")
    for name in ("a", "b"):
        assert_items(TD.load_db(name, "train", str(tmp_path)), db)
    assert_items(JD.load_db("a", "train", str(tmp_path)), db)  # joblib reads the port's DBs
    monkeypatch.setitem(sys.modules, "joblib", None)  # the card's machine has no joblib
    assert_items(TD.load_db("a", "train", str(tmp_path)), db)
    with pytest.raises(RuntimeError, match="joblib"):
        TD.load_db("b", "train", str(tmp_path))
    with pytest.raises(ValueError, match="does not exist"):
        TD.load_db("c", "train", str(tmp_path))


# --------------------------------------------------------------------------- #
# loaders
# --------------------------------------------------------------------------- #

class Ids:
    """A dataset whose items say which index and rng draw made them."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        return {"index": np.array([index]), "draw": np.array([rng.randint(1 << 30)])}


@pytest.mark.parametrize("shuffle, world, drop_last", [(True, 1, True), (True, 3, True),
                                                       (False, 2, False), (True, 4, False)])
def test_sharded_loader_order_equals_jax(shuffle, world, drop_last):
    for rank, epoch in product(range(world), (0, 1, 5)):
        kw = dict(batch_size=3, shuffle=shuffle, rank=rank, world_size=world, seed=7,
                  drop_last=drop_last, prefetch=0)
        got = list(TL.ShardedLoader(Ids(23), **kw).iter_from(epoch))
        want = list(JL.ShardedLoader(Ids(23), **kw).iter_from(epoch))
        assert len(got) == len(want) == len(TL.ShardedLoader(Ids(23), **kw))
        for g, w in zip(got, want):
            assert_items(g, w)
        tail = list(TL.ShardedLoader(Ids(23), **kw).iter_from(epoch, 2))
        assert len(tail) == len(got) - 2
        for g, w in zip(tail, got[2:]):
            assert_items(g, w)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_unpadded_shards_take_each_index_once(world):
    """``pad=False`` (the eval CLI's data ranks): rank r takes indices r, r +
    W, ... of the 23, none twice and none left out, in batches of 3 with a
    ragged last one, and its length counts them; the padded loader repeats
    the first indices to even the shards."""
    seen = []
    for rank in range(world):
        loader = TL.ShardedLoader(Ids(23), 3, rank=rank, world_size=world, drop_last=False,
                                  prefetch=0, pad=False)
        batches = list(loader)
        assert len(batches) == len(loader)
        got = np.concatenate([b["index"].reshape(-1) for b in batches]).tolist()
        assert got == list(range(rank, 23, world))
        seen += got
    assert sorted(seen) == list(range(23))
    padded = sum(len(np.concatenate([b["index"].reshape(-1) for b in TL.ShardedLoader(
        Ids(23), 3, rank=r, world_size=world, drop_last=False, prefetch=0)]))
        for r in range(world))
    assert padded == -(-23 // world) * world


def test_workers_give_the_same_batches(dbs, monkeypatch):
    """Workers started from a forkserver, as they are on the card (whose
    process holds a CUDA context), which also pickles the dataset."""
    monkeypatch.setenv("MAED_LOADER_MP", "forkserver")
    tf = TT.build_train_transforms(dataset_cfg(t_cfg_defaults))
    ds = TD.VideoDataset("syn", "train", tf, seqlen=4, sample_pool=8, db=dbs["video"],
                         verbose=False)
    loaders = [TL.ShardedLoader(ds, 2, shuffle=True, seed=3, num_workers=w) for w in (0, 2)]
    for epoch, start in ((0, 0), (1, 1)):
        batches = [list(ld.iter_from(epoch, start)) for ld in loaders]
        assert len(batches[0]) == len(batches[1]) == len(loaders[0]) - start
        for g, w in zip(*batches):
            assert_items(g, w)


def test_infinite_loader_state_restore_round_trips():
    a = TL.InfiniteLoader(TL.ShardedLoader(Ids(10), 3, shuffle=True, seed=1, prefetch=0))
    seen = [next(a) for _ in range(4)]  # wraps after 3 batches
    a.set_epoch(1)
    st = a.state()
    rest = [next(a) for _ in range(5)]
    b = TL.InfiniteLoader(TL.ShardedLoader(Ids(10), 3, shuffle=True, seed=1, prefetch=0))
    b.restore(st)
    assert b.state() == st
    for g, w in zip([next(b) for _ in range(5)], rest):
        assert_items(g, w)
    j = JL.InfiniteLoader(JL.ShardedLoader(Ids(10), 3, shuffle=True, seed=1, prefetch=0))
    for g, w in zip(seen, [next(j) for _ in range(4)]):
        assert_items(g, w)
    j.set_epoch(1)
    assert j.state() == st


def test_get_data_loaders_match_jax(dbs):
    """The stage-2 loaders of a tiny config: each loader's first batch (the
    3D clips jittered, the 2D clips and images not; validation windows
    through the fused eval crop) equals JAX's."""
    cfgs = []
    for defaults in (t_cfg_defaults, j_cfg_defaults):
        cfg = defaults()
        cfg.DATASET = dataset_cfg(lambda: cfg)
        cfg.NUM_WORKERS = 0
        cfg.SEED_VALUE = 4
        cfg.TRAIN.update(DATASETS_2D=["syn2d"], DATASETS_3D=["syn3d"], DATASETS_IMG=["synimg"],
                         DATASET_EVAL="3dpw", BATCH_SIZE_2D=2, BATCH_SIZE_3D=2, BATCH_SIZE_IMG=3)
        cfg.EVAL.update(SAMPLE_POOL=8, BATCH_SIZE=2)
        cfgs.append(cfg)
    overrides = {"syn2d": dbs["video2d"], "syn3d": dbs["video"], "synimg": dbs["image"],
                 "3dpw_val": dbs["video"]}
    got = TL.get_data_loaders(cfgs[0], db_overrides=overrides, verbose=False)
    want = JL.get_data_loaders(cfgs[1], db_overrides=overrides, verbose=False)
    assert sorted(got) == sorted(want) == ["train_2d", "train_3d", "train_img", "valid"]
    for name in want:
        assert len(got[name]) == len(want[name])
        g, w = next(iter(got[name])), next(iter(want[name]))
        assert_items(g, w, pixels="exact" if name == "valid" else "close")
