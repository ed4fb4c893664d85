"""The port's dataset preprocessors (``maed_tpu_torch/data/preprocess``)
against the JAX package's, on the CPU, on raw-format fixtures the tests
write (no dataset exists here).

Equal, bit for bit, where both sides run the same numpy: the bbox helpers,
the TFRecord / tf.train.Example reader (packed and unpacked float and
int64 lists, bytes lists, several records a file), InstaVariety's,
PennAction's, PoseTrack's and MPI-INF-3DHP's (train and test) ``read_data``.
InstaVariety's ``extract_images`` writes each record's JPEG bytes as they
are (JAX decodes and re-encodes them with cv2): the file is the record, and
its pixels through the port's decoder lie within 3 LSB of cv2's decode of
the record (the card's nvJPEG bound, PR 9). 3DPW runs the body model:
``align_global_orient_to_camera`` within 1e-5 of JAX's in f32, and
``read_data`` on a synthetic ``sequenceFiles`` layout (2 sequences of 2
people) with the same synthetic body on both sides, ``joints3D`` within
1e-5 m (the train split's 49-joint bank, the test split's H36M J14 through
a regressor file) and every other field equal. The CLIs write DBs that the
port's ``VideoDataset`` and joblib read, also as plain pickles where joblib
is absent; 3DPW's refuses the synthetic body unless asked.
"""

import json
import pickle
import struct
import sys

import cv2
import numpy as np
import pytest
import scipy.io as sio

from maed_tpu.data.preprocess import insta as JI
from maed_tpu.data.preprocess import mpii3d as JM
from maed_tpu.data.preprocess import penn_action as JP
from maed_tpu.data.preprocess import posetrack as JPT
from maed_tpu.data.preprocess import threedpw as J3
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch.data.dataset import read_pickled
from maed_tpu_torch.data.preprocess import insta as TI
from maed_tpu_torch.data.preprocess import mpii3d as TM
from maed_tpu_torch.data.preprocess import penn_action as TP
from maed_tpu_torch.data.preprocess import posetrack as TPT
from maed_tpu_torch.data.preprocess import threedpw as T3
from maed_tpu_torch.utils import image_io
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from test_preprocess import _example, _feature_bytes, _feature_floats, _len_delim, _varint
from torch_port_common import one_torch_thread  # noqa: F401

eq = np.testing.assert_array_equal


def assert_db_equal(got, want, close=()):
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.asarray(got[key]).shape == np.asarray(want[key]).shape, key
        if key in close:
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0, err_msg=key)
        else:
            eq(got[key], want[key], err_msg=key)


# ------------------------------------------------------------- bbox helpers

def test_bbox_helpers_match_jax():
    rng = np.random.RandomState(0)
    for trial in range(20):
        kp = np.concatenate([rng.uniform(0, 300, (14, 2)), (rng.rand(14, 1) > 0.3)], axis=1)
        kp[rng.rand(14) < 0.2] = 0.0  # all-zero rows leave mpii3d's bound
        eq(TM.bbox_from_kp2d(kp), JM.bbox_from_kp2d(kp))
        eq(TP.kp_bound_bbox(kp), JP.kp_bound_bbox(kp))
    eq(TP.kp_bound_bbox(np.zeros((13, 3))), JP.kp_bound_bbox(np.zeros((13, 3))))
    eq(TM._valid_mask(3), JM._valid_mask(3))
    j2d = np.concatenate([rng.uniform(100, 200, (40, 18, 2)), rng.rand(40, 18, 1)], axis=2)
    j2d[:5, :, 2] = 0.0  # a track that starts late
    for got, want in zip(T3.bbox_from_smooth_track(j2d), J3.bbox_from_smooth_track(j2d)):
        eq(got, want)


# ------------------------------------------------------------- InstaVariety

def _feature_int64(values, packed):
    """Feature.int64_list = 3: Int64List { repeated int64 value = 1 }."""
    if packed:
        body = _len_delim(1, b"".join(_varint(v) for v in values))
    else:
        body = b"".join(_varint(1 << 3) + _varint(v) for v in values)
    return _len_delim(3, body)


def _unpacked_floats(values):
    return _len_delim(2, b"".join(_varint((1 << 3) | 5) + struct.pack("<f", v) for v in values))


def write_tfrecord(path, records):
    with open(path, "wb") as f:
        for rec in records:
            f.write(struct.pack("<Q", len(rec)) + b"\x00" * 4 + rec + b"\x00" * 4)


@pytest.fixture(scope="module")
def insta_shards(tmp_path_factory):
    """Two shards of the raw layout: a record holds a video's JPEG frames,
    its 25 joints' xys and visibilities; one record lacks the keypoints."""
    d = tmp_path_factory.mktemp("insta")
    rng = np.random.RandomState(1)
    jpgs = [cv2.imencode(".jpg", cv2.GaussianBlur(rng.randint(0, 256, (24, 32, 3), np.uint8),
                                                  (5, 5), 1.5))[1].tobytes() for _ in range(3)]
    for shard, frames in (("train_0", (3, 2)), ("train_1", (1,))):
        recs = []
        for n in frames:
            recs.append(_example({
                "image/xys": _feature_floats(rng.uniform(0, 32, n * 50).tolist()),
                "image/visibilities": _unpacked_floats((rng.rand(n * 25) > 0.3).astype(float)),
                "image_data": _feature_bytes(jpgs[:n]),
                "meta/ints": _feature_int64([0, 1, 300, 2 ** 40 + 3], packed=n > 1),
            }))
        recs.append(_example({"image_data": _feature_bytes(jpgs[:1])}))  # no keypoints
        write_tfrecord(d / f"{shard}.tfrecord", recs)
    return d


def test_tfrecord_parse_matches_jax(insta_shards):
    for shard in ("train_0", "train_1"):
        got = list(TI.iter_tfrecord(str(insta_shards / f"{shard}.tfrecord")))
        assert got == list(JI.iter_tfrecord(str(insta_shards / f"{shard}.tfrecord")))
        for rec in got:
            g, w = TI.parse_example(rec), JI.parse_example(rec)
            assert sorted(g) == sorted(w)
            for key in w:
                if key == "image_data":
                    assert g[key] == w[key]
                else:
                    eq(g[key], w[key], err_msg=key)


def test_insta_read_data_and_frames(insta_shards, tmp_path):
    assert_db_equal(TI.read_data(str(insta_shards), "/imgs"),
                    JI.read_data(str(insta_shards), "/imgs"))
    TI.extract_images(str(insta_shards), str(tmp_path / "port"))
    JI.extract_images(str(insta_shards), str(tmp_path / "jax"))
    for rec_i, rec in enumerate(TI.iter_tfrecord(str(insta_shards / "train_0.tfrecord"))):
        for f_i, jpg in enumerate(TI.parse_example(rec)["image_data"]):
            path = tmp_path / "port" / f"train_0_{rec_i}" / f"frame_{f_i:06d}.jpg"
            assert path.read_bytes() == jpg  # the record's own bytes
            assert (tmp_path / "jax" / f"train_0_{rec_i}" / f"frame_{f_i:06d}.jpg").is_file()
            want = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
            assert np.abs(image_io.read_rgb(str(path)).astype(int) - want).max() <= 3
    bad = tmp_path / "bad"
    bad.mkdir()
    write_tfrecord(bad / "train_9.tfrecord",
                   [_example({"image_data": _feature_bytes([b"\x89PNG"])})])
    with pytest.raises(IOError, match="JPEG frames only"):
        TI.extract_images(str(bad), str(tmp_path / "bad_out"))


# ------------------------------------------------------------- PennAction

def test_penn_action_read_data_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    for name, n in (("0001", 5), ("0002", 3)):
        vis = (rng.rand(n, 13) > 0.2).astype(np.float64)
        vis[0] = 0.0  # a frame with no visible joint
        sio.savemat(str(_mk(tmp_path / "labels") / f"{name}.mat"),
                    {"nframes": np.array([[n]]), "x": rng.uniform(0, 480, (n, 13)),
                     "y": rng.uniform(0, 270, (n, 13)), "visibility": vis})
        for i in range(n):
            (_mk(tmp_path / "frames" / name) / f"{i + 1:06d}.jpg").write_bytes(b"")
    assert_db_equal(TP.read_data(str(tmp_path)), JP.read_data(str(tmp_path)))


def _mk(path):
    path.mkdir(parents=True, exist_ok=True)
    return path


# ------------------------------------------------------------- PoseTrack

def test_posetrack_read_data_matches_jax(tmp_path):
    write_posetrack(tmp_path, seed=3)
    assert_db_equal(TPT.read_data(str(tmp_path), "train"), JPT.read_data(str(tmp_path), "train"))


def write_posetrack(root, seed):
    """Two annotation files of the PoseTrack layout: tracks of 10, 9 and 4
    frames (the last too short), some keypoints zero, a zero-sized box, an
    unlabeled image."""
    rng = np.random.RandomState(seed)
    names = ["nose", "head_bottom", "head_top", "left_ear", "right_ear", "left_shoulder",
             "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist",
             "left_hip", "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle"]
    ann_dir = _mk(root / "posetrack_data" / "annotations" / "train")
    for f, tracks in ((0, {1: 10, 2: 4}), (1, {5: 9})):
        images = [{"frame_id": i, "file_name": f"images/v{f}/{i:06d}.jpg", "is_labeled": i != 3}
                  for i in range(12)]
        anns = []
        for tid, n in tracks.items():
            for i in range(n):
                kps = np.concatenate([rng.uniform(0, 300, (17, 2)), rng.rand(17, 1)], 1)
                kps[rng.rand(17) < 0.2, :2] = 0.0
                box = [float(v) for v in rng.uniform(10, 200, 4)]
                if i == 2:
                    box[2] = 0.0
                anns.append({"track_id": tid, "image_id": i, "bbox": box,
                             "keypoints": kps.ravel().tolist()})
        (ann_dir / f"{f:06d}_mpii_train.json").write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": [{"keypoints": names}]}))


# ------------------------------------------------------------- MPI-INF-3DHP

def test_mpii3d_read_data_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    for s in (1, 2):
        seq = tmp_path / f"S{s}" / "Seq1"
        cells2, cells3 = np.empty((3, 1), object), np.empty((3, 1), object)
        for v in range(3):
            a2 = rng.uniform(100, 1900, (4, 56))
            a2[2, 5] = 2100.0  # a joint out of frame: the track splits
            cells2[v, 0], cells3[v, 0] = a2, rng.randn(4, 84) * 500
            if v != 1:  # video 1 has no frames
                for i in range(4):
                    (_mk(seq / f"video_{v}") / f"frame_{i:06d}.jpg").write_bytes(b"")
        sio.savemat(str(_mk(seq) / "annot.mat"), {"annot2": cells2, "annot3": cells3})
    assert_db_equal(TM.read_data_train(str(tmp_path), [1, 2], [1], [0, 1, 2]),
                    JM.read_data_train(str(tmp_path), [1, 2], [1], [0, 1, 2]))

    import h5py

    frame = cv2.imencode(".jpg", np.zeros((30, 40, 3), np.uint8))[1].tobytes()
    for u in range(1, 7):
        ts = _mk(tmp_path / "mpi_inf_3dhp_test_set" / f"TS{u}" / "imageSequence")
        a2 = rng.uniform(0, 35, (4, 1, 17, 2))
        a2[1, 0, 3] = 45.0  # outside the 40 x 30 frame
        with h5py.File(ts.parent / "annot_data.mat", "w") as m:
            m["annot2"], m["univ_annot3"] = a2, rng.randn(4, 1, 17, 3) * 500
            m["valid_frame"] = (rng.rand(4) > 0.2).astype(np.float64)
        for i in range(3):  # the 4th frame's image is missing
            (ts / f"img_{i + 1:06d}.jpg").write_bytes(frame)
    assert_db_equal(TM.read_test_data(str(tmp_path)), JM.read_test_data(str(tmp_path)))


# ------------------------------------------------------------- 3DPW

VERTS = 200


@pytest.fixture(scope="module")
def threedpw_raw(tmp_path_factory):
    """The 3DPW raw layout: sequenceFiles/<split>/<seq>.pkl with 2 people
    of 20 frames (poses (T, 72), betas, poses2d (T, 3, 18), campose_valid,
    cam_poses (T, 4, 4), img_frame_ids); one person is detected only from
    frame 6 on; a (17, V) J_regressor_h36m.npy beside the body."""
    from scipy.spatial.transform import Rotation

    root = tmp_path_factory.mktemp("3dpw")
    rng = np.random.RandomState(5)
    for split in ("train", "test"):
        for s in range(2):
            T = 20
            cam = np.tile(np.eye(4), (T, 1, 1))
            cam[:, :3, :3] = Rotation.random(T, random_state=rng).as_matrix()
            p2d = np.concatenate([rng.uniform(200, 600, (2, T, 2, 18)),
                                  rng.uniform(0.2, 1.0, (2, T, 1, 18))], axis=2)
            p2d[1, :6, 2] = 0.0
            seq = {"poses": [rng.randn(T, 72) * 0.3 for _ in range(2)],
                   "betas": [rng.randn(16) * 0.5 for _ in range(2)],
                   "poses2d": list(p2d), "campose_valid": [rng.rand(T) > 0.1 for _ in range(2)],
                   "cam_poses": cam, "img_frame_ids": np.arange(T)}
            with open(_mk(root / "sequenceFiles" / split) / f"seq_{s:02d}.pkl", "wb") as f:
                pickle.dump(seq, f)
    jreg = rng.rand(17, VERTS) ** 4
    np.save(_mk(root / "smpl") / "J_regressor_h36m.npy", jreg / jreg.sum(1, keepdims=True))
    return root


def test_align_global_orient_matches_jax():
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(6)
    pose = (rng.randn(50, 72) * 0.5).astype(np.float32)
    pose[:, :3] = Rotation.random(50, random_state=rng).as_rotvec()
    cam = np.tile(np.eye(4, dtype=np.float32), (50, 1, 1))
    cam[:, :3, :3] = Rotation.random(50, random_state=rng).as_matrix()
    got = T3.align_global_orient_to_camera(pose, cam)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, J3.align_global_orient_to_camera(pose, cam), atol=1e-5, rtol=0)
    eq(got[:, 3:], pose[:, 3:])


@pytest.mark.parametrize("split", ["train", "test"])
def test_threedpw_read_data_matches_jax(threedpw_raw, split):
    data_dir = str(threedpw_raw / "smpl")
    want = J3.read_data(str(threedpw_raw), split, smpl_model=j_synthetic_smpl(VERTS, 0),
                        data_dir=data_dir)
    got = T3.read_data(str(threedpw_raw), split,
                       smpl_model=t_synthetic_smpl(VERTS, 0, device="cpu"), data_dir=data_dir)
    assert got["joints3D"].shape == want["joints3D"].shape == (len(want["img_name"]), 49, 4)
    assert len(want["img_name"]) > 60  # most frames kept
    # pose is f32 arithmetic on both sides (the rotation into the camera frame)
    assert_db_equal(got, want, close=("joints3D", "pose"))


def test_threedpw_cli_writes_dbs_the_dataset_reads(threedpw_raw, tmp_path, monkeypatch, capsys):
    """``python -m maed_tpu_torch.data.preprocess.threedpw`` on the CPU (no
    joblib: plain pickles), the synthetic body refused unless asked; the
    test DB read by the port's VideoDataset and by joblib."""
    import joblib

    from maed_tpu_torch.data.dataset import VideoDataset

    monkeypatch.chdir(tmp_path)
    (threedpw_raw / "sequenceFiles" / "validation").mkdir(exist_ok=True)
    for s in range(2):
        src = threedpw_raw / "sequenceFiles" / "test" / f"seq_{s:02d}.pkl"
        (threedpw_raw / "sequenceFiles" / "validation" / src.name).write_bytes(src.read_bytes())
    argv = ["--inp_dir", str(threedpw_raw), "--out_dir", str(tmp_path / "db"), "--device", "cpu",
            "--smpl_dir", str(tmp_path / "absent")]
    with pytest.raises(FileNotFoundError, match="SMPL body model not found"):
        T3.main(argv)
    monkeypatch.setitem(sys.modules, "joblib", None)
    T3.main(argv + ["--allow_synthetic_smpl"])
    assert "frames/s" in capsys.readouterr().out
    monkeypatch.delitem(sys.modules, "joblib")
    for name in ("3dpw_train_db.pt", "3dpw_val_db.pt", "3dpw_test_db.pt"):
        with open(tmp_path / "db" / name, "rb") as f:
            db = pickle.load(f)
        assert db["joints3D"].shape[1:] == (49, 4) and np.isfinite(db["joints3D"]).all()
        assert_db_equal(joblib.load(tmp_path / "db" / name), db)
    ds = VideoDataset("3dpw", "test", None, seqlen=0, sample_pool=8, overlap=0,
                      random_sample=False, db_dir=str(tmp_path / "db"), verbose=False)
    assert len(ds) > 0


def test_posetrack_cli_writes_dbs(tmp_path, monkeypatch):
    """With joblib, and as a plain pickle where it is absent."""
    write_posetrack(tmp_path / "pt", seed=7)
    want = JPT.read_data(str(tmp_path / "pt"), "train")
    TPT.main(["--inp_dir", str(tmp_path / "pt"), "--out_dir", str(tmp_path)])
    assert_db_equal(read_pickled(str(tmp_path / "posetrack_train_db.pt")), want)
    monkeypatch.setitem(sys.modules, "joblib", None)
    TPT.main(["--inp_dir", str(tmp_path / "pt"), "--out_dir", str(_mk(tmp_path / "plain"))])
    with open(tmp_path / "plain" / "posetrack_train_db.pt", "rb") as f:
        assert_db_equal(pickle.load(f), want)
