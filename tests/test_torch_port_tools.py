"""maed_tpu_torch's tools against the JAX package's on the CPU: the synthetic
acceptance tool (``maed_tpu_torch.tools.accept_synthetic`` against
``tools/accept_synthetic.py``), the train-step tool's batch builder and
learning soak (``maed_tpu_torch.tools.bench_train`` against
``tools/bench_train.py``), the trainer's trace (``utils.profiling``) and
its TensorBoard event file (``utils.summary`` against tensorboardX).

- generate, 1 + 2 videos x 40 frames x 48 px from one seed on both sides:
  the DBs' names, frame ids, boxes and poses equal, joints3D within 1e-5 m
  and joints2D within 1e-3 px (f32 SMPL forwards summed in other orders);
  the palette equal to cv2's; the frames equal bit for bit to frames drawn
  here with cv2.circle from the same joints; each JPEG, decoded by the port,
  within JPEG_LUMA_MAX / JPEG_LUMA_MEAN (luma) and JPEG_MEAN (a channel) of
  the drawn frame and within JPEG_CV2_MAX / JPEG_CV2_MEAN of cv2's
  quality-95 encode of it; both
  accept.yaml (tiny and --flagship) equal key by key but OUTPUT_DIR;
- the oracle below 0.01 mm on the port's DBs and on the directory the JAX
  tool wrote (joblib DB, cv2 JPEGs);
- the soak's targets against JAX's ``_consistent_targets`` (theta equal,
  kp_3d and kp_2d within 1e-5), and ``--learn 3 --smoke --device cpu``
  writes the JAX tool's JSON keys with finite losses;
- a two-step run of the train CLI with MAED_PROFILE_DIR writes a Chrome
  trace that names the annotated regions (none without the variable), and
  an event file with the JAX trainer's scalars;
- the event writer's records equal tensorboardX's for the same add_scalar
  calls, CRCs checked by tensorboardX's crc32c, but for the wall time.
"""

import glob
import json
import os.path as osp
import pickle
import sys

import cv2
import numpy as np
import pytest
import yaml

from fixtures import make_image_db, make_video_db
from maed_tpu.utils.smpl_io import find_smpl_model as jax_smpl_model
from maed_tpu_torch import native
from maed_tpu_torch import train as train_cli
from maed_tpu_torch.data.dataset import read_pickled
from maed_tpu_torch.tools import accept_synthetic as PA
from maed_tpu_torch.tools import bench_train as PB
from maed_tpu_torch.utils import summary
from maed_tpu_torch.utils.smpl_io import find_smpl_model
from test_torch_port_trainer import CFG as TRAINER_CFG
from torch_port_common import one_torch_thread  # noqa: F401 (autouse fixture)

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "tools"))

GEN = dict(n_videos=1, frames_per_video=40, size=48, seed=0, val_videos=2)
# A decoded JPEG against the frame it encodes, at quality 95: the luma's max
# and mean abs error (measured 18.1 and 0.41), and every channel's mean
# (3.6). A channel's max is not bounded: 4:2:0 keeps one chroma sample for
# 2 x 2 pixels, which blends a 5-pixel disk's colour with the grey around
# it (up to 251 on a channel), in cv2's encode as in the port's. Against
# cv2's quality-95 encode of the same frame decoded alike: libjpeg on both
# sides writes the same bytes here.
JPEG_LUMA_MAX, JPEG_LUMA_MEAN, JPEG_MEAN = 24.0, 0.6, 5.0
JPEG_CV2_MAX, JPEG_CV2_MEAN = 0, 0.0
LUMA = np.array([0.299, 0.587, 0.114])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(the JAX tool's directory, the port's), generated from one seed."""
    import accept_synthetic as JA

    jax_dir = str(tmp_path_factory.mktemp("synacc_jax"))
    port_dir = str(tmp_path_factory.mktemp("synacc_port"))
    JA.generate(jax_dir, **GEN)
    PA.generate(port_dir, device="cpu", **GEN)
    return jax_dir, port_dir


def dbs(out):
    return [read_pickled(osp.join(out, "data", "database", f"synacc_{s}_db.pt"))
            for s in ("train", "val")]


def test_generate_writes_the_jax_tools_dbs(dirs):
    jax_dir, port_dir = dirs
    for want, got in zip(dbs(jax_dir), dbs(port_dir)):
        assert sorted(got) == sorted(want)
        for key in ("vid_name", "frame_id", "bbox", "pose", "shape"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_allclose(got["joints3D"], want["joints3D"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["joints2D"], want["joints2D"], atol=1e-3, rtol=0)
        assert [osp.basename(p) for p in got["img_name"]] == \
            [osp.basename(p) for p in want["img_name"]]


def test_palette_equals_cv2s():
    import accept_synthetic as JA

    np.testing.assert_array_equal(PA.joint_palette(49), JA._joint_palette(49))
    # the conversion itself on random images: rows past one vector block and short rows
    rng = np.random.RandomState(1)
    hsv = rng.randint(0, 256, (40, 77, 3)).astype(np.uint8)
    hsv[..., 0] %= 180
    from maed_tpu_torch.utils.vis import hsv_to_bgr_u8

    for img in (hsv, hsv[:, :13]):
        np.testing.assert_array_equal(hsv_to_bgr_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2BGR))


def test_frames_equal_cv2_drawing_and_jpegs_decode_close(dirs):
    _, port_dir = dirs
    palette = cv2.cvtColor(_palette_hsv(), cv2.COLOR_HSV2BGR)[0]
    size, radius = GEN["size"], max(2, GEN["size"] // 24)
    raw_err, cv2_err = [], []
    for db in dbs(port_dir):
        for t in range(0, len(db["img_name"]), 7):
            kp, depth = db["joints2D"][t, :, :2], db["joints3D"][t, :, 2]
            want = np.full((size, size, 3), 80, np.uint8)
            for j in np.argsort(-depth):
                x, y = kp[j]
                if -radius <= x < size + radius and -radius <= y < size + radius:
                    cv2.circle(want, (int(round(x)), int(round(y))), radius,
                               palette[j].tolist(), -1)
            got = PA.render_frame(kp, depth, size, PA.joint_palette(49), radius)
            np.testing.assert_array_equal(got, want)
            with open(db["img_name"][t], "rb") as f:
                decoded = native.decode(f.read()).astype(np.int32)
            raw_err.append(decoded - want[..., ::-1])
            ok, enc = cv2.imencode(".jpg", want, [cv2.IMWRITE_JPEG_QUALITY, 95])
            cv2_err.append(np.abs(decoded - native.decode(enc.tobytes()).astype(np.int32)))
    raw_err, cv2_err = np.stack(raw_err), np.stack(cv2_err)
    luma = np.abs(raw_err @ LUMA)
    assert luma.max() <= JPEG_LUMA_MAX and luma.mean() <= JPEG_LUMA_MEAN, (luma.max(), luma.mean())
    assert np.abs(raw_err).mean() <= JPEG_MEAN, np.abs(raw_err).mean()
    assert cv2_err.max() <= JPEG_CV2_MAX and cv2_err.mean() <= JPEG_CV2_MEAN, \
        (cv2_err.max(), cv2_err.mean())


def _palette_hsv(n=49):
    hsv = np.zeros((1, n, 3), np.uint8)
    hsv[0, :, 0] = (np.arange(n) * 180 // n).astype(np.uint8)
    hsv[0, :, 1] = 255
    hsv[0, :, 2] = np.where(np.arange(n) % 2 == 0, 255, 160).astype(np.uint8)
    return hsv


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("flagship", [False, True])
def test_accept_yaml_equals_the_jax_tools(tmp_path, flagship):
    import accept_synthetic as JA

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _flat(yaml.safe_load(open(JA._write_cfg(str(tmp_path / "jax"), 64, flagship))))
    got = _flat(yaml.safe_load(open(PA.write_cfg(str(tmp_path / "port"), 64, flagship))))
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if k != "OUTPUT_DIR"} == \
        {k: v for k, v in want.items() if k != "OUTPUT_DIR"}
    assert got["OUTPUT_DIR"] == str(tmp_path / "port" / "results")


@pytest.mark.parametrize("which", ["port", "jax"])
def test_oracle_scores_zero(dirs, which):
    """The port's oracle on its own directory, and on the JAX tool's."""
    out = dirs[0] if which == "jax" else dirs[1]
    metrics = PA.oracle(out, tol_mm=0.1, device="cpu")
    for k in ("mpjpe", "pa-mpjpe", "pve"):
        assert metrics[k] < 0.01, (k, metrics)


def test_soak_targets_equal_the_jax_tools():
    import bench_train as JB

    want = JB._consistent_targets(np.random.RandomState(7), jax_smpl_model(), 2, 4)
    got = PB.consistent_targets(np.random.RandomState(7),
                                find_smpl_model(device="cpu"), 2, 4, "cpu")
    np.testing.assert_array_equal(got["theta"], want["theta"])
    np.testing.assert_allclose(got["kp_3d"], want["kp_3d"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["kp_2d"], want["kp_2d"], atol=1e-5, rtol=0)


def test_learning_soak_writes_the_jax_tools_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "soak.json"
    PB.main(["--learn", "3", "--smoke", "--device", "cpu", "--dtype", "f32", "--out", str(out)])
    result = json.loads(out.read_text())
    # the keys of tools/bench_train.py::_run_learning_soak's result
    assert sorted(result) == sorted(["dtype", "steps", "n_batches", "donate", "head_mean",
                                     "tail_mean", "ratio", "wall_s", "losses"])
    assert result["steps"] == 3 and len(result["losses"]) == 3
    assert np.isfinite(result["losses"]).all()
    with pytest.raises(SystemExit):  # XLA's flags are refused, not ignored
        PB.main(["--donate", "--device", "cpu"])


@pytest.fixture(scope="module")
def trainer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("profiled")
    (d / "data" / "database").mkdir(parents=True)
    dbs_ = {"syn2d_train": make_video_db(d / "f2", 2, 12, 48, seed=0, with_3d=False,
                                         with_smpl=False),
            "syn3d_train": make_video_db(d / "f3", 2, 12, 48, seed=1),
            "3dpw_val": make_video_db(d / "fv", 2, 12, 48, seed=2),
            "synimg_train": make_image_db(d / "fi", 6, 48)}
    for name, db in dbs_.items():
        with open(d / "data" / "database" / f"{name}_db.pt", "wb") as f:
            pickle.dump(db, f)
    (d / "tiny.yaml").write_text(TRAINER_CFG)
    return d


@pytest.mark.parametrize("profiled", [True, False])
def test_trainer_trace_and_event_file(trainer_dir, monkeypatch, profiled):
    """The train CLI's two steps (log every step, one validation) with and
    without MAED_PROFILE_DIR: the Chrome trace names the 'data' and
    'train_step' regions and the step's ops; the event file holds
    train_loss/<k> at global steps 1 and 2 and eval/<k> at epoch 0, as the
    JAX trainer writes them."""
    monkeypatch.chdir(trainer_dir)
    prof = trainer_dir / f"profile_{profiled}"
    if profiled:
        monkeypatch.setenv("MAED_PROFILE_DIR", str(prof))
        monkeypatch.setenv("MAED_PROFILE_STEPS", "2")
    else:
        monkeypatch.delenv("MAED_PROFILE_DIR", raising=False)
    out = trainer_dir / f"results_{profiled}"
    trainer = train_cli.main(["--cfg", "tiny.yaml", "--allow_synthetic_smpl",
                              "OUTPUT_DIR", str(out)])
    traces = glob.glob(str(prof / "maed_trace_*.json"))
    if not profiled:
        assert not prof.exists() and not traces
    else:
        (trace,) = traces
        events = json.load(open(trace))["traceEvents"]
        names = [e.get("name") for e in events]
        assert names.count("train_step") == 2 and names.count("data") == 1  # step 0's data
        assert any(n and n.startswith("aten::") for n in names)             # precedes it

    (event_file,) = glob.glob(osp.join(trainer.logdir, "events.out.tfevents.*"))
    read = summary.read_events(event_file)
    assert read[0]["file_version"] == "brain.Event:2" and not read[0]["scalars"]
    train = [(e["step"], tag) for e in read for tag, _ in e["scalars"]
             if tag.startswith("train_loss/")]
    assert {s for s, _ in train} == {1, 2} and ("train_loss/loss" in {t for _, t in train})
    evals = {tag: (e["step"], v) for e in read for tag, v in e["scalars"]
             if tag.startswith("eval/")}
    assert sorted(evals) == ["eval/accel", "eval/accel_err", "eval/mpjpe", "eval/pa-mpjpe",
                             "eval/pve"]
    assert all(step == 0 for step, _ in evals.values())
    best = float(open(osp.join(trainer.logdir, "best.txt")).read())
    assert evals["eval/pa-mpjpe"][1] == pytest.approx(best, rel=1e-6)  # a float32 of it


def test_event_writer_equals_tensorboardx(tmp_path):
    from tensorboardX import SummaryWriter
    from tensorboardX.crc32c import crc32c
    from tensorboardX.proto import event_pb2

    calls = [("train_loss/loss", 1.25, 10), ("train_loss/loss_kp_2d", 0.0, 10),
             ("eval/pa-mpjpe", 87.5, 0), ("a b/c", -3.5e-8, 3), ("/lead", 2.0 ** 70, 2 ** 40)]
    ours = summary.SummaryWriter(str(tmp_path / "port"))
    theirs = SummaryWriter(str(tmp_path / "tbx"))
    for tag, value, step in calls:
        ours.add_scalar(tag, value, step)
        theirs.add_scalar(tag, value, step)
    ours.close()
    theirs.close()
    (ours_file,) = glob.glob(str(tmp_path / "port" / "events.out.tfevents.*"))
    (theirs_file,) = glob.glob(str(tmp_path / "tbx" / "events.out.tfevents.*"))
    assert osp.basename(ours_file).split(".")[:3] == osp.basename(theirs_file).split(".")[:3]

    def records(path):
        blob, out, pos = open(path, "rb").read(), [], 0
        while pos < len(blob):
            header = blob[pos:pos + 8]
            length = int.from_bytes(header, "little")
            assert int.from_bytes(blob[pos + 8:pos + 12], "little") == _masked(crc32c(header))
            data = blob[pos + 12:pos + 12 + length]
            crc = blob[pos + 12 + length:pos + 16 + length]
            assert int.from_bytes(crc, "little") == _masked(crc32c(data))
            out.append(event_pb2.Event.FromString(data))
            pos += 16 + length
        return out

    got, want = records(ours_file), records(theirs_file)
    assert len(got) == len(want) == len(calls) + 1
    for g, w in zip(got, want):
        assert g.wall_time > 0 and w.wall_time > 0
        g.wall_time = w.wall_time = 0.0
        assert g.SerializeToString() == w.SerializeToString(), (g, w)
    assert [(e["step"], e["scalars"]) for e in summary.read_events(ours_file)][1:] == \
        [(s, [(summary.clean_tag(t), float(np.float32(v)))]) for t, v, s in calls]


def _masked(crc):
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
