"""The port's demo, visualize and their host tools against the JAX package's,
on the CPU.

Bit for bit (``assert_array_equal``), where both sides run the same numpy:
``utils/smooth_bbox.py``, ``convert_crop_cam_to_orig_img``,
``prepare_rendering_results``, ``read_posetrack_keypoints``, the renderer
(``weak_perspective_to_screen``, ``rasterize_mesh``, ``Renderer.render`` on
the synthetic 6890-vertex body at 96 x 72), ``utils/vis.py``'s numpy
functions and, against cv2 (which the JAX package draws with and the port
does not), its drawing: ``draw_line`` and ``draw_disk`` against
``cv2.line`` / ``cv2.circle`` on their own, and ``draw_skeleton`` /
``draw_smpl_joints2d`` against the JAX functions, with end points inside
and outside the image; the FBX keyframes under a fake ``bpy``. The frames'
I/O (``utils/image_io.py``) against cv2 and the native decoder. The demo
itself: the JAX package's ``demo.main`` and the port's on the same 10 JPEG
frames, boxes and weights (a reference-layout ``.pth.tar`` made from one
flax tree, as ``python -m maed_tpu.utils.torch_convert`` writes it), on the
tiny config (1 block, 2 heads, KTD 32, 32^2 crops), each in this process,
with a 400-vertex synthetic body on both sides (the rasterizer's cost is a
Python loop over the faces): ``pred_theta`` and ``pred_verts`` at atol 1e-3
and rtol 1e-3 (f32 on random weights: tests/test_torch_port_eval.py), the
boxes and paths equal; then ``python -m maed_tpu_torch.visualize`` on the
JAX demo's inference.pkl gives the pixels JAX's render wrote, bit for bit
(the two demos' own overlays differ where their f32 vertices do: 5 of
30720 pixels when this was written).
"""

import json
import os
import sys
import types
import urllib.request

import cv2
import jax
import numpy as np
import pytest
import torch

import demo as jdemo
from maed_tpu.models import MAED as JMAED
from maed_tpu.utils import demo_utils as JDU
from maed_tpu.utils import fbx_output as JFBX
from maed_tpu.utils import pose_tracker as JPT
from maed_tpu.utils import renderer as JR
from maed_tpu.utils import smooth_bbox as JSB
from maed_tpu.utils import vis as JV
from maed_tpu.utils import smpl_io as j_smpl_io
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu.utils.torch_convert import convert_params_to_state_dict
from maed_tpu_torch import demo as tdemo
from maed_tpu_torch import native
from maed_tpu_torch import visualize as tvis
from maed_tpu_torch.utils import demo_utils as TDU
from maed_tpu_torch.utils import fbx_output as TFBX
from maed_tpu_torch.utils import image_io
from maed_tpu_torch.utils import pose_tracker as TPT
from maed_tpu_torch.utils import renderer as TR
from maed_tpu_torch.utils import smooth_bbox as TSB
from maed_tpu_torch.utils import vis as TV
from maed_tpu_torch.utils import smpl_io as t_smpl_io
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from test_fbx_output import _install_fake_bpy
from test_torch_port_models import random_params
from torch_port_common import one_torch_thread  # noqa: F401

eq = np.testing.assert_array_equal


# ------------------------------------------------------------- smooth_bbox

def keypoint_track(seed, T=30, K=12, missing=()):
    """A drifting person's keypoints with per-joint confidences; frames in
    ``missing`` have every confidence 0 (no detection)."""
    rng = np.random.RandomState(seed)
    center = np.cumsum(rng.randn(T, 2) * 3, axis=0) + 100
    kp = np.concatenate([center[:, None] + rng.randn(T, K, 2) * 20, rng.rand(T, K, 1)], axis=2)
    kp[list(missing), :, 2] = 0.0
    return kp


@pytest.mark.parametrize("missing", [(), (0, 1, 7, 8, 9, 29), tuple(range(25)),
                                     tuple(range(30))])
def test_smooth_bbox_matches_jax(missing):
    kp = keypoint_track(0, missing=missing)
    for t in range(0, 30, 7):
        want = JSB.get_single_bbox(kp[t], 0.3)
        got = TSB.get_single_bbox(kp[t], 0.3)
        assert (got is None) == (want is None)
        if want is not None:
            eq(got, want)
    want, w0, w1 = JSB.get_all_bbox_params(kp, vis_thresh=0.3)
    got, g0, g1 = TSB.get_all_bbox_params(kp, vis_thresh=0.3)
    assert (g0, g1) == (w0, w1)
    eq(got, want)
    eq(TSB.smooth_bbox_params(got), JSB.smooth_bbox_params(want))
    eq(TSB.smooth_bbox_params(got, kernel_size=5, sigma=2.0),
       JSB.smooth_bbox_params(want, kernel_size=5, sigma=2.0))


# ------------------------------------------------------------- demo_utils

def test_crop_cam_and_rendering_groups_match_jax():
    rng = np.random.RandomState(1)
    cam = rng.randn(9, 3).astype(np.float32) * 0.5 + [1.0, 0.0, 0.0]
    bbox = np.concatenate([rng.uniform(50, 400, (9, 2)), rng.uniform(60, 200, (9, 1)).repeat(2, 1)],
                          axis=1).astype(np.float32)
    eq(TDU.convert_crop_cam_to_orig_img(cam, bbox, 480, 360),
       JDU.convert_crop_cam_to_orig_img(cam, bbox, 480, 360))
    results = {pid: {"frame_ids": np.sort(rng.choice(6, n, replace=False)),
                     "verts": rng.randn(n, 5, 3), "orig_cam": rng.randn(n, 4)}
               for pid, n in ((3, 4), (7, 6), (11, 2))}
    want, got = JDU.prepare_rendering_results(results, 6), TDU.prepare_rendering_results(results, 6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert list(g) == list(w)  # the back-to-front order
        for pid in w:
            eq(g[pid]["verts"], w[pid]["verts"])
            eq(g[pid]["cam"], w[pid]["cam"])


def test_video_tools_name_ffmpeg_and_pytube_where_absent(tmp_path, monkeypatch):
    monkeypatch.setattr(TDU.shutil, "which", lambda name: None)
    for call in (lambda: TDU.video_to_images("v.mp4", str(tmp_path / "f")),
                 lambda: TDU.images_to_video(str(tmp_path), str(tmp_path / "o.mp4")),
                 lambda: TDU.trim_videos("v.mp4", 0.0, 1.0, str(tmp_path / "t.mp4"))):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            call()
    monkeypatch.setitem(sys.modules, "pytube", None)
    with pytest.raises(RuntimeError, match="pytube"):
        TDU.download_youtube_clip("https://example.invalid/v", str(tmp_path))
    # download_url on a file:// URL, as tests/test_offline_tools.py holds JAX's
    src = tmp_path / "artifact.bin"
    src.write_bytes(b"\x00\x01payload")
    url = "file://" + urllib.request.pathname2url(str(src))
    got = TDU.download_url(url, str(tmp_path / "dl"))
    assert open(got, "rb").read() == src.read_bytes()
    assert got == JDU.download_url(url, str(tmp_path / "dl"))  # present: not fetched again


# ------------------------------------------------------------- pose tracker

def test_read_posetrack_keypoints_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    for frame in range(5):
        people = [{"person_id": [pid], "pose_keypoints_2d": rng.rand(21 * 3).round(4).tolist()}
                  for pid in (0, 3, 5) if rng.rand() < 0.7]
        (tmp_path / f"{frame:012d}_keypoints.json").write_text(json.dumps({"people": people}))
    want = JPT.read_posetrack_keypoints(str(tmp_path))
    got = TPT.read_posetrack_keypoints(str(tmp_path))
    assert list(got) == list(want) and want
    for pid in want:
        eq(got[pid]["joints2d"], want[pid]["joints2d"])
        eq(got[pid]["frames"], want[pid]["frames"])


# ------------------------------------------------------------- renderer

def test_renderer_matches_jax():
    """On the synthetic 6890-vertex body (the same numpy draws on both
    sides) at 96 x 72: a mesh over part of the image, then one off it."""
    j_smpl, t_smpl = j_synthetic_smpl(6890, 0), t_synthetic_smpl(6890, 0, device="cpu")
    rng = np.random.RandomState(3)
    eq(t_smpl.faces, np.asarray(j_smpl.faces))
    verts = np.asarray(j_smpl.v_template, np.float32) + rng.randn(6890, 3).astype(np.float32) * 0.01
    img = rng.randint(0, 256, (72, 96, 3), dtype=np.uint8)
    for cam, alpha in ((np.array([0.6, 0.5, 0.4, -0.3]), 0.8),
                       (np.array([0.5, 0.5, 3.0, 3.0]), 0.3)):
        screen = TR.weak_perspective_to_screen(verts, cam, 96, 72)
        eq(screen, JR.weak_perspective_to_screen(verts, cam, 96, 72))
        mask, zbuf = TR.rasterize_mesh(screen, t_smpl.faces, 96, 72)
        want_mask, want_zbuf = JR.rasterize_mesh(screen, t_smpl.faces, 96, 72)
        eq(mask, want_mask)
        eq(zbuf, want_zbuf)
        got = TR.Renderer((96, 72)).render(img, verts, t_smpl.faces, cam, alpha=alpha)
        eq(got, JR.Renderer((96, 72)).render(img, verts, t_smpl.faces, cam, alpha=alpha))
        assert 0 < mask.sum() < mask.size if alpha == 0.8 else mask.sum() == 0


# ------------------------------------------------------------- drawing

def end_points(rng, h, w, margin, n):
    return [(int(rng.randint(-margin, w + margin)), int(rng.randint(-margin, h + margin)))
            for _ in range(n)]


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("margin", [0, 40])
def test_draw_line_is_cv2_line(thickness, margin):
    """``cv2.line(..., thickness)`` (LINE_8) pixel for pixel, on 600 random
    segments, with end points inside the image (margin 0) and up to 40 px
    outside it; every fifth a single point."""
    rng = np.random.RandomState(thickness * 10 + margin)
    for h, w in ((37, 53), (72, 96)):
        pts = end_points(rng, h, w, margin, 600)
        for i in range(0, 600, 2):
            p, q = pts[i], pts[i] if i % 10 == 0 else pts[i + 1]
            want = np.zeros((h, w, 3), np.uint8)
            cv2.line(want, p, q, (7, 200, 31), thickness)
            got = TV.draw_line(np.zeros((h, w, 3), np.uint8), p, q, (7, 200, 31), thickness)
            eq(got, want, err_msg=f"{p} {q}")


@pytest.mark.parametrize("radius", [1, 2, 4, 7])
def test_draw_disk_is_cv2_filled_circle(radius):
    rng = np.random.RandomState(radius)
    for c in end_points(rng, 37, 53, 9, 300):
        want = np.zeros((37, 53, 3), np.uint8)
        cv2.circle(want, c, radius, (255, 9, 0), -1)
        eq(TV.draw_disk(np.zeros((37, 53, 3), np.uint8), c, radius, (255, 9, 0)), want,
           err_msg=str(c))


def test_skeletons_match_jax():
    """``draw_skeleton`` (normalized and pixel keypoints, some invisible, some
    far outside) and ``draw_smpl_joints2d`` (default kintree and a given
    one; thickness 2 and radius 4) against the JAX functions, which draw
    with cv2."""
    rng = np.random.RandomState(4)
    for trial in range(12):
        img = rng.randint(0, 256, (64, 80, 3), dtype=np.uint8)
        kp = np.concatenate([rng.uniform(-1.6, 1.6, (49, 2)), rng.rand(49, 1)], axis=1)
        eq(TV.draw_skeleton(img, kp), JV.draw_skeleton(img, kp))
        px = kp.copy()
        px[:, :2] = rng.uniform(-30, 110, (49, 2))
        eq(TV.draw_skeleton(img, px, normalized=False), JV.draw_skeleton(img, px, normalized=False))
        joints = rng.uniform(-20, 100, (24, 2))
        got, want = img.copy(), img.copy()
        assert TV.draw_smpl_joints2d(joints, got) is got  # draws in place, as cv2 does
        JV.draw_smpl_joints2d(joints, want)
        eq(got, want)
        table = np.stack([np.r_[0, np.arange(23)], np.arange(24)])
        eq(TV.draw_smpl_joints2d(joints, img.copy(), table),
           JV.draw_smpl_joints2d(joints, img.copy(), table))


def test_vis_panels_match_jax():
    t_smpl, rng = t_synthetic_smpl(VERTS, 0, device="cpu"), np.random.RandomState(5)
    faces = t_smpl.faces
    images = rng.randn(5, 32, 40, 3).astype(np.float32)
    kp = np.concatenate([rng.uniform(-1, 1, (5, 49, 2)), rng.rand(5, 49, 1)], axis=2)
    eq(TV.denormalize_image(images[0]), JV.denormalize_image(images[0]))
    eq(TV.batch_grid(images, kp), JV.batch_grid(images, kp))
    eq(TV.batch_grid(images, None, max_items=3), JV.batch_grid(images, None, max_items=3))
    verts = t_smpl.v_template.numpy()[None] + rng.randn(5, VERTS, 3).astype(np.float32) * 0.01
    preds = {"theta": np.concatenate([np.full((5, 1), 0.9), rng.randn(5, 84) * 0.1], axis=1),
             "kp_2d": kp[..., :2], "verts": verts}
    target = {"kp_2d": kp}
    eq(TV.visualize_preds(images[0], {k: v[0] for k, v in preds.items()}, faces,
                          {"kp_2d": kp[0]}),
       JV.visualize_preds(images[0], {k: v[0] for k, v in preds.items()}, faces,
                          {"kp_2d": kp[0]}))
    eq(TV.batch_visualize_preds(images, preds, faces, target, max_images=2),
       JV.batch_visualize_preds(images, preds, faces, target, max_images=2))
    eq(TV.render_mesh_overlay(np.zeros((32, 40, 3), np.uint8), verts[1], preds["theta"][1], faces,
                              angle=90, axis=[0, 1, 0]),
       JV.render_mesh_overlay(np.zeros((32, 40, 3), np.uint8), verts[1], preds["theta"][1], faces,
                              angle=90, axis=[0, 1, 0]))
    assert TV.joint_names("spin") == JV.joint_names("spin")
    assert TV.COLORS == JV.COLORS
    assert {k: v.tolist() for k, v in TV.get_colors().items()} == \
        {k: v.tolist() for k, v in JV.get_colors().items()}


def test_visualize_sequence_matches_jax_and_names_matplotlib(monkeypatch):
    seq = np.random.RandomState(6).randn(1, 17 * 3) * 0.3
    eq(TV.visualize_sequence(seq), JV.visualize_sequence(seq))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        TV.visualize_sequence(seq)


# ------------------------------------------------------------- fbx

def test_fbx_keyframes_match_jax(monkeypatch, tmp_path):
    rng = np.random.RandomState(7)
    for aa in ([0, 0, 0], [0, 0, np.pi / 2], rng.randn(3), [1e-9, 0, 0]):
        eq(TFBX.rodrigues_to_quat(aa), JFBX.rodrigues_to_quat(aa))
    assert TFBX.BONE_NAMES == JFBX.BONE_NAMES
    poses = rng.randn(4, 72).astype(np.float32) * 0.3
    trans = rng.randn(4, 3).astype(np.float32)
    for kw in ({}, {"trans": trans}, {"trans": trans, "start_origin": True}):
        records = []
        for export in (JFBX.export_fbx, TFBX.export_fbx):
            bones = _install_fake_bpy(monkeypatch, pelvis_head=(0.0, 90.0, 1.0))
            export(poses, str(tmp_path / "o.fbx"), "template.fbx", fps=25, **kw)
            records.append({k: b.keyframes for k, b in bones.items()})
        assert records[0] == records[1], kw
    with pytest.raises(ValueError, match="frames"):
        _install_fake_bpy(monkeypatch)
        TFBX.export_fbx(poses, str(tmp_path / "o.fbx"), "t.fbx", trans=trans[:2])
    monkeypatch.setitem(sys.modules, "bpy", None)
    with pytest.raises(RuntimeError, match="bpy"):
        TFBX.export_fbx(poses, str(tmp_path / "o.fbx"), "t.fbx")


# ------------------------------------------------------------- image_io

def test_image_io_against_cv2(tmp_path):
    rng = np.random.RandomState(8)
    img = cv2.GaussianBlur(rng.randint(0, 256, (45, 61, 3), dtype=np.uint8), (5, 5), 2)
    jpg = str(tmp_path / "f.jpg")
    cv2.imwrite(jpg, img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    got = image_io.read_rgb(jpg)
    eq(got, native.decode(open(jpg, "rb").read()))
    # the native decoder against cv2's pixels of the same file (two libjpeg builds)
    assert np.abs(got.astype(int) - cv2.imread(jpg)[..., ::-1]).max() <= 3
    assert image_io.image_size(jpg) == (45, 61) and image_io.is_jpeg(jpg)
    png = str(tmp_path / "o.png")
    image_io.write_png(png, got)
    eq(cv2.imread(png, cv2.IMREAD_UNCHANGED)[..., ::-1], got)
    image_io.write_png(str(tmp_path / "o2.png"), got)
    assert open(png, "rb").read() == open(tmp_path / "o2.png", "rb").read()
    for name, call in (("read_rgb", image_io.read_rgb), ("image_size", image_io.image_size)):
        with pytest.raises(IOError, match="JPEG frames only"):
            call(png)
    with pytest.raises(ValueError, match="uint8"):
        image_io.write_png(png, got.astype(np.float32))


# ------------------------------------------------------------- the demo

CFG = """\
DEVICE: cpu
NUM_WORKERS: 0
DATASET:
  WIDTH: 32
  HEIGHT: 32
EVAL:
  SEQLEN: 2
  SAMPLE_POOL: 4
  BATCH_SIZE: 2
MODEL:
  ENCODER:
    NUM_BLOCKS: 1
    NUM_HEADS: 2
    SPA_TEMP_MODE: parallel
  DECODER:
    HIDDEN_DIM: 32
"""
N_FRAMES, FRAME_HW = 10, (48, 64)
# the synthetic body of the demo runs and the panels: the host rasterizer
# loops over the faces in Python (~0.7 s a 64 x 48 frame at 6890 vertices);
# test_renderer_matches_jax holds it on the 6890-vertex body
VERTS = 400


def args_of(**kw):
    base = dict(bbox_file="", staf_dir="", vid_file="", image_folder="")
    return types.SimpleNamespace(**dict(base, **kw))


def test_resolve_bboxes_places_track_by_video_frame(monkeypatch, tmp_path):
    """The counterpart of tests/test_demo.py's case on the port: STAF boxes
    land on the track's video frame ids (a track that starts late and skips
    a frame), gaps filled from the nearest tracked box, equal to JAX's;
    and the centred-square fallback takes the frame's size from its header."""
    import maed_tpu_torch.utils.pose_tracker as tpt

    kp = np.zeros((3, 5, 3), np.float32)
    for r, (cx, cy, s) in enumerate([(10, 10, 4), (20, 20, 4), (30, 30, 4)]):
        kp[r, 0] = (cx - s / 2, cy - s / 2, 1.0)
        kp[r, 1] = (cx + s / 2, cy + s / 2, 1.0)
    tracks = {0: {"joints2d": kp, "frames": np.array([4, 6, 7])}}
    monkeypatch.setattr(tpt, "run_posetracker", lambda *a, **k: tracks)
    monkeypatch.setattr(JPT, "run_posetracker", lambda *a, **k: tracks)
    args = args_of(staf_dir="/fake", vid_file="v.mp4")
    paths = [f"f{i}.jpg" for i in range(10)]
    boxes = tdemo.resolve_bboxes(args, paths)
    eq(boxes, jdemo.resolve_bboxes(args, paths))
    assert boxes.shape == (10, 4) and boxes[4, 0] < boxes[6, 0] < boxes[7, 0]
    eq(boxes[0], boxes[4])
    eq(boxes[9], boxes[7])
    assert boxes[5, 0] in (boxes[4, 0], boxes[6, 0])

    frame = str(tmp_path / "a.jpg")
    cv2.imwrite(frame, np.zeros((48, 64, 3), np.uint8))
    args = args_of()
    eq(tdemo.resolve_bboxes(args, [frame] * 3), jdemo.resolve_bboxes(args, [frame] * 3))
    eq(tdemo.resolve_bboxes(args, [frame])[0], [32, 24, 48, 48])
    np.save(tmp_path / "b.npy", np.ones((2, 4)))
    with pytest.raises(SystemExit, match="bbox_file shape"):
        tdemo.resolve_bboxes(args_of(bbox_file=str(tmp_path / "b.npy")), [frame] * 3)


def test_demo_refuses_frames_other_than_jpeg(tmp_path):
    cv2.imwrite(str(tmp_path / "0000.jpg"), np.zeros((8, 8, 3), np.uint8))
    cv2.imwrite(str(tmp_path / "0001.png"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(SystemExit, match="JPEG frames only"):
        tdemo.main(["--image_folder", str(tmp_path), "--output_folder", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="no images"):
        tdemo.collect_frames(args_of(image_folder=str(tmp_path / "o")))


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """JAX's demo.main and the port's, each in this process (argv patched),
    on the same frames, boxes, config and weights, both with --render."""
    tmp = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(9)
    imgs = tmp / "imgs"
    imgs.mkdir()
    for i in range(N_FRAMES):
        cv2.imwrite(str(imgs / f"{i:04d}.jpg"), cv2.GaussianBlur(
            rng.randint(0, 256, FRAME_HW + (3,), dtype=np.uint8), (5, 5), 1.5))
    boxes = np.concatenate([rng.uniform([26, 18], [38, 30], (N_FRAMES, 2)),
                            rng.uniform(28, 40, (N_FRAMES, 1)).repeat(2, 1)], 1).astype(np.float32)
    np.save(tmp / "boxes.npy", boxes)
    (tmp / "tiny.yaml").write_text(CFG)

    model = JMAED(encoder="ste", num_blocks=1, num_heads=2, st_mode="parallel", decoder="ktd",
                  hidden_dim=32, standardize_ws=False)
    x = np.zeros((1, 2, 32, 32, 3), np.float32)
    params = random_params(lambda: model.init(jax.random.PRNGKey(0), x, j_synthetic_smpl(64, 0)), 3)
    sd = convert_params_to_state_dict(params, {}, prefix="module.")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": sd}, tmp / "weights.pth.tar")
    common = ["--image_folder", str(imgs), "--cfg", str(tmp / "tiny.yaml"), "--checkpoint",
              str(tmp / "weights.pth.tar"), "--bbox_file", str(tmp / "boxes.npy"), "--render",
              "--allow_synthetic_smpl"]

    written = {}

    def recording_imwrite(path, img, *a):
        written[os.path.basename(path)] = img.copy()
        return real_imwrite(path, img, *a)

    def zero_init(self, *a, **kw):
        # the parameters' shapes: the checkpoint replaces every value (an
        # init runs the model op by op, ~45 s at this size)
        return {"params": jax.tree.map(np.zeros_like, params)}

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)  # no data/smpl_data here: both sides take the synthetic body
        for mod, make in ((j_smpl_io, j_synthetic_smpl), (t_smpl_io, t_synthetic_smpl)):
            mp.setattr(mod, "synthetic_smpl_model",
                       lambda num_verts, make=make, **kw: make(VERTS, **kw))
        real_imwrite = cv2.imwrite
        mp.setattr(cv2, "imwrite", recording_imwrite)
        mp.setattr(JMAED, "init", zero_init)
        mp.setattr(sys, "argv", ["demo.py", *common, "--output_folder", str(tmp / "jax")])
        jdemo.main()
        mp.undo()
        mp.chdir(tmp)
        for mod, make in ((j_smpl_io, j_synthetic_smpl), (t_smpl_io, t_synthetic_smpl)):
            mp.setattr(mod, "synthetic_smpl_model",
                       lambda num_verts, make=make, **kw: make(VERTS, **kw))
        tdemo.main([*common, "--output_folder", str(tmp / "port")])
    return tmp, boxes, written


def read_pkl(path):
    import joblib

    return {k: np.asarray(v) for k, v in joblib.load(path).items()}


def test_demo_matches_jax(demo_runs):
    tmp, boxes, written = demo_runs
    want, got = read_pkl(tmp / "jax" / "inference.pkl"), read_pkl(tmp / "port" / "inference.pkl")
    assert sorted(got) == sorted(want) == ["bboxes", "paths", "pred_theta", "pred_verts"]
    assert got["pred_theta"].shape == (N_FRAMES, 85)
    assert got["pred_verts"].shape == (N_FRAMES, VERTS, 3)
    for key in ("pred_theta", "pred_verts"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, rtol=1e-3, err_msg=key)
    eq(got["bboxes"], want["bboxes"])
    eq(got["bboxes"], boxes)
    eq(got["paths"], want["paths"])
    overlays = sorted(os.listdir(tmp / "port" / "overlay"))
    assert overlays == [f"{i:06d}_{i:04d}.png" for i in range(N_FRAMES)]
    assert sorted(written) == [f"{i:06d}_{i:04d}.jpg" for i in range(N_FRAMES)]


def test_visualize_renders_jax_inference_as_jax_does(demo_runs, monkeypatch):
    """``python -m maed_tpu_torch.visualize`` on the JAX demo's inference.pkl:
    each PNG, read back by cv2, holds the pixels JAX's render_inference_pkl
    handed cv2.imwrite (before its JPEG encoding), bit for bit."""
    tmp, _, written = demo_runs
    monkeypatch.chdir(tmp)
    monkeypatch.setattr(t_smpl_io, "synthetic_smpl_model",
                        lambda num_verts, **kw: t_synthetic_smpl(VERTS, **kw))
    out = tmp / "vis"
    tvis.main(["--input_file", str(tmp / "jax" / "inference.pkl"), "--output_folder", str(out),
               "--allow_synthetic_smpl"])
    for name, want in written.items():
        eq(cv2.imread(str(out / name.replace(".jpg", ".png"))), want, err_msg=name)
    with pytest.raises(FileNotFoundError, match="SMPL body model not found"):
        tvis.render_inference_pkl(str(tmp / "jax" / "inference.pkl"), str(tmp / "refused"))
