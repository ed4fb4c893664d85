"""maed_tpu_torch imports and runs without JAX, flax, triton, pyyaml, cv2,
joblib or PIL, as it must on the machine with the card (which has no JAX and
is promised none of the others): a fresh interpreter in which importing any
of them fails imports every module of the port, maps a flax parameter tree
onto the port's state_dict, runs the tiny eval forward of a parallel and of
a coupling model on the CPU, drives ``core.evaluate.Evaluator.run`` over
the coupling one and takes one stage-2 train step (``build_train_model``,
``make_optimizer``, ``make_train_step``: both forwards, the backward
through the kernels' autograd Functions, the Adam update), and the same
step of a ``remat=True`` model, whose losses are the same, and the same
step again through the tensor-parallel layer (``parallel.mesh.make_mesh``
at tp = 1 in a one-process gloo group, the model built with that mesh),
whose losses are the same too. Then it runs
``python -m maed_tpu_torch.train`` on a tiny config (``DEVICE cpu``, 2
iterations, 1 epoch) over synthetic DBs written as plain pickles, whose
frames are the JPEGs of tests/torch_port_data, and
``python -m maed_tpu_torch.eval`` on its model_best.pth.tar, which writes
inference.pkl. A second interpreter, with the same modules blocked, runs
stage 1 (``test_stage1_runs_without_jax``), a third exports an artifact
and serves it from a fresh interpreter that loads no model code
(``test_serving_needs_neither_jax_nor_model_code``), a fourth, with
matplotlib blocked too, runs the demo, visualize, a preprocessor and the
tools ``accept_synthetic`` and ``bench_train``
(``test_demo_visualize_and_preprocess_run_without_jax``). In the end no
module of maed_tpu, jax, flax, triton, yaml, cv2, joblib or PIL is loaded."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

BLOCKED = ("maed_tpu", "jax", "flax", "triton", "yaml", "cv2", "joblib", "PIL")

SCRIPT = """
import importlib, pkgutil, sys
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)  # tiny shapes: the thread pool would only contend with other workers
import maed_tpu_torch
for mod in pkgutil.walk_packages(maed_tpu_torch.__path__, "maed_tpu_torch."):
    importlib.import_module(mod.name)
from maed_tpu_torch.core.builder import build_eval_model
clips = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 2, 32, 32, 3),
                                                          dtype=np.uint8))
for st_mode in ("parallel", "coupling"):  # the coupling model is kept for Evaluator.run
    model, smpl = build_eval_model(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32,
                                   st_mode=st_mode, dtype=torch.float32, device="cpu", seed=0,
                                   allow_synthetic_smpl=True, smpl_dir="absent")
    out = model(clips, smpl, J_regressor=torch.full((14, 6890), 1 / 6890))
    assert out["verts"].shape == (1, 2, 6890, 3) and out["kp_3d"].shape == (1, 2, 14, 3)
    assert all(torch.isfinite(v).all() for v in out.values()), st_mode
from maed_tpu_torch.utils.weights import state_dict_from_jax
tree = {"encoder": {"blocks_0": {"attn": {"qkv": {"kernel": np.ones((4, 12), np.float32)}},
                                 "norm1": {"scale": np.ones(4, np.float32)}}},
        "decoder": {"joint_reg3": {"bias": np.zeros(6, np.float32)}}}
sd = state_dict_from_jax(tree)
assert sorted(sd) == ["decoder.joint_regs.3.bias", "encoder.blocks.0.attn.qkv.weight",
                      "encoder.blocks.0.norm1.weight"]
assert sd["encoder.blocks.0.attn.qkv.weight"].shape == (12, 4)
from maed_tpu_torch.core.evaluate import Evaluator
rng = np.random.RandomState(1)
kp3d = np.concatenate([rng.randn(3, 4, 14, 3), np.ones((3, 4, 14, 1))], -1).astype(np.float32)
theta = (rng.randn(3, 4, 85) * 0.1).astype(np.float32)
window = {"images": rng.randint(0, 256, (3, 4, 32, 32, 3), dtype=np.uint8), "kp_3d": kp3d,
          "kp_2d": kp3d[..., :3], "theta": theta, "valid": rng.rand(3, 4) < 0.8}
jreg = rng.rand(17, 6890).astype(np.float32) ** 8  # distinct joints: a constant set aligns to NaN
jreg /= jreg.sum(axis=1, keepdims=True)
metrics, poses = Evaluator(smpl).run(lambda x, j: model(x, smpl, J_regressor=j), [window],
                                     seqlen=2, dataset_name="3dpw", J_regressor=jreg,
                                     batch_size=4, verbose=False)
assert poses == window["valid"].sum() and len(metrics) == 5
assert all(np.isfinite(v) for v in metrics.values()), metrics
from maed_tpu_torch.core.builder import build_train_model
from maed_tpu_torch.core.loss import LossWeights
from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step
model, smpl = build_train_model(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32,
                                device="cpu", seed=0, allow_synthetic_smpl=True, smpl_dir="absent")
class Optim:
    OPTIM, LR, WD, MOMENTUM, WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES = "adam", 1e-3, 0.0, 0.9, 1, 0.1, [3]
before = [p.detach().clone() for p in model.parameters()]
step = make_train_step(model, make_optimizer(Optim, 10, model.parameters()), smpl, LossWeights(),
                       torch.Generator().manual_seed(0))
kp = lambda *shape: torch.cat([torch.randn(*shape, 3), torch.ones(*shape, 1)], -1)
vid = {"images": torch.randint(0, 256, (2, 2, 32, 32, 3), dtype=torch.uint8),
       "target_2d": {"kp_2d": kp(1, 2, 49)[..., 1:]},
       "target_3d": {"kp_2d": kp(1, 2, 49)[..., 1:], "kp_3d": kp(1, 2, 49),
                     "theta": torch.randn(1, 2, 85) * 0.1, "w_smpl": torch.ones(1, 2)}}
img = {"image": torch.randint(0, 256, (1, 32, 32, 3), dtype=torch.uint8),
       "kp_2d": kp(1, 49)[..., 1:], "kp_3d": kp(1, 49), "theta": torch.randn(1, 85) * 0.1}
out = step(vid, img)
assert all(torch.isfinite(v) for v in out.values()), out
assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()) if b.grad.abs().sum() > 0)
model, smpl = build_train_model(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32,
                                device="cpu", seed=0, allow_synthetic_smpl=True, smpl_dir="absent",
                                remat=True)
step = make_train_step(model, make_optimizer(Optim, 10, model.parameters()), smpl, LossWeights(),
                       torch.Generator().manual_seed(0))
remat_out = step(vid, img)
assert all(torch.equal(remat_out[k], out[k]) for k in out), (remat_out, out)
import socket
import torch.distributed as tdist
from maed_tpu_torch.parallel import dist as pdist
from maed_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_state_dict
with socket.socket() as sock:
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
mesh = make_mesh(tp=1)
model, smpl = build_train_model(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32,
                                device="cpu", seed=0, allow_synthetic_smpl=True, smpl_dir="absent",
                                mesh=mesh)
step = make_train_step(model, make_optimizer(Optim, 10, model.parameters()), smpl, LossWeights(),
                       torch.Generator().manual_seed(mesh.data_rank))
mesh_out = step(vid, img)
assert all(torch.equal(mesh_out[k], out[k]) for k in out), (mesh_out, out)
half = shard_state_dict(model.state_dict(), Mesh(1, 1, 2, rank=1))
assert half["encoder.blocks.0.attn.qkv.weight"].shape == (1152, 768)
assert half["encoder.blocks.0.mlp.fc2.weight"].shape == (768, 1536)
pdist.shutdown()

import glob, os, pickle, runpy
os.makedirs("data/database")
frames = sorted(glob.glob(os.path.join(FIXTURES, "frame_*.jpg")))
def video_db(n, seed, with_3d=True):
    rng = np.random.RandomState(seed)
    db = {"vid_name": np.array(["a"] * (n // 2) + ["b"] * (n - n // 2)),
          "img_name": np.array([frames[i % len(frames)] for i in range(n)]),
          "frame_id": np.arange(n), "bbox": np.tile([240.0, 180.0, 150.0, 150.0], (n, 1)),
          "joints2D": np.concatenate([rng.rand(n, 49, 2) * 300, np.ones((n, 49, 1))], -1)}
    if with_3d:
        db["joints3D"] = np.concatenate([rng.randn(n, 49, 3) * 0.3, np.ones((n, 49, 1))], -1)
        db["pose"], db["shape"] = rng.randn(n, 72) * 0.2, rng.randn(n, 10) * 0.5
    return db
dbs = {"syn2d_train": video_db(12, 0, False), "syn3d_train": video_db(12, 1),
       "3dpw_val": video_db(12, 2), "synimg_train": {k: v for k, v in video_db(6, 3).items()
                                                      if k not in ("vid_name", "frame_id")}}
for name, db in dbs.items():
    with open(f"data/database/{name}_db.pt", "wb") as f:
        pickle.dump(db, f)
open("tiny.yaml", "w").write(CONFIG)
def cli(module, *argv):
    sys.argv = [module, "--cfg", "tiny.yaml", "--allow_synthetic_smpl", *argv]
    runpy.run_module(module, run_name="__main__")
cli("maed_tpu_torch.train")
(logdir,) = glob.glob("results/*_tiny")
names = sorted(os.listdir(logdir))
events = [n for n in names if n.startswith("events.out.tfevents.")]  # the TensorBoard file
assert len(events) == 1 and [n for n in names if n not in events] == [
    "best.txt", "config.yaml", "epoch_0.pth.tar", "model_best.pth.tar", "train_log.txt",
    "train_metrics.jsonl"]
cli("maed_tpu_torch.eval", "--checkpoint", os.path.join(logdir, "model_best.pth.tar"),
    "--eval_ds", "3dpw", "--eval_set", "val", "--output_path", "out")
with open("out/inference.pkl", "rb") as f:
    out = pickle.load(f)
assert sorted(out) == ["bboxes", "paths", "pred_theta", "pred_verts"], sorted(out)
assert not [name for name, mod in sys.modules.items()
            if mod is not None and name.split(".")[0] in BLOCKED]
print("NOJAX_OK")
"""

CONFIG = """\
DEVICE: cpu
EXP_NAME: tiny
NUM_WORKERS: 0
SEED_VALUE: 1
SAVE_FREQ: 1
DATASET:
  WIDTH: 32
  HEIGHT: 32
  SEQLEN: 4
  SAMPLE_POOL: 4
EVAL:
  SEQLEN: 4
  SAMPLE_POOL: 8
  BATCH_SIZE: 2
TRAIN:
  BATCH_SIZE_2D: 1
  BATCH_SIZE_3D: 1
  BATCH_SIZE_IMG: 1
  NUM_ITERS_PER_EPOCH: 2
  END_EPOCH: 1
  DATASETS_2D: [syn2d]
  DATASETS_3D: [syn3d]
  DATASETS_IMG: [synimg]
  DATASET_EVAL: 3dpw
MODEL:
  ENCODER:
    NUM_BLOCKS: 1
    NUM_HEADS: 2
    SPA_TEMP_MODE: parallel
  DECODER:
    HIDDEN_DIM: 32
"""


STAGE1_SCRIPT = """
import sys
for name in BLOCKED:
    sys.modules[name] = None
import glob, os, pickle, runpy
import numpy as np
import torch
torch.set_num_threads(1)
from maed_tpu_torch.core.builder import build_eval_model, build_train_model
from maed_tpu_torch.core.loss import LossWeights
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step
from maed_tpu_torch.utils.pretrained import apply_pretrained_backbone
from maed_tpu_torch.utils.weights import state_dict_from_jax
kw = dict(hidden_dim=32, img_size=32, device="cpu", seed=0, allow_synthetic_smpl=True,
          smpl_dir="absent")
clips = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 2, 32, 32, 3),
                                                          dtype=np.uint8))
for decoder in ("ktd", "iterative"):
    model, smpl = build_eval_model(encoder="cnn", decoder=decoder, dtype=torch.bfloat16, **kw)
    out = model(clips, smpl)
    assert out["verts"].shape == (1, 2, 6890, 3), decoder
    assert all(torch.isfinite(v.float()).all() for v in out.values()), decoder
model, smpl = build_train_model(encoder="cnn", decoder="ktd", **kw)
class Optim:
    OPTIM, LR, WD, MOMENTUM = "adam", 1e-3, 0.0, 0.9
    WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES = 0, 0.1, [3]
step = make_train_step(model, make_optimizer(Optim, 10, model.parameters()), smpl, LossWeights(),
                       torch.Generator().manual_seed(0))
kp = lambda *shape: torch.cat([torch.randn(*shape, 3), torch.ones(*shape, 1)], -1)
img = {"image": torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8),
       "kp_2d": kp(2, 49)[..., 1:], "kp_3d": kp(2, 49), "theta": torch.randn(2, 85) * 0.1,
       "w_smpl": torch.ones(2)}
import socket
from maed_tpu_torch.parallel import dist
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                  MASTER_PORT=str(port))
assert dist.init_from_env(cpu=True) == (0, 1) and dist.initialized()
out = step(None, img)  # BatchNorm over the moments of a group of one
assert all(torch.isfinite(v) for v in out.values()), out
assert int(model.encoder.bn1.num_batches_tracked) == 1
assert dist.broadcast_str_from_rank0("x") == "x" and dist.any_rank(True)
assert dist.weighted_mean({"mpjpe": 2.0}, 3) == ({"mpjpe": 2.0}, 3)
assert dist.gather_objects(7) == [7]
tree = {"encoder": {"layer2_0": {"downsample_bn": {"scale": np.ones(8, np.float32)}}},
        "decoder": {"decpose": {"kernel": np.ones((4, 144), np.float32)}}}
stats = {"encoder": {"layer2_0": {"downsample_bn": {"mean": np.zeros(8, np.float32),
                                                    "var": np.ones(8, np.float32)}}}}
sd = state_dict_from_jax(tree, stats)
assert sorted(sd) == ["decoder.decpose.weight", "encoder.layer2.0.downsample.1.num_batches_tracked",
                      "encoder.layer2.0.downsample.1.running_mean",
                      "encoder.layer2.0.downsample.1.running_var",
                      "encoder.layer2.0.downsample.1.weight"], sorted(sd)
rng = np.random.RandomState(1)
npz = {"cls": rng.randn(1, 1, 768).astype(np.float32),
       "Transformer/encoderblock_0/LayerNorm_0/scale": rng.randn(768).astype(np.float32)}
for n in ("query", "key", "value"):
    npz[f"Transformer/encoderblock_0/MultiHeadDotProductAttention_1/{n}/kernel"] = (
        rng.randn(768, 2, 384).astype(np.float32))
    npz[f"Transformer/encoderblock_0/MultiHeadDotProductAttention_1/{n}/bias"] = (
        rng.randn(2, 384).astype(np.float32))
np.savez("in21k.npz", **npz)
stage2 = MAED(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32)
apply_pretrained_backbone(stage2, "in21k.npz")
assert torch.equal(stage2.encoder.cls_token, torch.from_numpy(npz["cls"]))
q = npz["Transformer/encoderblock_0/MultiHeadDotProductAttention_1/query/kernel"]
qkv = stage2.encoder.blocks[0].attn.qkv.weight
assert torch.equal(qkv[:768], torch.from_numpy(q.reshape(768, -1).T))
torch.save({"norm.weight": torch.full((768,), 2.0), "head.weight": torch.ones(3, 768)}, "in21k.pth")
apply_pretrained_backbone(stage2, "in21k.pth")
assert torch.equal(stage2.encoder.norm.weight, torch.full((768,), 2.0))

os.makedirs("data/database")
frames = sorted(glob.glob(os.path.join(FIXTURES, "frame_*.jpg")))
def db(n, seed, video):
    rng = np.random.RandomState(seed)
    d = {"img_name": np.array([frames[i % len(frames)] for i in range(n)]),
         "bbox": np.tile([240.0, 180.0, 150.0, 150.0], (n, 1)),
         "joints2D": np.concatenate([rng.rand(n, 49, 2) * 300, np.ones((n, 49, 1))], -1),
         "joints3D": np.concatenate([rng.randn(n, 49, 3) * 0.3, np.ones((n, 49, 1))], -1),
         "pose": rng.randn(n, 72) * 0.2, "shape": rng.randn(n, 10) * 0.5}
    if video:
        d["vid_name"], d["frame_id"] = np.array(["a"] * n), np.arange(n)
    return d
for name, d in {"synimg_train": db(8, 0, False), "3dpw_val": db(8, 1, True)}.items():
    with open(f"data/database/{name}_db.pt", "wb") as f:
        pickle.dump(d, f)
open("tiny1.yaml", "w").write(CONFIG)
def cli(module, *argv):
    sys.argv = [module, "--cfg", "tiny1.yaml", "--allow_synthetic_smpl", *argv]
    runpy.run_module(module, run_name="__main__")
cli("maed_tpu_torch.train")  # in the group of one that RANK and WORLD_SIZE describe
assert not dist.initialized()
del os.environ["RANK"], os.environ["WORLD_SIZE"]
(logdir,) = glob.glob("results/*_tiny1")
best = torch.load(os.path.join(logdir, "model_best.pth.tar"), weights_only=True)["state_dict"]
assert int(best["encoder.layer4.2.bn3.num_batches_tracked"]) == 2
cli("maed_tpu_torch.eval", "--checkpoint", os.path.join(logdir, "model_best.pth.tar"),
    "--eval_ds", "3dpw", "--eval_set", "val")
assert not [name for name, mod in sys.modules.items()
            if mod is not None and name.split(".")[0] in BLOCKED]
print("NOJAX_OK")
"""

SERVE_SCRIPT = """
import sys
for name in BLOCKED:
    sys.modules[name] = None
import runpy, subprocess
import numpy as np
import torch
torch.set_num_threads(1)
open("tiny.yaml", "w").write(CONFIG)
sys.argv = ["maed_tpu_torch.utils.export", "--cfg", "tiny.yaml", "--out", "m.pt2", "--batch", "2",
            "--device", "cpu", "--dtype", "f32", "--eval_ds", "", "--allow_synthetic_smpl"]
runpy.run_module("maed_tpu_torch.utils.export", run_name="__main__")
from maed_tpu_torch.core.builder import build_eval_model  # the CLI's model: the config's seed
model, smpl = build_eval_model(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32, seed=1,
                               dtype=torch.float32, device="cpu", allow_synthetic_smpl=True)
clips = np.random.RandomState(2).randint(0, 256, (2, 4, 32, 32, 3)).astype(np.uint8)
np.save("clips.npy", clips)
np.savez("want.npz", **{k: v.numpy() for k, v in model(torch.from_numpy(clips), smpl).items()})
serving = '''
import sys
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)  # as the eager run: the CPU's sums follow the thread count
from maed_tpu_torch.serve import ModelHost
host = ModelHost("m.pt2")
host.warmup()
got, want = host.predict(np.load("clips.npy")[:1]), np.load("want.npz")
assert all(np.array_equal(got[k], want[k][:1]) for k in want), "not the eager answer"
port = sorted(m for m in sys.modules if m.startswith("maed_tpu_torch"))
assert not [m for m in port if m.startswith(("maed_tpu_torch.models", "maed_tpu_torch.core"))], port
assert not [m for m, mod in sys.modules.items() if mod is not None and m.split(".")[0] in BLOCKED]
print("SERVED", port)
'''
done = subprocess.run([sys.executable, "-c", f"BLOCKED = {BLOCKED!r}" + serving],
                      capture_output=True, text=True)
assert done.returncode == 0 and "SERVED" in done.stdout, done.stderr[-3000:]
assert not [name for name, mod in sys.modules.items()
            if mod is not None and name.split(".")[0] in BLOCKED]
print("NOJAX_OK")
"""

DEMO_SCRIPT = """
import sys
for name in BLOCKED + ("matplotlib",):
    sys.modules[name] = None
import glob, json, os, pickle, runpy, shutil
import numpy as np
import torch
torch.set_num_threads(1)
os.makedirs("frames")
for i, src in enumerate(sorted(glob.glob(os.path.join(FIXTURES, "frame_*.jpg")))):
    shutil.copy(src, f"frames/{i:06d}.jpg")
np.save("boxes.npy", np.tile([240.0, 180.0, 200.0, 200.0], (4, 1)))
open("tiny.yaml", "w").write(CONFIG)
def run(module, *argv):
    sys.argv = [module, *argv]
    runpy.run_module(module, run_name="__main__")
run("maed_tpu_torch.demo", "--image_folder", "frames", "--cfg", "tiny.yaml", "--bbox_file",
    "boxes.npy", "--output_folder", "out", "--render", "--allow_synthetic_smpl")
with open("out/inference.pkl", "rb") as f:
    pred = pickle.load(f)
assert pred["pred_verts"].shape == (4, 6890, 3) and np.isfinite(pred["pred_theta"]).all()
overlays = sorted(os.listdir("out/overlay"))
assert overlays == [f"{i:06d}_{i:06d}.png" for i in range(4)], overlays
run("maed_tpu_torch.visualize", "--input_file", "out/inference.pkl", "--output_folder", "vis",
    "--allow_synthetic_smpl")
assert all(open(f"vis/{n}", "rb").read() == open(f"out/overlay/{n}", "rb").read()
           for n in overlays)
ann = "posetrack/posetrack_data/annotations/train"
os.makedirs(ann)
names = ["nose", "head_bottom", "head_top", "left_ear", "right_ear", "left_shoulder",
         "right_shoulder", "left_elbow", "right_elbow", "left_wrist", "right_wrist", "left_hip",
         "right_hip", "left_knee", "right_knee", "left_ankle", "right_ankle"]
rng = np.random.RandomState(0)
json.dump({"images": [{"frame_id": i, "file_name": f"{i}.jpg", "is_labeled": True}
                      for i in range(9)],
           "annotations": [{"track_id": 1, "image_id": i, "bbox": [10.0, 20.0, 50.0, 90.0],
                            "keypoints": rng.uniform(1, 100, 51).tolist()} for i in range(9)],
           "categories": [{"keypoints": names}]}, open(f"{ann}/000001_mpii.json", "w"))
run("maed_tpu_torch.data.preprocess.posetrack", "--inp_dir", "posetrack", "--out_dir", ".")
with open("posetrack_train_db.pt", "rb") as f:
    db = pickle.load(f)
assert db["joints2D"].shape == (9, 49, 3) and db["bbox"].shape == (9, 4)
for phase in ("generate", "oracle"):
    run("maed_tpu_torch.tools.accept_synthetic", phase, "--out", "synacc", "--device", "cpu",
        "--videos", "1", "--frames", "24", "--size", "48")
with open("synacc/data/database/synacc_val_db.pt", "rb") as f:
    assert pickle.load(f)["joints3D"].shape == (48, 49, 4)
run("maed_tpu_torch.tools.bench_train", "--learn", "2", "--smoke", "--device", "cpu", "--dtype",
    "f32", "--out", "soak.json")
assert len(json.load(open("soak.json"))["losses"]) == 2
assert not [name for name, mod in sys.modules.items()
            if mod is not None and name.split(".")[0] in BLOCKED + ("matplotlib",)]
print("NOJAX_OK")
"""

DEMO_CONFIG = """\
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
  DECODER:
    HIDDEN_DIM: 32
"""


STAGE1_CONFIG = """\
DEVICE: cpu
EXP_NAME: tiny1
NUM_WORKERS: 0
SEED_VALUE: 1
SAVE_FREQ: 1
DATASET:
  WIDTH: 32
  HEIGHT: 32
  SEQLEN: 4
  SAMPLE_POOL: 4
EVAL:
  SEQLEN: 4
  SAMPLE_POOL: 8
  BATCH_SIZE: 2
TRAIN:
  BATCH_SIZE_2D: 0
  BATCH_SIZE_3D: 0
  BATCH_SIZE_IMG: 2
  NUM_ITERS_PER_EPOCH: 2
  END_EPOCH: 1
  DATASETS_2D: []
  DATASETS_3D: []
  DATASETS_IMG: [synimg]
  DATASET_EVAL: 3dpw
MODEL:
  ENCODER:
    BACKBONE: cnn
  DECODER:
    BACKBONE: ktd
    HIDDEN_DIM: 32
"""


def start_blocked(tmp_path, script, config):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    script = (f"BLOCKED = {BLOCKED!r}\nFIXTURES = {str(REPO / 'tests' / 'torch_port_data')!r}\n"
              f"CONFIG = {config!r}\n" + script)
    return subprocess.Popen([sys.executable, "-c", script], cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def blocked_runs(tmp_path_factory):
    """The interpreters, started at once."""
    return {name: start_blocked(tmp_path_factory.mktemp(name), script, config)
            for name, script, config in (("stage2", SCRIPT, CONFIG),
                                         ("stage1", STAGE1_SCRIPT, STAGE1_CONFIG),
                                         ("serve", SERVE_SCRIPT, CONFIG),
                                         ("demo", DEMO_SCRIPT, DEMO_CONFIG))}


def finish_blocked(proc):
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert "NOJAX_OK" in out


def test_stage1_runs_without_jax(blocked_runs):
    """Stage 1 with the same modules blocked: the bf16 eval forward of cnn +
    ktd and cnn + iterative, one image-only train step of cnn + ktd in a
    one-rank gloo group (``parallel.dist``: its BatchNorm takes the group's
    moments and counts the batch; the group's collectives), a cnn /
    iterative tree and its batch_stats mapped to the port's names, the
    published-backbone import from an .npz and a .pth, and ``python -m
    maed_tpu_torch.train`` on a tiny stage-1 config in that group, then the
    eval CLI on its model_best.pth.tar."""
    finish_blocked(blocked_runs["stage1"])


def test_port_runs_without_jax(blocked_runs):
    finish_blocked(blocked_runs["stage2"])


def test_serving_needs_neither_jax_nor_model_code(blocked_runs):
    """With the same modules blocked: ``python -m maed_tpu_torch.utils.export``
    on the tiny config (``--device cpu``), then in a fresh interpreter, also
    blocked, ``serve.ModelHost`` over the artifact: its answer is the eager
    model's bit for bit, and no module of ``maed_tpu_torch.models`` or
    ``maed_tpu_torch.core`` was loaded to give it."""
    finish_blocked(blocked_runs["serve"])


def test_demo_visualize_and_preprocess_run_without_jax(blocked_runs):
    """With the same modules and matplotlib blocked: ``python -m
    maed_tpu_torch.demo --render`` on the fixture JPEGs and a tiny ``DEVICE
    cpu`` config (inference.pkl as a plain pickle, an overlay PNG a frame),
    ``python -m maed_tpu_torch.visualize`` on its inference.pkl (the same
    PNGs, byte for byte), ``python -m
    maed_tpu_torch.data.preprocess.posetrack`` on a one-track fixture, and
    the two tools: ``accept_synthetic generate`` and ``oracle`` (1 + 2
    videos of 24 frames at 48 px: the JPEG encoder, the DBs as plain
    pickles) and ``bench_train --learn 2 --smoke`` in f32."""
    finish_blocked(blocked_runs["demo"])
