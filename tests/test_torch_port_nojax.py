"""maed_tpu_torch imports and runs without JAX, flax or triton, as it must on
the machine with the card (which has no JAX): a fresh interpreter in which
importing any of them fails imports every module of the port, maps a flax
parameter tree onto the port's state_dict, runs the tiny eval forward of a
parallel and of a coupling model on the CPU, drives
``core.evaluate.Evaluator.run`` over the coupling one and takes one stage-2
train step (``build_train_model``, ``make_optimizer``, ``make_train_step``:
both forwards, the backward through the kernels' autograd Functions, the
Adam update); in the end no module of maed_tpu, jax, flax or triton is
loaded."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = sys.modules["flax"] = sys.modules["triton"] = None
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
assert not [name for name, mod in sys.modules.items()
            if mod is not None and name.split(".")[0] in ("maed_tpu", "jax", "flax", "triton")]
print("NOJAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
