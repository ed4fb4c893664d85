"""maed_tpu_torch imports and runs without JAX, flax or triton, as it must on
the machine with the card (which has no JAX): a fresh interpreter in which
importing any of them fails imports every module of the port, maps a flax
parameter tree onto the port's state_dict, runs the tiny eval forward of a
parallel and of a coupling model on the CPU and drives
``core.evaluate.Evaluator.run`` over the coupling one; in the end no module of
maed_tpu, jax, flax or triton is loaded."""

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
