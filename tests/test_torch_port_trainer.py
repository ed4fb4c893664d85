"""maed_tpu_torch's trainer, checkpoints and CLIs on the CPU, at a tiny
config: 1 block, 2 heads of 384 (the port's MAED, like the JAX one, has the
fixed embedding width 768), KTD hidden 32, 32^2 crops, T 4; one 2D clip,
one 3D clip and one image a step, over ``tests/fixtures.py``'s synthetic
DBs written as plain pickles. The trainer runs through
``maed_tpu_torch.train.main`` in this process (``DEVICE cpu``).

- the losses the Trainer records equal direct calls of its step on the same
  batches, bit for bit;
- a SIGTERM after the first iteration, then ``TRAIN.RESUME auto``, ends with
  the parameters, the optimizer state and every step's losses of the
  uninterrupted run, bit for bit;
- validation equals a direct ``Evaluator.run`` over the same loader;
- a NaN loss exits with the JAX package's message;
- checkpoints: a round trip restores every field bit for bit, also through
  ``Trainer.resume``; a temporary file never wins ``find_auto_resume``;
  pruning keeps model_best; each of the three load policies (stage-2
  init, eval, resume) gets a case, the eval one also on the reference-layout
  file ``maed_tpu.utils.torch_convert`` writes from JAX parameters;
- ``Evaluator.run(save_path=...)`` writes inference.pkl, with joblib and,
  where joblib is absent, as a plain pickle.
"""

import json
import os
import pickle
import signal
import sys
from pathlib import Path

import joblib
import numpy as np
import pytest
import torch

from fixtures import make_image_db, make_video_db
from maed_tpu.utils.torch_convert import convert_params_to_state_dict, convert_state_dict
from maed_tpu_torch import train as train_cli
from maed_tpu_torch.core.builder import build_eval_model, load_weights
from maed_tpu_torch.core.evaluate import Evaluator
from maed_tpu_torch.parallel import train_step as train_step_module
from maed_tpu_torch.utils import checkpoint as ckpt
from maed_tpu_torch.utils.weights import state_dict_from_jax

TINY_EVAL = dict(num_blocks=1, num_heads=2, hidden_dim=32, img_size=32, dtype=torch.float32,
                 device="cpu", allow_synthetic_smpl=True, smpl_dir="absent")
CFG = """\
DEVICE: cpu
EXP_NAME: tiny
NUM_WORKERS: 0
DEBUG_FREQ: 1
SEED_VALUE: 1
SAVE_FREQ: 1
DATASET:
  SEQLEN: 4
  SAMPLE_POOL: 4
  WIDTH: 32
  HEIGHT: 32
  RANDOM_SAMPLE: false
  RANDOM_START: true
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
  DATASETS_2D: ['syn2d']
  DATASETS_3D: ['syn3d']
  DATASETS_IMG: ['synimg']
  DATASET_EVAL: '3dpw'
  OPTIM:
    WARMUP_EPOCH: 0
MODEL:
  ENCODER:
    NUM_BLOCKS: 1
    NUM_HEADS: 2
    SPA_TEMP_MODE: parallel
  DECODER:
    HIDDEN_DIM: 32
"""


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory with the config and the DBs under data/database;
    the checkpoints written under it are removed at the end."""
    d = tmp_path_factory.mktemp("trainer")
    (d / "data" / "database").mkdir(parents=True)
    dbs = {"syn2d_train": make_video_db(d / "f2", 2, 12, 48, seed=0, with_3d=False, with_smpl=False),
           "syn3d_train": make_video_db(d / "f3", 2, 12, 48, seed=1),
           "3dpw_val": make_video_db(d / "fv", 2, 12, 48, seed=2),
           "synimg_train": make_image_db(d / "fi", 6, 48)}
    for name, db in dbs.items():
        with open(d / "data" / "database" / f"{name}_db.pt", "wb") as f:
            pickle.dump(db, f)
    (d / "tiny.yaml").write_text(CFG)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # tiny ops: a thread pool only contends with the other workers
    yield d
    torch.set_num_threads(threads)
    for path in d.rglob("*.pth.tar"):
        path.unlink()


def run(workdir, monkeypatch, out, *opts, step_wrapper=None):
    """``python -m maed_tpu_torch.train`` in this process with OUTPUT_DIR
    ``<workdir>/<out>``; returns the trainer."""
    monkeypatch.chdir(workdir)
    if step_wrapper is not None:
        make = train_step_module.make_train_step
        monkeypatch.setattr(train_step_module, "make_train_step",
                            lambda *a, **k: step_wrapper(make(*a, **k)))
    return train_cli.main(["--cfg", "tiny.yaml", "--allow_synthetic_smpl",
                           "OUTPUT_DIR", str(workdir / out), *opts])


def records(logdir):
    with open(Path(logdir) / "train_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def step_records(logdir):
    return [r for r in records(logdir) if "loss" in r]


def assert_state_equal(a, b, path="state"):
    """Two nested checkpoint states equal bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_state_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b or (a != a and b != b), (path, a, b)


@pytest.fixture(scope="module")
def uninterrupted(workdir):
    mp = pytest.MonkeyPatch()
    try:
        trainer = run(workdir, mp, "results_u")
    finally:
        mp.undo()
    return trainer


def test_trainer_records_the_steps_losses(workdir, monkeypatch, uninterrupted):
    """A trainer built the same way, driven by hand: its step on the
    batches the trainer pulls gives the losses the trainer recorded."""
    want = step_records(uninterrupted.logdir)
    assert [(r["epoch"], r["iter"], r["step"]) for r in want] == [(0, 0, 0), (0, 1, 1)]
    direct = run(workdir, monkeypatch, "results_d", "TRAIN.END_EPOCH", "0")
    for i, rec in enumerate(want):
        metrics = direct.train_step(*direct.device_batches(i))
        assert {k: float(v) for k, v in metrics.items()} == \
            {k: v for k, v in rec.items() if k not in ("epoch", "iter", "step")}
    ev = [r for r in records(uninterrupted.logdir) if "eval" in r]
    assert len(ev) == 1 and ev[0]["window_batches"] == len(uninterrupted.valid_loader)
    logdir = Path(uninterrupted.logdir)
    names = sorted(p.name for p in logdir.iterdir())
    events = [n for n in names if n.startswith("events.out.tfevents.")]  # the TensorBoard file
    assert len(events) == 1 and [n for n in names if n not in events] == [
        "best.txt", "config.yaml", "epoch_0.pth.tar", "model_best.pth.tar", "train_log.txt",
        "train_metrics.jsonl"]
    assert float((logdir / "best.txt").read_text()) == ev[0]["eval"]["pa-mpjpe"]


def test_sigterm_then_resume_equals_the_uninterrupted_run(workdir, monkeypatch, uninterrupted):
    def stop_after_first(step):
        calls = []

        def wrapped(*a):
            out = step(*a)
            calls.append(1)
            if len(calls) == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapped

    monkeypatch.setenv("MAED_PREEMPT_EXIT", "3")
    with pytest.raises(SystemExit) as stop:
        run(workdir, monkeypatch, "results_p", "TRAIN.RESUME", "auto",
            step_wrapper=stop_after_first)
    assert stop.value.code == 3
    (first,) = (workdir / "results_p").iterdir()
    pre = ckpt.load_checkpoint(str(first / "preempt.pth.tar"))
    assert (pre["epoch"], pre["epoch_iter"], pre["global_step"]) == (0, 1, 1)
    assert pre["loader_state"]["train_3d"] == {"epoch": 0, "iter_epoch": 0, "pos": 1}
    monkeypatch.undo()
    resumed = run(workdir, monkeypatch, "results_p", "TRAIN.RESUME", "auto")
    assert_state_equal(resumed.model.state_dict(), uninterrupted.model.state_dict())
    assert_state_equal(resumed.optimizer.optimizer.state_dict(),
                       uninterrupted.optimizer.optimizer.state_dict())
    assert_state_equal(resumed.generator.get_state(), uninterrupted.generator.get_state())
    logdirs = sorted((workdir / "results_p").iterdir())
    steps = [r for d in logdirs for r in step_records(d)]
    assert steps == step_records(uninterrupted.logdir)


def test_validation_equals_a_direct_evaluator_run(uninterrupted):
    t = uninterrupted
    got = t.validate()
    t.model.eval()
    try:
        want, _ = Evaluator(t.smpl_model).run(
            lambda x, j: t.model(x, t.smpl_model, J_regressor=j), t.valid_loader, seqlen=4,
            dataset_name="3dpw", batch_size=2, allow_missing_regressor=True)
    finally:
        t.model.train()
    assert got == want and t.model.training


def test_nan_loss_exits_with_the_jax_message(workdir, monkeypatch):
    def nan_loss(step):
        return lambda *a: {"loss": torch.tensor(float("nan"))}

    with pytest.raises(SystemExit, match=r"^Nan value in loss, exiting!\.\.\.$"):
        run(workdir, monkeypatch, "results_nan", step_wrapper=nan_loss)


def test_checkpoint_round_trip_restores_every_field(workdir, monkeypatch, uninterrupted):
    state = uninterrupted.state(0, 12.5)
    state["epoch_iter"] = 1
    path = ckpt.save_checkpoint(str(workdir / "rt"), state, name="preempt")
    assert_state_equal(ckpt.load_checkpoint(path), ckpt.to_cpu(state))
    fresh = run(workdir, monkeypatch, "results_rt", "TRAIN.END_EPOCH", "0",
                "TRAIN.RESUME", path)
    assert (fresh.start_epoch, fresh._resume_iter) == (0, 1)
    got = fresh.state(0, 12.5)
    got["loader_state"] = fresh._resume_loader_state  # restored when fit() starts the epoch
    got["epoch_iter"] = 1
    assert_state_equal(got, state)
    # resume is strict: a missing field, or a missing weight, raises
    del state["state_dict"]["decoder.deccam.bias"]
    ckpt.save_checkpoint(str(workdir / "rt"), state, name="partial")
    with pytest.raises(RuntimeError, match="deccam"):
        fresh.resume(str(workdir / "rt" / "partial.pth.tar"))
    del state["generator"]
    ckpt.save_checkpoint(str(workdir / "rt"), state, name="partial")
    with pytest.raises(KeyError, match="generator"):
        fresh.resume(str(workdir / "rt" / "partial.pth.tar"))


def test_auto_resume_takes_the_newest_whole_checkpoint(tmp_path):
    runs = {"01_tiny": ["epoch_0.pth.tar", "epoch_1.pth.tar"],
            "02_tiny": ["preempt.pth.tar", "model_best.pth.tar", "epoch_2.pth.tar.tmp-9-9",
                        "preempt.pth.tar.tmp-1-2", "best.txt"],
            "03_other": ["epoch_7.pth.tar"]}
    t = 1_000_000
    for run_dir, names in runs.items():
        (tmp_path / run_dir).mkdir()
        for name in names:
            (tmp_path / run_dir / name).write_bytes(b"x")
            t += 10
            os.utime(tmp_path / run_dir / name, (t, t))
    assert ckpt.find_auto_resume(str(tmp_path), "tiny") == str(tmp_path / "02_tiny" / "preempt.pth.tar")
    assert ckpt.find_auto_resume(str(tmp_path)) == str(tmp_path / "03_other" / "epoch_7.pth.tar")
    assert ckpt.find_auto_resume(str(tmp_path / "none"), "tiny") == ""


@pytest.mark.parametrize("keep", [-1, 0, 2])
def test_pruning_keeps_model_best(tmp_path, keep):
    names = [f"epoch_{e}.pth.tar" for e in (0, 1, 2, 10)] + ["model_best.pth.tar", "best.txt",
                                                              "preempt.pth.tar"]
    for name in names:
        (tmp_path / name).write_bytes(b"x")
    ckpt.prune_epoch_checkpoints(str(tmp_path), keep)
    kept = {-1: 4, 0: 1, 2: 2}[keep]
    want = set(names[4 - kept:])
    assert {p.name for p in tmp_path.iterdir()} == want


def test_load_policies(uninterrupted):
    """Stage-2 init: the encoder only, reshaped and unknown keys reported;
    eval (build_eval_model): every weight, strict."""
    model = uninterrupted.model
    own = {k: v.clone() for k, v in model.state_dict().items()}
    src = {k: v + 1 for k, v in own.items()}
    src["encoder.pos_embed"] = torch.zeros(1, 3, 768)
    src["encoder.extra"] = torch.zeros(2)
    unused = ckpt.load_pretrained_state(model, src, drop_decoder=True)
    assert sorted(unused) == ["encoder.extra", "encoder.pos_embed (shape (1, 3, 768) != (1, 5, 768))"]
    now = model.state_dict()
    for k, v in own.items():
        keep = k.startswith("decoder.") or k == "encoder.pos_embed"
        assert torch.equal(now[k], v if keep else src[k]), k
    model.load_state_dict(own)
    del own["decoder.deccam.bias"]
    with pytest.raises(RuntimeError, match="deccam"):
        build_eval_model(state_dict=own, **TINY_EVAL)


def test_eval_loads_the_torch_convert_export_of_jax_weights(uninterrupted, tmp_path):
    """The reference-layout file ``python -m maed_tpu.utils.torch_convert``
    writes from a JAX run (a ``module.``-prefixed state_dict, epoch,
    performance; here from the flax tree JAX's converter makes of trained
    weights) loads strictly into the port's eval model, as the same flax
    tree mapped by the port does."""
    params, _, unmatched = convert_state_dict(
        {k: v.numpy() for k, v in uninterrupted.model.state_dict().items()})
    assert not unmatched
    sd = convert_params_to_state_dict(params, {}, prefix="module.")
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "epoch": 3, "performance": 50.0}, tmp_path / "export.pth.tar")
    got, _ = build_eval_model(state_dict=load_weights(str(tmp_path / "export.pth.tar")),
                              **TINY_EVAL)
    want, _ = build_eval_model(state_dict=state_dict_from_jax(params), **TINY_EVAL)
    assert_state_equal(got.state_dict(), want.state_dict())
    with pytest.raises(ValueError, match="torch_convert"):
        load_weights(str(tmp_path / "orbax_dir"))


@pytest.mark.parametrize("with_joblib", [True, False])
def test_evaluator_writes_inference_pkl(tmp_path, monkeypatch, with_joblib):
    from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model

    smpl = synthetic_smpl_model(64, 0, device="cpu")
    rng = np.random.RandomState(0)

    def forward(images, jreg):
        n, t = images.shape[:2]
        g = torch.Generator().manual_seed(int(images.sum()))
        return {"theta": torch.randn(n, t, 85, generator=g), "verts": torch.randn(n, t, 64, 3, generator=g),
                "kp_2d": torch.randn(n, t, 49, 2, generator=g), "kp_3d": torch.randn(n, t, 49, 3, generator=g),
                "rotmat": torch.randn(n, t, 24, 3, 3, generator=g)}

    kp3d = np.concatenate([rng.randn(2, 8, 49, 3), np.ones((2, 8, 49, 1))], -1).astype(np.float32)
    window = {"images": rng.randint(0, 256, (2, 8, 8, 8, 3), dtype=np.uint8), "kp_3d": kp3d,
              "kp_2d": kp3d[..., :3], "theta": (rng.randn(2, 8, 85) * 0.1).astype(np.float32),
              "valid": rng.rand(2, 8) < 0.8, "bbox": rng.rand(2, 8, 4).astype(np.float32),
              "paths": [[f"f{i}_{t}.jpg" for t in range(8)] for i in range(2)]}
    if not with_joblib:
        monkeypatch.setitem(sys.modules, "joblib", None)
    ev = Evaluator(smpl)
    _, poses = ev.run(forward, [window], seqlen=4, dataset_name="syn", verbose=False,
                      save_path=str(tmp_path / "out"))
    path = tmp_path / "out" / "inference.pkl"
    monkeypatch.undo()
    out = joblib.load(path)
    if not with_joblib:
        with open(path, "rb") as f:
            out = pickle.load(f)
    assert sorted(out) == ["bboxes", "paths", "pred_theta", "pred_verts"]
    assert out["pred_verts"].shape == (poses, 64, 3) and out["pred_theta"].shape == (poses, 85)
    assert list(out["paths"]) == [p for row, v in zip(window["paths"], window["valid"])
                                  for p, keep in zip(row, v) if keep]
