"""maed_tpu_torch's data-parallel training and remat on the CPU, against the
JAX package's protocol and its ``remat=True`` MAED.

Data parallel (``parallel.dist``, gloo): real processes on a free localhost
port. The train CLI under ``python -m torch.distributed.run --standalone
--nproc_per_node 2`` (``DEVICE cpu``) at tests/test_torch_port_trainer.py's
tiny config and synthetic DBs: rank 0 alone writes and logs, the logged
metrics are the ranks' mean, a SIGTERM to one rank stops both at the same
iteration, ``TRAIN.RESUME auto`` then ends bit for bit where the
uninterrupted two-rank run ends, checkpoints load between one and two
processes, and the validation equals the JAX package's count-weighted
``sync_metrics`` and one process's evaluation of the whole set. The eval
CLI under torchrun with two ranks, data parallel and at MAED_MESH_TP=2,
gives the one-process eval CLI's metrics. Each collective of
``parallel.dist`` in two ranks. (Two ranks on halves of the
batches against JAX's step on the whole batches: tests/test_torch_port_train.py
for stage 2, tests/test_torch_port_stage1.py for stage 1.)

remat (``MAED(remat=True)``: each ViT block under ``torch.utils.checkpoint``):
the step with dropout and drop-path positive equals the step without remat
bit for bit in f64, and at rate 0 its gradient matches JAX's ``remat=True``
MAED at tests/test_train.py's tiny size.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import multihost_utils

from maed_tpu.core.evaluate import Evaluator as JEvaluator
from maed_tpu.models import MAED as JMAED
from maed_tpu.utils.smpl_io import synthetic_smpl_model as j_synthetic_smpl
from maed_tpu_torch import eval as eval_cli
from maed_tpu_torch.core.builder import init_weights_
from maed_tpu_torch.core.evaluate import Evaluator
from maed_tpu_torch.models.maed import MAED
from maed_tpu_torch.utils import checkpoint as ckpt
from maed_tpu_torch.utils.smpl_io import synthetic_smpl_model as t_synthetic_smpl
from maed_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_models import random_params
from test_torch_port_train import (CONFIG, RES, T, _assert_grads, _batches, _port_step, _state,
                                   _tree)
from test_torch_port_trainer import (assert_state_equal, records, run, step_records,  # noqa: F401
                                     workdir)
from torch_port_common import (RANKS_SCRIPT, Ranks, one_torch_thread, ranks_env,  # noqa: F401
                               to_torch)


# --- the train CLI under torchrun, two gloo ranks -----------------------------

def torchrun(workdir, out, *opts, record=None, stop=(-1, 0), env=None):
    """Start ``python -m torch.distributed.run --standalone --nproc_per_node 2``
    of the train CLI with OUTPUT_DIR ``<workdir>/<out>`` (DEVICE cpu: gloo),
    each rank's output in ``<workdir>/<out>_logs``: ``-m
    maed_tpu_torch.train``, or, with ``record``, tests/torch_port_ranks.py's
    ``cli``, which records each rank's own step metrics and validation
    pairs there and stops rank ``stop[0]`` by SIGTERM after its
    ``stop[1]``-th step; ``env`` is added to the environment. Returns the
    process."""
    logs = workdir / f"{out}_logs"
    target = (["-m", "maed_tpu_torch.train"] if record is None else
              [str(RANKS_SCRIPT), "cli", str(record), str(stop[0]), str(stop[1])])
    if record is not None:
        record.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "--log-dir", str(logs), "--redirects", "3", *target, "--cfg", "tiny.yaml",
           "--allow_synthetic_smpl", "OUTPUT_DIR", str(workdir / out), *opts]
    return subprocess.Popen(cmd, cwd=workdir, env=ranks_env(**(env or {})),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc, timeout=300):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]


def rank_output(logs, rank):
    """What rank ``rank`` wrote to its stdout and stderr."""
    files = [p for p in Path(logs).rglob("*.log") if p.parent.name == str(rank)]
    assert files, list(Path(logs).rglob("*"))
    return "".join(p.read_text() for p in files)


@pytest.fixture(scope="module")
def two_ranks_started(workdir):
    """Two-rank runs of the tiny config, started at once: one uninterrupted,
    one with TRAIN.RESUME auto whose rank 1 alone gets a SIGTERM after its
    first step, and one at MAED_MESH_TP=2 (one data rank, each block split
    over the two)."""
    return {"u": torchrun(workdir, "ddp_u", record=workdir / "record_u"),
            "p": torchrun(workdir, "ddp_p", "TRAIN.RESUME", "auto", record=workdir / "record_p",
                          stop=(1, 1)),
            "tp": torchrun(workdir, "tp_u", env={"MAED_MESH_TP": "2"})}


@pytest.fixture(scope="module")
def one_process(workdir, two_ranks_started):
    """A one-process trainer of the same config, built by the CLI (no epoch
    run), and a checkpoint of its state; made while the two-rank runs go
    on."""
    with pytest.MonkeyPatch.context() as mp:
        trainer = run(workdir, mp, "one", "TRAIN.END_EPOCH", "0")
    path = ckpt.save_checkpoint(str(workdir / "one_ckpt"), trainer.state(0, 1.0), name="epoch_0")
    return trainer, path


EVAL_ARGS = ("--cfg", "tiny.yaml", "--eval_ds", "3dpw", "--eval_set", "val",
             "--allow_synthetic_smpl")


@pytest.fixture(scope="module")
def eval_ranks_started(workdir, one_process):
    """``python -m torch.distributed.run --nproc_per_node 2`` of the eval CLI
    on the one-process checkpoint (tests/torch_port_ranks.py's ``eval``
    records what each rank's ``main`` returned): data parallel, and at
    MAED_MESH_TP=2; started as soon as the checkpoint exists."""
    procs = {}
    for name, env in (("eval_dp", {}), ("eval_tp", {"MAED_MESH_TP": "2"})):
        record = workdir / name
        record.mkdir()
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
               "2", "--log-dir", str(workdir / f"{name}_logs"), "--redirects", "3",
               str(RANKS_SCRIPT), "eval", str(record), *EVAL_ARGS, "--checkpoint",
               str(one_process[1])]
        procs[name] = subprocess.Popen(cmd, cwd=workdir, env=ranks_env(**env),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    return procs


@pytest.fixture(scope="module")
def two_ranks(workdir, two_ranks_started, one_process, jax_remat, collectives,
              eval_ranks_started):
    """The runs of ``two_ranks_started`` once ended (``one_process`` and
    ``jax_remat`` are made and ``collectives`` started meanwhile), then the
    preempted command again, which resumes it."""
    for proc in two_ranks_started.values():
        finish(proc)
    first = sorted((workdir / "ddp_p").iterdir())
    finish(torchrun(workdir, "ddp_p", "TRAIN.RESUME", "auto"))
    (resumed,) = set(sorted((workdir / "ddp_p").iterdir())) - set(first)
    (uninterrupted,) = (workdir / "ddp_u").iterdir()

    def recorded(name):
        return [json.loads((workdir / name / f"rank{r}.json").read_text()) for r in range(2)]

    (tp,) = (workdir / "tp_u").iterdir()
    return dict(u=uninterrupted, preempted=first[0], resumed=resumed,
                record_u=recorded("record_u"), record_p=recorded("record_p"),
                logs_u=workdir / "ddp_u_logs", tp=tp)


def test_two_ranks_rank0_writes_the_global_metrics(two_ranks):
    """Rank 0 alone logs and writes: one run directory, the files of a
    one-process run, a record a step; rank 1 prints no train line and no
    checkpoint. Each step's recorded metrics are the mean of the two
    ranks' own (which differ: each rank trains on its shard), and the
    validation's are the count-weighted mean of the ranks' pairs."""
    logdir = two_ranks["u"]
    names = sorted(p.name for p in logdir.iterdir())
    events = [n for n in names if n.startswith("events.out.tfevents.")]  # the TensorBoard file
    assert len(events) == 1 and [n for n in names if n not in events] == [
        "best.txt", "config.yaml", "epoch_0.pth.tar", "model_best.pth.tar", "train_log.txt",
        "train_metrics.jsonl"]
    steps = step_records(logdir)
    own = [r["steps"] for r in two_ranks["record_u"]]
    assert len(steps) == len(own[0]) == len(own[1]) == 2
    for rec, a, b in zip(steps, *own):
        assert a != b
        assert {k: v for k, v in rec.items() if k not in ("epoch", "iter", "step")} == \
            {k: (a[k] + b[k]) / 2 for k in a}
    assert (logdir / "train_log.txt").read_text().count("[Train]") == 2
    rank0, rank1 = (rank_output(two_ranks["logs_u"], r) for r in range(2))
    assert "[Train]" in rank0 and "checkpoint written" in rank0
    assert "[Train]" not in rank1 and "checkpoint written" not in rank1
    (ev,) = [r for r in records(logdir) if "eval" in r]
    pairs = [r["sync"] for r in two_ranks["record_u"]]
    assert [len(p) for p in pairs] == [1, 1]
    (m0, n0), (m1, n1) = pairs[0][0], pairs[1][0]
    assert ev["poses"] == n0 + n1 and n0 != n1  # the weights matter
    assert ev["eval"] == {k: (m0[k] * n0 + m1[k] * n1) / (n0 + n1) for k in m0}


def test_two_ranks_stop_together_on_one_ranks_sigterm(two_ranks):
    """A SIGTERM to rank 1 alone, after its first step: both ranks stop
    after that step (each recorded one), the preempt checkpoint holds
    iteration 1 and both ranks' dropout generators, and the run exits 0."""
    assert [len(r["steps"]) for r in two_ranks["record_p"]] == [1, 1]
    pre = ckpt.load_checkpoint(str(two_ranks["preempted"] / "preempt.pth.tar"))
    assert (pre["epoch"], pre["epoch_iter"], pre["global_step"]) == (0, 1, 1)
    assert len(pre["generator"]) == 2
    assert not torch.equal(*pre["generator"])


def test_two_rank_resume_is_bit_for_bit(two_ranks):
    """TRAIN.RESUME auto after that stop (``-m maed_tpu_torch.train`` under
    torchrun) ends where the uninterrupted two-rank run ends: the whole
    epoch checkpoint (every parameter and buffer, Adam's state, the
    schedule, both ranks' generators, the loaders' positions) bit for bit,
    and the same records of each step."""
    name = "epoch_0.pth.tar"
    assert_state_equal(ckpt.load_checkpoint(str(two_ranks["resumed"] / name)),
                       ckpt.load_checkpoint(str(two_ranks["u"] / name)))
    steps = step_records(two_ranks["preempted"]) + step_records(two_ranks["resumed"])
    assert steps == step_records(two_ranks["u"])


def test_checkpoints_of_one_and_two_ranks_load_into_each_other(one_process, two_ranks):
    """The two-rank checkpoint's state_dict (no ``module.`` prefix) loads
    strictly into the one-process model, and the one-process one into the
    model of the two ranks (the same class and names); resuming a run with another number of
    processes raises (each rank has its own dropout generator), before it
    changes anything."""
    trainer, one_path = one_process
    two = ckpt.load_checkpoint(str(two_ranks["u"] / "epoch_0.pth.tar"))
    one = ckpt.load_checkpoint(one_path)
    assert two["state_dict"].keys() == one["state_dict"].keys()
    assert not any(k.startswith("module.") for k in two["state_dict"])
    model = copy.deepcopy(trainer.model)
    model.load_state_dict(two["state_dict"], strict=True)
    model.load_state_dict(one["state_dict"], strict=True)
    before = copy.deepcopy(trainer.model.state_dict())
    with pytest.raises(ValueError, match="generators of 2 process"):
        trainer.resume(str(two_ranks["u"] / "epoch_0.pth.tar"))
    assert_state_equal(trainer.model.state_dict(), before)


def test_two_rank_validation_equals_one_process_on_the_whole_set(one_process, two_ranks):
    """The validation of the two-rank run (each rank on its two of the four
    windows, then ``sync_metrics``) equals the JAX package's
    ``Evaluator.sync_metrics`` on the ranks' (metrics, count) pairs, and has
    the count of one process's ``Evaluator.run`` over all four windows with
    the same weights. Its per-pose metrics (MPJPE, PA-MPJPE, PVE) equal that
    run's (rtol 1e-6: f32 means over another grouping); the acceleration
    terms take second differences along each rank's own sequence of poses,
    across its own window boundaries, in the JAX package as here, so a
    sharded validation's differ from the whole set's."""
    (ev,) = [r for r in records(two_ranks["u"]) if "eval" in r]
    t, _ = one_process
    model = copy.deepcopy(t.model).eval()
    model.load_state_dict(ckpt.load_checkpoint(str(two_ranks["u"] / "epoch_0.pth.tar"))
                          ["state_dict"], strict=True)
    assert len(t.valid_loader.dataset) == 4
    want, poses = Evaluator(t.smpl_model).run(
        lambda x, j: model(x, t.smpl_model, J_regressor=j), t.valid_loader, seqlen=4,
        dataset_name="3dpw", batch_size=2, allow_missing_regressor=True, verbose=False)
    assert ev["poses"] == poses
    for k in ("mpjpe", "pa-mpjpe", "pve"):
        np.testing.assert_allclose(ev["eval"][k], want[k], rtol=1e-6, err_msg=k)
    gathered = []

    def allgather(local):
        gathered.append(np.asarray(local))
        return np.stack(gathered)

    pairs = [r["sync"][0] for r in two_ranks["record_u"]]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax, "process_count", lambda: 2)
        mp.setattr(multihost_utils, "process_allgather", allgather)
        JEvaluator.sync_metrics(None, *pairs[1])  # rank 1's local vector, gathered first
        jax_eval, jax_poses = JEvaluator.sync_metrics(None, *pairs[0])
    assert jax_poses == ev["poses"] and jax_eval == ev["eval"]


def test_tp2_train_cli_equals_one_process(workdir, two_ranks, monkeypatch):
    """The train CLI at MAED_MESH_TP=2 under torchrun (two gloo ranks, one
    data rank: both take the one process's batches and masks, each ViT block
    split over them) records the one-process CLI's step losses (rtol 1e-5:
    the partial sums' order, in f32); its checkpoint holds the full,
    reference-named weights and Adam moments, which load ``strict=True``
    into the one-process trainer; its split validation equals one process's
    ``Evaluator.run`` of those weights over the whole set (rtol 1e-6, as the
    two-rank validation is held)."""
    one = run(workdir, monkeypatch, "tp_ref")
    want, got = step_records(one.logdir), step_records(two_ranks["tp"])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    saved = ckpt.load_checkpoint(str(two_ranks["tp"] / "epoch_0.pth.tar"))
    state = one.state(0, 1.0)
    assert saved["state_dict"].keys() == state["state_dict"].keys()
    for k, v in state["state_dict"].items():
        assert saved["state_dict"][k].shape == v.shape, k
    one.model.load_state_dict(saved["state_dict"], strict=True)
    one.optimizer.optimizer.load_state_dict(saved["optimizer"])
    (ev,) = [r for r in records(two_ranks["tp"]) if "eval" in r]
    model = copy.deepcopy(one.model).eval()
    want, poses = Evaluator(one.smpl_model).run(
        lambda x, j: model(x, one.smpl_model, J_regressor=j), one.valid_loader, seqlen=4,
        dataset_name="3dpw", batch_size=2, allow_missing_regressor=True, verbose=False)
    assert ev["poses"] == poses
    for k, v in want.items():
        np.testing.assert_allclose(ev["eval"][k], v, rtol=1e-6, err_msg=k)


def test_eval_cli_over_two_ranks_equals_one_process(workdir, one_process, eval_ranks_started,
                                                   two_ranks, monkeypatch):
    """The eval CLI under torchrun: two data ranks (each on two of the four
    windows, unpadded, then ``sync_metrics``) give the one-process eval
    CLI's pose count and per-pose metrics (MPJPE, PA-MPJPE, PVE) at rtol
    1e-6, as the two-rank validation does, on both ranks; at MAED_MESH_TP=2
    (one data rank, the model split over the two) all five metrics, on both
    ranks."""
    monkeypatch.chdir(workdir)
    want, poses = eval_cli.main([*EVAL_ARGS, "--checkpoint", str(one_process[1])])
    for name, keys in (("eval_dp", ("mpjpe", "pa-mpjpe", "pve")), ("eval_tp", tuple(want))):
        finish(eval_ranks_started[name])
        for r in range(2):
            got = json.loads((workdir / name / f"rank{r}.json").read_text())
            assert got["poses"] == poses, name
            for k in keys:
                np.testing.assert_allclose(got["metrics"][k], want[k], rtol=1e-6,
                                           err_msg=f"{name} rank {r} {k}")


# --- parallel.dist's collectives in two ranks ----------------------------------

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """Two gloo ranks running ``tests/torch_port_ranks.py``'s collectives."""
    return Ranks([{"collectives": True}], tmp_path_factory.mktemp("collectives"))


def test_collectives_of_two_gloo_ranks(collectives):
    """Rank 0's string on both ranks, and one longer than the buffer raising
    on both (never truncated); a flag of rank 1 alone set on both; the
    count-weighted mean; rank 0 gathering both ranks' objects; the
    differentiable sum, whose gradient on each rank sums the ranks' (the
    sum of x_r^2 gives each rank 2 x_r W); rank 0's module on both; the
    gradients averaged."""
    r0, r1 = (results[0] for results in collectives.results())
    assert r0["broadcast"] == r1["broadcast"] == "resume/"
    assert "max_len=8" in r0["too_long"] and "max_len=8" in r1["too_long"]
    assert r0["any"] == r1["any"] == (True, False)
    assert r0["weighted"] == r1["weighted"] == ({"mpjpe": (10.0 + 40.0) / 3, "pve": 1.0}, 3)
    assert r0["gathered"] == [{"rank": 0}, {"rank": 1}] and r1["gathered"] is None
    assert r0["mean"] == r1["mean"] == [1.5]
    assert r0["sum"] == r1["sum"] == 5.0
    assert (r0["sum_grad"], r1["sum_grad"]) == (4.0, 8.0)
    assert r0["module"] == r1["module"] == [[[0.0, 0.0]], [0.0]]
    assert r0["grads"] == r1["grads"] == [[[1.5, 1.5]], [1.0]]


# --- remat ---------------------------------------------------------------------

def _count_block_runs(model):
    """A list that grows by one at each entry into a ViT block's forward
    (the recomputation of a remat block enters it again)."""
    runs = []
    for block in model.encoder.blocks:
        block.register_forward_pre_hook(lambda *args: runs.append(1))
    return runs


def test_remat_step_equals_the_step_without_remat():
    """A step of a two-block model with every dropout rate positive (the
    second block's drop-path too) and KTD's dropout at 0.5, with and without
    remat, from the same weights and generator seed, in f64: the loss
    terms, every gradient and every updated parameter equal bit for bit,
    and the generator ends in the same state. The recomputation draws the
    first run's masks from a copy of the generator's state (a plain
    checkpoint would draw new ones from the live generator and give
    another gradient without an error). Each remat block runs twice."""
    got = {}
    for remat in (False, True):
        model = MAED(num_blocks=2, num_heads=2, hidden_dim=32, img_size=RES, drop_rate=0.1,
                     attn_drop_rate=0.1, drop_path_rate=0.2, decoder_drop=0.5, remat=remat,
                     dtype=torch.float64).double()
        init_weights_(model, 0)
        model.train()
        runs = _count_block_runs(model)
        generator = torch.Generator().manual_seed(11)
        vid, _ = _batches(3)
        metrics = _port_step(model, 1, generator)(_tree(vid, to_torch), None)
        got[remat] = (metrics, _state(model), generator.get_state(), len(runs))
    (m0, (p0, g0), s0, n0), (m1, (p1, g1), s1, n1) = got[False], got[True]
    assert (n0, n1) == (2, 4)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0), [k for k in g0 if not torch.equal(g0[k], g1[k])]
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(s0, s1)


REMAT_X = np.random.RandomState(12).randn(1, T, RES, RES, 3)


@pytest.fixture(scope="module")
def jax_remat(two_ranks_started):
    """JAX's MAED(remat=True) at tests/test_train.py's tiny size (1 block, 2
    heads, KTD 32, 32 px, T 2; every rate 0): random f64 parameters and the
    gradient of sum(kp_3d^2) on REMAT_X; compiled while the two-rank runs
    go on."""
    smpl = j_synthetic_smpl(64, 0)
    jmodel = JMAED(encoder="ste", st_mode="parallel", decoder="ktd", remat=True,
                   dtype=jnp.float64, **CONFIG)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), random_params(
        lambda: jmodel.init(jax.random.PRNGKey(0), REMAT_X.astype(np.float32), smpl), 13))
    with jax.enable_x64(True):
        want = jax.jit(jax.grad(lambda p, x: jnp.sum(jmodel.apply({"params": p}, x, smpl)
                                                     ["kp_3d"] ** 2)))(params, REMAT_X)
    return params, jax.tree.map(np.asarray, want)


def test_remat_gradient_matches_jax_remat(jax_remat):
    """The gradient of sum(kp_3d^2) of the port's remat model in training
    against JAX's ``remat=True`` one (``jax_remat``), in f64, at GRAD_ATOL x
    the largest (the camera's, which kp_3d does not reach, is zero in JAX
    and absent in the port). The port's block runs twice (its forward, then
    its recomputation in the backward)."""
    params, want = jax_remat
    model = MAED(img_size=RES, decoder_drop=0.0, remat=True, dtype=torch.float64,
                 **CONFIG).double()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.train()
    runs = _count_block_runs(model)
    out = model(to_torch(REMAT_X), t_synthetic_smpl(64, 0, device="cpu"),
                generator=torch.Generator().manual_seed(0))
    (out["kp_3d"] ** 2).sum().backward()
    assert len(runs) == 2
    # kp_3d does not reach the camera: no gradient here, zeros in JAX
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in model.named_parameters()}
    _assert_grads(grads, want)
