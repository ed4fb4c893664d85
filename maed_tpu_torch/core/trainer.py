"""Trainer: the stage-2 epoch loop of mixed 2D/3D/image batches around one
train step.

Port of ``maed_tpu/core/trainer.py``, on one card (or the CPU) a process,
one process or W of them data parallel (``parallel.dist``; the JAX package's
'dp' mesh axis). Its parts:

  * each iteration draws a 2D and a 3D clip batch and, every IMG_USE_FREQ
    iterations, an image batch from :class:`InfiniteLoader` s (each rank
    its shard of the data), and sends them to the device through pinned
    memory without blocking the host;
  * the step's metrics stay on the device and are read at log boundaries
    (every ``log_freq`` iterations and at an epoch's end), averaged over
    the ranks in one collective a window, so that the values logged are
    the global batch's; a NaN loss then stops every rank with the JAX
    package's message;
  * every SAVE_FREQ epochs it validates through ``Evaluator.run`` (each
    rank its shard of the windows, the metrics then averaged by prediction
    count) with the model in ``eval()`` (then back to ``train()``), tracks
    the best PA-MPJPE and writes ``epoch_N.pth.tar``,
    ``model_best.pth.tar`` and ``best.txt``;
  * SIGTERM lets the step in flight finish, writes ``preempt.pth.tar`` with
    the loaders' positions and returns with ``preempted`` set. With several
    ranks, a SIGTERM that any rank saw stops all of them at the same
    iteration: they agree at each log boundary and at each epoch's end, as
    the JAX trainer's ``_agree_preempt`` does. TRAIN.RESUME (a path, or
    'auto' for the newest checkpoint of this experiment, which rank 0
    resolves and broadcasts) continues bit for bit: batch contents are a
    pure function of (seed, epoch, index), and the checkpoint holds the
    optimizer, the schedule, every rank's dropout generator and every
    loader's position.

Rank 0 alone logs and writes files; every rank enters the checkpoint writes,
which gather the data ranks' generators. Under tensor parallelism (a model
built with a mesh of tp > 1) the checkpoint writes also gather the
parameters and the optimizer's moments from every rank's shards to their
full, reference names (as the JAX trainer gathers its TP-sharded state),
and a resume cuts them to this rank's shards again: a checkpoint written at
any tp resumes at any other with the same number of data ranks. It also
appends one JSON object a line to ``<logdir>/train_metrics.jsonl``: each
step's metrics; the timing of each log boundary's iteration (the data and
the step, on the host clock) and the device's peak memory so far; each
validation's metrics and seconds, each checkpoint write's seconds and
bytes. Beside it, a TensorBoard event file
(``utils.summary``) takes the JAX trainer's scalars: ``train_loss/<k>``, the
epoch's running means at each log boundary at the global step, and
``eval/<k>`` at each validation at the epoch. With MAED_PROFILE_DIR set,
the first MAED_PROFILE_STEPS steps are traced (``utils.profiling``; the
data fetch and the step are annotated as 'data' and 'train_step').
"""

from __future__ import annotations

import json
import os.path as osp
import signal
import sys
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from maed_tpu_torch.core.evaluate import Evaluator, load_eval_regressor
from maed_tpu_torch.data.loaders import InfiniteLoader
from maed_tpu_torch.parallel import dist
from maed_tpu_torch.parallel.mesh import (gather_optimizer_state, gather_state_dict, model_mesh,
                                          shard_optimizer_state, shard_state_dict)
from maed_tpu_torch.parallel.train_step import TrainOptimizer
from maed_tpu_torch.utils.checkpoint import (find_auto_resume, load_checkpoint,
                                             prune_epoch_checkpoints, save_checkpoint,
                                             wait_pending_saves)
from maed_tpu_torch.utils.logging_utils import AverageMeter, StepTimer
from maed_tpu_torch.utils.profiling import annotate, maybe_trace, stop_trace
from maed_tpu_torch.utils.summary import SummaryWriter

# what a checkpoint must hold for TRAIN.RESUME
RESUME_FIELDS = ("state_dict", "epoch", "performance", "optimizer", "scheduler",
                 "optimizer_calls", "generator", "global_step", "best_performance",
                 "loader_state")


class Trainer:
    """The epoch loop. ``train_step(vid_batch, img_batch) -> metrics`` is
    ``parallel.train_step.make_train_step``'s step over ``model``,
    ``optimizer`` and ``generator`` (its dropout masks); the trainer holds
    them for its checkpoints. ``eval_forward(images, J_regressor)`` is the
    forward that validation runs, with the model in eval mode. Under a
    process group ``generator`` is this data rank's own, and ``logdir``
    names rank 0's directory on every rank. A model built with a mesh
    (``parallel.mesh``) of tp > 1 has its checkpoints gathered and
    re-sharded."""

    def __init__(
        self,
        data_loaders: Dict,
        train_step: Callable,
        model: torch.nn.Module,
        optimizer: TrainOptimizer,
        generator: torch.Generator,
        smpl_model,
        cfg,
        logdir: str = "",
        eval_forward: Optional[Callable] = None,
        logger=None,
        num_iters_per_epoch: int = -1,
        allow_missing_regressor: bool = False,
        log_freq: int = 10,
    ):
        self.rank, self.world = dist.rank(), dist.world()
        self.data_rank, self.data_world = dist.data_rank(), dist.data_world()
        self.mesh = model_mesh(model)  # None but under tensor parallelism
        self.train_2d = InfiniteLoader(data_loaders["train_2d"]) if data_loaders.get("train_2d") else None
        self.train_3d = InfiniteLoader(data_loaders["train_3d"]) if data_loaders.get("train_3d") else None
        self.train_img = InfiniteLoader(data_loaders["train_img"]) if data_loaders.get("train_img") else None
        self.valid_loader = data_loaders.get("valid")

        self.train_step = train_step
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.smpl_model = smpl_model
        self.device = smpl_model.v_template.device
        self.cfg = cfg
        self.logdir = logdir
        self.logger = logger
        self.log_freq = max(1, int(log_freq))
        self.eval_forward = eval_forward
        self._evaluator: Optional[Evaluator] = None
        # fail fast, not after the first epoch, if the eval protocol's
        # regressor file is missing (allow_missing_regressor: the smoke runs'
        # fallback to the native joint bank)
        self._eval_ds = cfg.TRAIN.DATASET_EVAL.lower().replace("threedpw", "3dpw")
        self._eval_jreg = (
            load_eval_regressor(self._eval_ds, allow_missing=allow_missing_regressor)
            if self.valid_loader is not None else None)
        self._allow_missing_regressor = allow_missing_regressor
        self._records_lock = threading.Lock()
        self.writer = SummaryWriter(logdir) if logdir and self.rank == 0 else None

        self._preempt_requested = False
        self.preempted = False
        self._resume_iter = 0
        self._resume_loader_state = None
        self._epoch_iters_done = 0

        self.start_epoch = cfg.TRAIN.START_EPOCH
        self.end_epoch = cfg.TRAIN.END_EPOCH
        self.save_freq = cfg.SAVE_FREQ
        self.save_keep_last = int(getattr(cfg, "SAVE_KEEP_LAST", -1))
        self.save_async = bool(getattr(cfg, "SAVE_ASYNC", True))
        self.img_use_freq = cfg.TRAIN.IMG_USE_FREQ
        self.epoch = self.start_epoch
        self.train_global_step = 0
        self.best_performance = float("inf")

        if num_iters_per_epoch > 0:
            self.num_iters = num_iters_per_epoch
        else:
            lens = [len(ld.loader) for ld in (self.train_2d, self.train_3d) if ld]
            self.num_iters = max(lens) if lens else len(self.train_img.loader)

        if cfg.TRAIN.RESUME:
            target = cfg.TRAIN.RESUME
            if target == "auto":
                # relaunch the same command after a preemption or a crash:
                # the newest preempt or epoch checkpoint of this experiment
                # under OUTPUT_DIR, or a fresh start; rank 0's choice for all
                if self.rank == 0:
                    target = find_auto_resume(cfg.OUTPUT_DIR, cfg.EXP_NAME)
                target = dist.broadcast_str_from_rank0(target)
                self._log(f"TRAIN.RESUME=auto -> {target}" if target else
                          "TRAIN.RESUME=auto: no checkpoint found, starting fresh")
            if target:
                self.resume(target)

    # ------------------------------------------------------------------ #
    def _log(self, msg: str) -> None:
        if self.rank == 0:
            (self.logger.info if self.logger else print)(msg)

    def _record(self, **fields) -> None:
        """Append one JSON line to <logdir>/train_metrics.jsonl (rank 0)."""
        if not self.logdir or self.rank != 0:
            return
        with self._records_lock, open(osp.join(self.logdir, "train_metrics.jsonl"), "a") as f:
            f.write(json.dumps(fields) + "\n")

    def _to_device(self, tree):
        """Numpy leaves -> tensors on the device, through pinned memory and
        without blocking the host on a card."""
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: self._to_device(v) for k, v in tree.items()}
        t = torch.from_numpy(np.ascontiguousarray(tree))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _host_batches(self, i: int):
        """Pull one step's host batches and assemble the step's inputs."""
        target_2d = next(self.train_2d) if self.train_2d else None
        target_3d = next(self.train_3d) if self.train_3d else None
        target_img = (
            next(self.train_img)
            if self.train_img and (i + 1) % self.img_use_freq == 0
            else None
        )

        vid_batch = None
        if target_2d is not None or target_3d is not None:
            parts = [t["images"] for t in (target_2d, target_3d) if t is not None]
            vid_batch = {
                "images": np.concatenate(parts, axis=0),
                "target_3d": {
                    k: np.asarray(target_3d[k])
                    for k in ("kp_2d", "kp_3d", "theta", "w_smpl")
                } if target_3d is not None else None,
                "target_2d": {"kp_2d": np.asarray(target_2d["kp_2d"])}
                if target_2d is not None else None,
            }

        img_batch = None
        if target_img is not None:
            img_batch = {k: np.asarray(target_img[k])
                         for k in ("image", "kp_2d", "kp_3d", "theta", "w_smpl")}
        return vid_batch, img_batch

    def device_batches(self, i: int):
        """Iteration ``i``'s (vid_batch, img_batch) on the device."""
        vid_batch, img_batch = self._host_batches(i)
        return self._to_device(vid_batch), self._to_device(img_batch)

    # ------------------------------------------------------------------ #
    def request_preempt(self, signum=None, frame=None):
        """Signal-handler-compatible graceful stop: the current step
        finishes, then fit() writes the preempt checkpoint and returns with
        ``preempted`` set."""
        self._preempt_requested = True
        if not self.preempted:
            self._log("preemption requested — will checkpoint and stop")

    def _agree_preempt(self) -> bool:
        """The stop decision of every rank: whether any rank was asked to
        stop. All ranks call it at the same iterations (log boundaries and
        epoch ends): a rank that stopped one iteration before the others
        would leave them hanging in the next collective."""
        if self.world > 1:
            self._preempt_requested = dist.any_rank(self._preempt_requested)
        return self._preempt_requested

    def _read(self, pending, meters) -> None:
        """Read the pending steps' metrics (waits for them), averaged over the
        ranks in one collective: the NaN stop, the meters and the per-step
        records."""
        if not pending:
            return
        # the keys in one order on every rank (a step's terms come out of a set)
        flat = dist.mean_over_ranks(torch.stack(
            [m[k].detach().reshape(()).to(torch.float64) for _, _, m in pending
             for k in sorted(m)])).tolist()
        at = 0
        for i, step, m in pending:
            values = dict(zip(sorted(m), flat[at:at + len(m)]))
            values = {k: values[k] for k in m}
            at += len(m)
            if np.isnan(values["loss"]):
                sys.exit("Nan value in loss, exiting!...")
            for k, v in values.items():
                meters.setdefault(k, AverageMeter()).update(v)
            self._record(epoch=self.epoch, iter=i, step=step, **values)
        pending.clear()

    def train_epoch(self, start_iter: int = 0):
        """One epoch, or its tail from ``start_iter`` after a mid-epoch
        resume. Steps are issued without waiting for the card; the host
        waits once a log window, so loading the next batches overlaps the
        device's work."""
        meters = {}
        timer = StepTimer()
        pending = []
        self._epoch_iters_done = self.num_iters
        for i in range(start_iter, self.num_iters):
            # several ranks stop only where they agree (the log boundaries);
            # one process at any iteration
            if (self._agree_preempt() if self.world > 1 and i % self.log_freq == 0
                    else self.world == 1 and self._preempt_requested):
                # before pulling batches: the loaders' positions then equal
                # the batches consumed, an exactly resumable point
                self._epoch_iters_done = i
                self._read(pending, meters)
                break
            timer.start()
            with annotate("data"):
                vid_batch, img_batch = self.device_batches(i)
            timer.mark("data")
            with maybe_trace(self.train_global_step), annotate("train_step"):
                metrics = self.train_step(vid_batch, img_batch)
            pending.append((i, self.train_global_step, metrics))
            self.train_global_step += 1

            if (i + 1) % self.log_freq == 0 or i == self.num_iters - 1:
                timer.mark("step", block_on=pending[-1][2]["loss"])
                self._read(pending, meters)
                if self.writer is not None:
                    for k, m in meters.items():
                        self.writer.add_scalar(f"train_loss/{k}", m.avg, self.train_global_step)
                peak = (torch.cuda.max_memory_allocated(self.device)
                        if self.device.type == "cuda" else None)
                self._record(epoch=self.epoch, iter=i, data_s=timer.times["data"],
                             step_s=timer.times["step"], peak_bytes=peak)
                s = f"[Train] epoch {self.epoch + 1}/{self.end_epoch} it {i + 1}/{self.num_iters}"
                s += "".join(f" | {k}: {m.avg:.3f}" for k, m in meters.items())
                s += f" | data {timer.times['data']:.2f}s step {timer.times['step']:.2f}s"
                self._log(s)
        return {k: m.avg for k, m in meters.items()}

    # ------------------------------------------------------------------ #
    def validate(self):
        """The eval protocol over the validation loader, the model in
        eval() mode for it; the five metrics (mm), or None without a
        validation loader or forward."""
        if self.valid_loader is None or self.eval_forward is None:
            return None
        if self._evaluator is None:
            self._evaluator = Evaluator(self.smpl_model)
        self.model.eval()
        t0 = time.perf_counter()
        try:
            eval_dict, num_pred = self._evaluator.run(
                self.eval_forward, self.valid_loader,
                seqlen=self.cfg.EVAL.SEQLEN, interp=self.cfg.EVAL.INTERPOLATION,
                dataset_name=self._eval_ds, J_regressor=self._eval_jreg,
                batch_size=self.cfg.EVAL.BATCH_SIZE, verbose=self.rank == 0,
                allow_missing_regressor=self._allow_missing_regressor,
            )
        finally:
            self.model.train()
        self._record(epoch=self.epoch, eval=eval_dict, poses=num_pred,
                     eval_s=time.perf_counter() - t0, window_batches=len(self.valid_loader))
        if self.writer is not None:
            for k, v in eval_dict.items():
                self.writer.add_scalar(f"eval/{k}", v, self.epoch)
        return eval_dict

    # ------------------------------------------------------------------ #
    def fit(self):
        old_handler = None
        if threading.current_thread() is threading.main_thread():
            # SIGTERM = a preemption notice: stop after the step in flight
            # with an exact mid-epoch checkpoint. Installed only around
            # fit() and restored after: a library must not own the
            # process's signals.
            old_handler = signal.signal(signal.SIGTERM, self.request_preempt)
        try:
            for epoch in range(self.start_epoch, self.end_epoch):
                self.epoch = epoch
                start_iter = 0
                if self._resume_loader_state is not None and epoch == self.start_epoch:
                    # reposition every loader where the checkpoint caught it
                    for name, ld in self._named_loaders().items():
                        ld.restore(self._resume_loader_state[name])
                    start_iter = self._resume_iter
                    self._resume_loader_state = None
                    self._resume_iter = 0
                for ld in (self.train_2d, self.train_3d, self.train_img):
                    if ld:
                        ld.set_epoch(epoch)
                t0 = time.time()
                train_metrics = self.train_epoch(start_iter=start_iter)
                if self._agree_preempt():  # the epoch's end is a boundary too
                    self._save_preempt()
                    self.preempted = True
                    break
                self._log(f"Epoch {epoch + 1} done in {time.time() - t0:.1f}s: {train_metrics}")

                if (epoch + 1) % self.save_freq == 0:
                    eval_dict = self.validate()
                    performance = eval_dict["pa-mpjpe"] if eval_dict else float("inf")
                    self.save(performance, epoch)
            # no rank leaves before rank 0's last write has landed
            wait_pending_saves()
            dist.barrier()
        finally:
            # a run that ends inside the profiled window still exports its trace
            stop_trace()
            if self.writer is not None:
                self.writer.close()
                self.writer = None
            # never unwind with a checkpoint write in flight; re-raises a
            # failed background write
            wait_pending_saves()
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)

    # ------------------------------------------------------------------ #
    def _named_loaders(self) -> Dict:
        return {
            name: ld for name, ld in (
                ("train_2d", self.train_2d), ("train_3d", self.train_3d),
                ("train_img", self.train_img),
            ) if ld is not None
        }

    def _generator_state(self):
        """The dropout generator's state; with several data ranks, every data
        rank's in data-rank order (a collective: each rank must call it)."""
        state = self.generator.get_state()
        return state if self.data_world == 1 else dist.gather_objects(state)

    def _param_names(self) -> list:
        """The optimizer's parameters' names, in its order."""
        names = [n for n, _ in self.model.named_parameters()]
        params = [p for g in self.optimizer.optimizer.param_groups for p in g["params"]]
        if [id(p) for p in params] != [id(p) for _, p in self.model.named_parameters()]:
            raise ValueError("a tensor-parallel trainer's optimizer must hold the model's "
                             "parameters in their order (make_optimizer(..., model.parameters()))")
        return names

    def state(self, epoch: int, performance: float) -> Dict:
        """The checkpoint of the run as it stands: the reference layout
        (state_dict, epoch, performance) and what a resume needs. With
        several ranks, a collective, complete on rank 0; under tensor
        parallelism the parameters and the optimizer's moments are the
        full ones."""
        state_dict = self.model.state_dict()
        optimizer = self.optimizer.optimizer.state_dict()
        if self.mesh is not None:
            state_dict = gather_state_dict(state_dict, self.mesh)
            optimizer = gather_optimizer_state(optimizer, self._param_names(), self.mesh)
        return {
            "state_dict": state_dict,
            "epoch": int(epoch),
            "performance": float(performance),
            "optimizer": optimizer,
            "scheduler": self.optimizer.scheduler.state_dict(),
            "optimizer_calls": int(self.optimizer.calls),
            "generator": self._generator_state(),
            "global_step": int(self.train_global_step),
            "best_performance": float(self.best_performance),
            "loader_state": {name: ld.state() for name, ld in self._named_loaders().items()},
        }

    def _written(self, path: str, seconds: float, nbytes: int) -> None:
        self._record(checkpoint=osp.basename(path), write_s=seconds, bytes=nbytes)
        self._log(f"checkpoint written: {path} ({nbytes / 1e6:.1f} MB in {seconds:.2f} s)")

    def _save_preempt(self):
        """The exact mid-epoch checkpoint: the state, the iterations done in
        this epoch and the loaders' positions. Written synchronously: the
        process is about to exit. Every rank enters; rank 0 writes and the
        others wait for it."""
        if not self.logdir:
            return
        state = self.state(self.epoch, self.best_performance)
        if self.rank != 0:
            dist.barrier()
            return
        state["epoch_iter"] = int(self._epoch_iters_done)
        path = save_checkpoint(self.logdir, state, name="preempt", on_success=self._written)
        self._log(f"preempt checkpoint written: {path} (epoch {self.epoch}, "
                  f"{self._epoch_iters_done}/{self.num_iters} iters)")
        dist.barrier()

    def save(self, performance: float, epoch: int):
        """The epoch checkpoint, model_best when it is the best so far, and
        best.txt after the write has landed. Every rank enters (the
        performance is the same on each, so is the best); rank 0 writes."""
        is_best = performance < self.best_performance
        if is_best:
            self.best_performance = performance
        if not self.logdir:
            return
        state = self.state(epoch, performance)
        if self.rank != 0:
            return
        best_perf = self.best_performance

        def after_write(path, seconds, nbytes):
            # after the write (the writer thread when asynchronous): best.txt
            # never names a checkpoint that is not on disk, and pruning
            # counts the file just written
            with open(osp.join(self.logdir, "best.txt"), "w") as f:
                f.write(str(best_perf))
            prune_epoch_checkpoints(self.logdir, self.save_keep_last)
            self._written(path, seconds, nbytes)

        save_checkpoint(self.logdir, state, is_best=is_best,
                        name=f"epoch_{epoch}", async_write=self.save_async,
                        on_success=after_write)

    def resume(self, path: str):
        """Restore every field of a checkpoint this trainer wrote (strict)."""
        ckpt = load_checkpoint(path)
        missing = [k for k in RESUME_FIELDS if k not in ckpt]
        if missing:
            raise KeyError(f"{path} cannot resume a run: it lacks {missing} (use --pretrained "
                           "for weights only)")
        states = ckpt["generator"]
        written_by = len(states) if isinstance(states, list) else 1
        if written_by != self.data_world:
            raise ValueError(
                f"{path} holds the dropout generators of {written_by} process(es) and this run "
                f"has {self.data_world} data rank(s): each data rank draws its masks from its "
                "own generator, so a run resumes only with the number of data ranks that wrote "
                "it, at any tp (--pretrained starts a new run from its encoder)")
        state_dict, optimizer = ckpt["state_dict"], ckpt["optimizer"]
        if self.mesh is not None:
            state_dict = shard_state_dict(state_dict, self.mesh)
            optimizer = shard_optimizer_state(optimizer, self._param_names(), self.mesh)
        self.model.load_state_dict(state_dict, strict=True)
        self.optimizer.optimizer.load_state_dict(optimizer)
        self.optimizer.scheduler.load_state_dict(ckpt["scheduler"])
        self.optimizer.calls = int(ckpt["optimizer_calls"])
        self.generator.set_state(states[self.data_rank] if isinstance(states, list) else states)
        self.train_global_step = int(ckpt["global_step"])
        self.best_performance = float(ckpt["best_performance"])
        # an epoch checkpoint's own performance is not the run's best: the
        # sibling best.txt keeps a later, worse epoch from replacing model_best
        best_txt = osp.join(osp.dirname(osp.abspath(path)), "best.txt")
        if osp.isfile(best_txt):
            try:
                with open(best_txt) as f:
                    self.best_performance = min(self.best_performance, float(f.read().strip()))
            except ValueError:
                pass
        self._resume_loader_state = {name: {k: int(v) for k, v in st.items()}
                                     for name, st in ckpt["loader_state"].items()}
        missing = set(self._named_loaders()) - set(self._resume_loader_state)
        if missing:
            raise KeyError(f"{path} has no position for the loaders {sorted(missing)}")
        if "epoch_iter" in ckpt:
            # preempt checkpoint: continue inside the recorded epoch
            self.start_epoch = int(ckpt["epoch"])
            self._resume_iter = int(ckpt["epoch_iter"])
            self._log(f"=> resumed mid-epoch from {path} (epoch {self.start_epoch}, "
                      f"iter {self._resume_iter}, best {self.best_performance:.2f})")
            return
        self.start_epoch = int(ckpt["epoch"]) + 1
        self._resume_iter = 0
        self._log(f"=> resumed from {path} (epoch {self.start_epoch}, "
                  f"best {self.best_performance:.2f})")
