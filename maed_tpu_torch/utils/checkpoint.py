"""Checkpoints: ``.pth.tar`` files in the reference layout, their writes, the
three load policies, and transforms for inference.

Port of ``maed_tpu/utils/checkpoint.py``, whose orbax directories become
``torch.save`` files. A checkpoint is a dict with the model's ``state_dict``
under the reference names (those ``utils/weights.py`` maps flax trees to),
``epoch`` and ``performance``, the layout of the original MAED's
checkpoints and of ``python -m maed_tpu.utils.torch_convert``'s export; the
trainer adds what an exact resume needs (the optimizer, the schedule, the
dropout generator, the loaders' positions, ...). A file is written to a
temporary name and renamed into place, so a crash never leaves a partial
file under a name that loads. The load policies: :func:`load_pretrained_state`
(the stage-2 init: the encoder only, a key of another shape reported and
skipped), ``core.builder.build_eval_model`` (every weight, strict) and
``core.trainer.Trainer.resume`` (strict, every field).
"""

from __future__ import annotations

import os
import os.path as osp
import re
import shutil
import threading
import time
from typing import Callable, List, Optional

import torch

# At most one write is in flight; a failed background write is re-raised at
# the next synchronization point (the next save, any load, or
# wait_pending_saves at the end of training), so it cannot pass silently.
_pending: List[threading.Thread] = []
_pending_error: List[BaseException] = []


def wait_pending_saves() -> None:
    """Block until the in-flight asynchronous write, if any, has finished.

    Re-raises the background writer's exception, if it had one."""
    while _pending:
        _pending.pop().join()
    if _pending_error:
        raise _pending_error.pop()


def to_cpu(state):
    """An owning CPU copy of every tensor in a nested dict / list (the
    state may change or be freed as soon as this returns)."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(to_cpu(v) for v in state)
    return state


def _replace_file(write: Callable[[str], None], path: str) -> None:
    """Write through a temporary name beside ``path``, then rename it into
    place (atomic on one filesystem)."""
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)


def _write(path: str, state: dict, is_best: bool) -> tuple[float, int]:
    """Write ``state`` to ``path`` (and copy it to model_best.pth.tar when
    ``is_best``); returns (seconds, bytes) of the write."""
    t0 = time.perf_counter()
    _replace_file(lambda tmp: torch.save(state, tmp), path)
    if is_best:
        # the previous best stays whole under its name until the new copy
        # is complete
        best = osp.join(osp.dirname(path), "model_best.pth.tar")
        _replace_file(lambda tmp: shutil.copyfile(path, tmp), best)
    return time.perf_counter() - t0, osp.getsize(path)


def save_checkpoint(ckpt_dir: str, state: dict, is_best: bool = False,
                    name: str = "checkpoint", async_write: bool = False,
                    on_success: Optional[Callable[[str, float, int], None]] = None) -> str:
    """Save ``state`` as ``<ckpt_dir>/<name>.pth.tar``; returns the path.

    The state is copied to the CPU first, synchronously, so the caller may
    go on changing it. ``async_write=True`` runs the file write on a
    background thread; writes are serialized (a new save waits for the
    previous one), and :func:`load_checkpoint` and :func:`wait_pending_saves`
    wait for it. ``on_success(path, seconds, bytes)`` runs after the write
    lands (on the writer thread when asynchronous), so bookkeeping tied to
    the file on disk cannot run ahead of it.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = osp.join(osp.abspath(ckpt_dir), f"{name}.pth.tar")
    snapshot = to_cpu(state)
    wait_pending_saves()

    def run():
        seconds, nbytes = _write(path, snapshot, is_best)
        if on_success is not None:
            on_success(path, seconds, nbytes)

    if not async_write:
        run()
        return path

    def run_async():
        try:
            run()
        except BaseException as e:  # re-raised at the next sync point
            _pending_error.append(e)

    # not a daemon: the interpreter joins the writer at exit, so an exception
    # unwinding past the trainer cannot kill a write mid-flight
    t = threading.Thread(target=run_async, name=f"ckpt-write-{name}", daemon=False)
    t.start()
    _pending.append(t)
    return path


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """A ``.pth.tar`` as saved (tensors on ``map_location``). Loads tensors
    and plain containers only (``weights_only``): no code runs."""
    wait_pending_saves()
    return torch.load(path, map_location=map_location, weights_only=True)


def state_dict_of(ckpt: dict) -> dict:
    """The model weights of a loaded checkpoint: its ``state_dict`` (or the
    dict itself, for a bare state_dict), without the ``module.`` prefix a
    DistributedDataParallel model (and the published checkpoints) have."""
    sd = ckpt.get("state_dict", ckpt)
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def load_pretrained_state(model: torch.nn.Module, state_dict: dict,
                          drop_decoder: bool = True) -> list[str]:
    """Stage-2 init policy: copy the checkpoint's weights into ``model``
    where the name exists and the shape matches, skipping the decoder (the
    reference found stage-1 decoder weights hurt stage 2). Returns the keys
    not used: absent from the model, or of another shape (named with both)."""
    own = model.state_dict()
    unused, take = [], {}
    for key, value in state_dict.items():
        if drop_decoder and key.split(".")[0] == "decoder":
            continue
        if key not in own:
            unused.append(key)
        elif tuple(own[key].shape) != tuple(value.shape):
            unused.append(f"{key} (shape {tuple(value.shape)} != {tuple(own[key].shape)})")
        else:
            take[key] = value
    model.load_state_dict(take, strict=False)
    return unused


def find_auto_resume(output_dir: str, exp_name: str = "") -> str:
    """Resolve TRAIN.RESUME='auto': the newest resumable checkpoint under any
    run dir in ``output_dir``, or '' if none exists (fresh start).

    Candidates are ``<run>/preempt.pth.tar`` (a SIGTERM stop, mid-epoch) and
    ``<run>/epoch_N.pth.tar`` (end-of-epoch saves, what a hard crash leaves
    behind); the newest by mtime wins, so a supervisor can relaunch the
    same command after both. ``model_best.pth.tar`` (a copy of some epoch
    file, maybe older than the latest) and temporary files are excluded by
    a strict whitelist of names. ``exp_name`` restricts the scan to this
    experiment's run dirs (``<timestamp>_<exp_name>``, the layout of
    ``logging_utils.prepare_output_dir``).
    """
    candidates = []
    if not osp.isdir(output_dir):
        return ""
    for run in os.listdir(output_dir):
        if exp_name and not run.endswith(f"_{exp_name}"):
            continue
        rdir = osp.join(output_dir, run)
        if not osp.isdir(rdir):
            continue
        for name in os.listdir(rdir):
            if not re.fullmatch(r"epoch_\d+\.pth\.tar|preempt\.pth\.tar", name):
                continue
            path = osp.join(rdir, name)
            if osp.isfile(path):
                candidates.append((os.path.getmtime(path), path))
    return max(candidates)[1] if candidates else ""


def prune_epoch_checkpoints(ckpt_dir: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` epoch_N.pth.tar (-1 keeps all, as the
    reference does; 0 keeps 1, so the newest is never deleted under a run).
    model_best.pth.tar and best.txt are never touched."""
    if keep_last < 0:
        return
    epochs = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"epoch_(\d+)\.pth\.tar", name)
        if m:
            epochs.append((int(m.group(1)), name))
    for _, name in sorted(epochs)[: max(0, len(epochs) - max(1, keep_last))]:
        os.remove(osp.join(ckpt_dir, name))


def fold_weight_standardization(state_dict: dict, eps: float = 1e-5) -> dict:
    """Pre-standardize the StdConv weights for inference.

    Weight standardization is idempotent up to the eps term, so folding it
    into the stored weights and running the model with
    ``standardize_ws=False`` gives the same outputs without ~50 weight
    reductions per forward. Applies to every 4-D weight under a ``backbone``
    module (the only StdConv user); computed in f32, as the JAX package does.
    """
    out = {}
    for key, value in state_dict.items():
        if "backbone" in key.split(".") and key.endswith(".weight") and value.ndim == 4:
            w = torch.as_tensor(value).to(torch.float32)
            mean = w.mean(dim=(1, 2, 3), keepdim=True)
            var = w.var(dim=(1, 2, 3), correction=0, keepdim=True)
            out[key] = (w - mean) / (torch.sqrt(var) + eps)
        else:
            out[key] = value
    return out
