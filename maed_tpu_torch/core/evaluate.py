"""Evaluator: temporal-sliding clip inference + metrics on the device.

Port of ``maed_tpu/core/evaluate.py``.

Protocol: the eval loader yields SAMPLE_POOL(=128)-frame windows; they are
strided into ``sample_freq = (pool // interp) // seqlen`` interleaved
seqlen-frame clips (``images[:, ::interp][:, i::sample_freq]``), each run
through one forward; predictions are re-interleaved (stack axis=2), linearly
interpolated back to the original frame rate when interp > 1, and
deduplicated with the window 'valid' mask. MPJPE / PA-MPJPE / ACCEL run on
the device in f32; PVE rebuilds GT vertices through the SMPL body in
device-sized chunks. Joint selection, masking, merging and interpolation are
host numpy after the fetch.

The forward sees a fixed (batch, seqlen) shape: a ragged last batch is
zero-padded to ``batch_size`` and the padding dropped after. With
DATASET.DEVICE_CROP a window batch carries raw frames and their crop
affines (``trans``); both are strided and padded alike, and the forward is
handed the pack {'frames', 'trans'} on the device, which it crops there
(``ops.image.apply_device_preproc``). A sub-clip goes
to the card through pinned memory without blocking the host, and all forwards
of a window batch are started before any result is fetched, so the host's
slicing and the fetches overlap the card's work.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from maed_tpu_torch.data.dataset import save_db
from maed_tpu_torch.ops.joints import J49_TO_H36M, J49_TO_J14, JID_DICT, REGRESSOR_DICT
from maed_tpu_torch.ops.metrics import eval_metrics, vert_error
from maed_tpu_torch.ops.smpl import SMPLModel, smpl_forward
from maed_tpu_torch.parallel import dist

DATA_DIR = "data/smpl_data"  # where the external regressors are looked for
GT_VERTS_CHUNK = 5000        # poses a GT-vertex rebuild takes at once
SAVE_FIELDS = ("pred_theta", "pred_verts", "paths", "bboxes")  # what inference.pkl holds


def load_eval_regressor(dataset_name: str, data_dir: Optional[str] = None,
                        allow_missing: bool = False) -> Optional[np.ndarray]:
    """Load the external joint regressor a dataset's eval protocol demands.

    3dpw/h36m metrics are J14/J17 subsets of the h36m regressor's joints
    (JID_DICT indexes into ITS bank): running without the file would both
    mis-select from the 49-joint native bank and be incomparable to
    published numbers, so a missing required file is a hard failure.
    """
    fname = REGRESSOR_DICT.get(dataset_name)
    if fname is None:
        return None
    path = osp.join(data_dir or DATA_DIR, fname)
    if not osp.isfile(path):
        if allow_missing:
            print(f"WARNING: eval regressor '{path}' not found: "
                  f"{dataset_name} metrics will use the model's native "
                  "joint bank and are NOT comparable to the reference "
                  "protocol.", file=sys.stderr)
            return None
        raise FileNotFoundError(
            f"{dataset_name} evaluation requires '{fname}' "
            f"(J14-on-h36m metric protocol); place it at {path}. "
            "Pass J_regressor= explicitly or allow_missing=True to run "
            "with the model's native joint bank (metrics then NOT "
            "comparable to published numbers).")
    return np.load(path).astype(np.float32)


def merge_sequence(seq):
    """Re-interleave sample_freq sub-clips: list of (N, T/f, ...) arrays ->
    (N*T, ...) in original temporal order."""
    arr = np.stack(seq, axis=2)  # (N, T/f, f, ...)
    return arr.reshape((-1,) + arr.shape[3:])


def interpolate_sequence(sequence: np.ndarray, orig_len: int, interp_len: int) -> np.ndarray:
    """Linear interpolation of the skipped frames (interp > 1 eval mode)."""
    if orig_len == interp_len:
        return sequence
    from scipy.interpolate import interp1d

    sequence = sequence.reshape((-1, interp_len) + sequence.shape[1:])
    x = np.linspace(1.0, 0.0, num=interp_len, endpoint=False)[::-1]
    f = interp1d(x, sequence, axis=1, fill_value="extrapolate")
    new_x = np.linspace(0.0, 1.0, num=orig_len, endpoint=True)
    ret = f(new_x)
    return ret.reshape((-1,) + ret.shape[2:])


def _flat(x) -> np.ndarray:
    """(N, P, ...) -> (N*P, ...)."""
    x = np.asarray(x)
    return x.reshape((-1,) + x.shape[2:])


class Evaluator:
    """Accumulates predictions window-by-window, then computes metrics.

    ``forward`` is a callable ``(images, J_regressor) -> dict`` with the
    outputs of ``models.maed.MAED.forward``: the model bound to its SMPL
    body, e.g. ``lambda x, jreg: model(x, smpl, J_regressor=jreg)``; for
    DEVICE_CROP data ``images`` is a {'frames', 'trans'} pack, which the
    forward resolves with ``ops.image.apply_device_preproc``. It and the
    metrics run on the device that holds ``smpl_model``.
    """

    def __init__(self, smpl_model: SMPLModel):
        self.smpl_model = smpl_model
        self.device = smpl_model.v_template.device
        self.accumulators = defaultdict(list)
        self._pinned: Dict[tuple, torch.Tensor] = {}  # (sub-clip slot, leaf) -> pinned buffer

    def _to_device(self, clip: np.ndarray, slot: tuple) -> torch.Tensor:
        """The strided sub-clip ``slot`` of a window batch on the device. On a
        card it is sliced straight into that slot's pinned buffer and uploaded
        without blocking the host. The buffer is written again only in the
        next window batch, after every result of this one was fetched, so the
        upload has left it by then."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(clip))
        staged = self._pinned.get(slot)
        dtype = torch.from_numpy(np.empty(0, clip.dtype)).dtype
        if staged is None or staged.shape != clip.shape or staged.dtype != dtype:
            staged = torch.empty(clip.shape, dtype=dtype, pin_memory=True)
            self._pinned[slot] = staged
        np.copyto(staged.numpy(), clip)
        return staged.to(self.device, non_blocking=True)

    # ------------------------------------------------------------------ #
    def inference(
        self,
        forward: Callable,
        dataloader,
        seqlen: int = 16,
        interp: int = 1,
        dataset_name: str = "3dpw",
        J_regressor: Optional[np.ndarray] = None,
        batch_size: Optional[int] = None,
        verbose: bool = True,
        allow_missing_regressor: bool = False,
        data_dir: Optional[str] = None,
    ):
        self.accumulators = defaultdict(list)
        if J_regressor is None:
            J_regressor = load_eval_regressor(
                dataset_name, data_dir, allow_missing=allow_missing_regressor)
        Jid = JID_DICT.get(dataset_name, None)
        native_fallback = (REGRESSOR_DICT.get(dataset_name) is not None
                           and J_regressor is None)
        if native_fallback:
            # native-joint-bank smoke path (allow_missing): JID_DICT indexes
            # the REGRESSOR's bank, so selecting with it here would silently
            # pick wrong joints from the 49-joint native bank. The matching
            # native selection depends on how the GT was stored (real 3dpw
            # DBs pre-select 14 h36m-common joints; synthetic fixtures keep
            # all 49): resolved per batch from the GT's joint count below.
            Jid = None
        jreg_dev = None if J_regressor is None else torch.as_tensor(
            np.asarray(J_regressor), dtype=torch.float32, device=self.device)

        start = time.time()
        n_batches = 0
        for target in dataloader:
            # (N, P, H, W, 3) cropped clips, or with DEVICE_CROP the raw frames
            # and their (N, P, 2, 3) affines: both leaves share the (N, P)
            # leading axes and are strided and padded alike
            leaves = {"frames": np.asarray(target["images"])}
            if "trans" in target:
                leaves["trans"] = np.asarray(target["trans"])
            N = leaves["frames"].shape[0]
            if batch_size is not None and N < batch_size:
                leaves = {k: np.concatenate([a, np.zeros((batch_size - N,) + a.shape[1:],
                                                         a.dtype)], axis=0)
                          for k, a in leaves.items()}

            orig_len = leaves["frames"].shape[1]
            interp_len = leaves["frames"][:, ::interp].shape[1]
            sample_freq = interp_len // seqlen

            # joints with nonzero conf in the first target frame define the
            # target joint subset (static per dataset)
            kp3d = np.asarray(target["kp_3d"])
            valid_joints = [j for j in range(kp3d.shape[2]) if kp3d[0, 0, j, -1]]
            if native_fallback and Jid is None and kp3d.shape[2] != 49:
                # match the GT's stored bank from the native 49-joint bank
                Jid = {14: J49_TO_J14, 17: J49_TO_H36M}.get(kp3d.shape[2])
                if Jid is None:
                    raise ValueError(
                        f"cannot run the native-joint-bank fallback: GT has "
                        f"{kp3d.shape[2]} joints (no J49 mapping known)")

            # start every sub-clip forward before fetching any result: the
            # launches return before the card is done, so the (large: verts
            # alone is ~21 MB per flagship sub-clip) fetches and the host-side
            # merge below overlap the remaining sub-clips' device work
            def sub_clip(i):
                on_device = {k: self._to_device(a[:, ::interp][:, i::sample_freq], (i, k))
                             for k, a in leaves.items()}
                return on_device if "trans" in on_device else on_device["frames"]

            pending = [forward(sub_clip(i), jreg_dev) for i in range(sample_freq)]
            per_clip = defaultdict(list)
            for dev_preds in pending:
                preds = {k: v[:N].cpu().numpy() for k, v in dev_preds.items()}
                per_clip["verts"].append(preds["verts"])
                per_clip["j3d"].append(preds["kp_3d"][:, :, Jid] if Jid else preds["kp_3d"])
                per_clip["j2d"].append(preds["kp_2d"][:, :, Jid] if Jid else preds["kp_2d"])
                per_clip["theta"].append(preds["theta"])
                per_clip["rotmat"].append(preds["rotmat"])
            del pending

            valid_seq = np.asarray(target["valid"]).reshape(-1)

            for key, out_key in [
                ("verts", "pred_verts"), ("j3d", "pred_j3d"), ("j2d", "pred_j2d"),
                ("theta", "pred_theta"), ("rotmat", "pred_rotmat"),
            ]:
                merged = interpolate_sequence(
                    merge_sequence(per_clip[key]), orig_len, interp_len
                )[valid_seq]
                self.accumulators[out_key].append(merged)

            # GT presence must be uniform across the run: a GT-free batch in
            # a GT run would silently misalign the pred/target accumulators
            if n_batches == 0:
                self._has_gt = bool(valid_joints)
            elif self._has_gt != bool(valid_joints):
                raise RuntimeError(
                    f"batch {n_batches} {'lost' if self._has_gt else 'gained'}"
                    " GT joints mid-run (probe frame confidence flipped): "
                    "mixed GT/GT-free data cannot be scored consistently")
            if valid_joints:
                self.accumulators["target_j3d"].append(_flat(kp3d[:, :, valid_joints])[valid_seq])
                self.accumulators["target_j2d"].append(
                    _flat(np.asarray(target["kp_2d"])[:, :, valid_joints])[valid_seq]
                )
                self.accumulators["target_theta"].append(_flat(target["theta"])[valid_seq])
            # else: GT-free inference: predictions only; calling evaluate()
            # afterwards has nothing to score and raises

            if "instance_id" in target:
                ids = np.reshape(np.array(target["instance_id"]), (-1,))[valid_seq]
                self.accumulators["instance_id"].append(ids)
            if "paths" in target:
                paths = np.reshape(np.array(target["paths"]), (-1,))[valid_seq]
                self.accumulators["paths"].append(paths)
            if "bbox" in target:
                bb = np.reshape(np.asarray(target["bbox"]), (-1, 4))[valid_seq]
                self.accumulators["bboxes"].append(bb)
            n_batches += 1

        if verbose:
            dt = time.time() - start
            print(f"[Evaluating] {n_batches} batches in {dt:.1f}s")

    # ------------------------------------------------------------------ #
    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def _gt_verts(self, target_theta: np.ndarray) -> torch.Tensor:
        """GT vertices (n, V, 3) on the device, rebuilt from theta (n, 85)
        through the SMPL body."""
        theta = self._on_device(target_theta)
        return smpl_forward(self.smpl_model, theta[:, 75:],
                            pose_axis_angle=theta[:, 3:75])["vertices"]

    @torch.inference_mode()
    def evaluate(self, save_path: str = "") -> tuple[Dict[str, float], int]:
        """The five metrics (mm) over the accumulated poses, and their count;
        with ``save_path``, :meth:`save_result` writes the predictions there."""
        if "target_j3d" not in self.accumulators:
            raise RuntimeError(
                "no ground truth accumulated: the input had no confident "
                "3D joints (GT-free inference); predictions exist but there "
                "is nothing to score")
        acc = {k: np.concatenate(v, axis=0) for k, v in self.accumulators.items()}
        self.accumulators = defaultdict(list)
        self.accumulators.update({k: [v] for k, v in acc.items()})
        num_pred = len(acc["pred_j3d"])

        # the 3x3 algebra of the alignment has a 0.5 mm parity budget: no TF32
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            md = eval_metrics(self._on_device(acc["pred_j3d"]),
                              self._on_device(acc["target_j3d"][:, :, :-1]),
                              self._on_device(acc["target_j3d"][:, :, -1:]))
            pve = torch.cat([
                vert_error(self._on_device(acc["pred_verts"][s:s + GT_VERTS_CHUNK]),
                           self._gt_verts(acc["target_theta"][s:s + GT_VERTS_CHUNK]))
                for s in range(0, num_pred, GT_VERTS_CHUNK)])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

        m2mm = 1000.0
        eval_dict = {
            "mpjpe": md["mpjpe"].mean().item() * m2mm,
            "pa-mpjpe": md["pa_mpjpe"].mean().item() * m2mm,
            "pve": pve.mean().item() * m2mm,
            "accel": md["accel"].mean().item() * m2mm,
            "accel_err": md["accel_err"].mean().item() * m2mm,
        }
        if save_path:
            self.save_result(save_path)
        return eval_dict, num_pred

    def sync_metrics(self, eval_dict, num_pred):
        """The metrics over every process's shard of the windows: each
        metric's mean over the processes weighted by their prediction
        counts, and the total count (``maed_tpu/core/evaluate.py:349``).
        One process: the arguments."""
        return dist.weighted_mean(eval_dict, num_pred)

    def log(self, eval_dict, num_pred, desc=""):
        print(f"Evaluated on {int(num_pred)} poses.")
        print(desc + " ".join(f"{k.upper()}: {v:.4f}," for k, v in eval_dict.items()))

    def run(self, forward, dataloader, seqlen=16, interp=1, dataset_name="3dpw",
            J_regressor=None, save_path="", verbose=True, batch_size=None,
            allow_missing_regressor=False, data_dir=None):
        self.inference(forward, dataloader, seqlen=seqlen, interp=interp,
                       dataset_name=dataset_name, J_regressor=J_regressor,
                       batch_size=batch_size, verbose=verbose,
                       allow_missing_regressor=allow_missing_regressor, data_dir=data_dir)
        eval_dict, num_pred = self.evaluate(save_path)
        eval_dict, num_pred = self.sync_metrics(eval_dict, num_pred)
        if verbose:
            self.log(eval_dict, num_pred)
        return eval_dict, num_pred

    def count_attn(self, model, images, smpl_model):
        """Collect the parallel-mode spatial/temporal gate weights per block:
        {block_name: (NT, C) mean gate toward the spatial branch}, from one
        forward of ``model`` (a ``models.maed.MAED``) on ``images``."""
        model(images, smpl_model)
        gates = {}
        for i, block in enumerate(model.encoder.blocks):
            alpha = block.attn.last_gate  # (NT, 1, C, 2), None but in parallel mode
            if alpha is not None:
                gates[f"encoder/blocks_{i}/attn"] = alpha[:, 0, :, 0].float().cpu().numpy()
        return gates

    def save_result(self, save_path):
        """Write ``<save_path>/inference.pkl``: the predicted theta and
        vertices, and the frames' paths and bboxes where the data had them,
        one row a pose. Written by joblib where it is installed (as the JAX
        package does), else as a plain pickle, which joblib.load also reads."""
        os.makedirs(save_path, exist_ok=True)
        acc = {k: np.concatenate(v, axis=0) for k, v in self.accumulators.items()
               if k in SAVE_FIELDS}
        save_db(acc, osp.join(save_path, "inference.pkl"))
