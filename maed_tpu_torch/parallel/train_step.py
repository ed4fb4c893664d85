"""The stage-2 training step: both forwards (video and image), the
per-sample-count weighted loss, one backward and the optimizer update.

Port of ``maed_tpu/parallel/train_step.py``. The JAX step is one jitted
function of the train state; here the model and the optimizer hold the
state and :func:`make_train_step` returns a closure over them.

Optimizer parity: ``torch.optim.Adam(weight_decay=wd)`` adds ``wd * param``
to the gradient before the moments, which is the JAX package's
``optax.chain(add_decayed_weights(wd), scale_by_adam(), ...)``; SGD is
momentum without weight decay, as there. The learning rate follows the
warmup-then-milestones schedule as a ``LambdaLR`` stepped once per real
update. ``GRAD_ACCUM_STEPS = k`` averages the gradients of k calls into one
update, as ``optax.MultiSteps`` does, and the schedule then counts epochs
of ``steps_per_epoch // k`` updates.
"""

from __future__ import annotations

import warnings

import torch

from maed_tpu_torch.core.loss import LossWeights, image_loss, merge_loss, video_loss


def warmup_milestone_schedule(base_lr, warmup_epoch, warmup_factor, milestones,
                              steps_per_epoch):
    """The learning rate at an update count: in epoch e < warmup_epoch,
    base_lr * (e + 1) * warmup_factor; after it, base_lr * 0.1 per milestone
    passed (epoch >= milestone)."""
    def schedule(step):
        epoch = step // steps_per_epoch
        if epoch < warmup_epoch:
            return base_lr * ((epoch + 1.0) * warmup_factor)
        decayed = 1.0
        for m in milestones:
            decayed = decayed * (0.1 if epoch >= m else 1.0)
        return base_lr * decayed

    return schedule


class TrainOptimizer:
    """A torch optimizer, its ``LambdaLR`` schedule and the gradient
    accumulation of ``accum_steps`` calls per update.

    A step's calls are :meth:`zero_grad`, the backward of the loss divided by
    ``accum_steps``, then :meth:`step`. The gradients are cleared at the
    first call of each cycle of ``accum_steps`` and summed over it; the k-th
    call updates the parameters and steps the schedule. After an update the
    parameters' ``.grad`` still hold the gradient it applied.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LambdaLR, accum_steps: int = 1):
        self.optimizer, self.scheduler, self.accum_steps = optimizer, scheduler, accum_steps
        self.calls = 0

    def zero_grad(self) -> None:
        if self.calls % self.accum_steps == 0:
            self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """Count a call; update on the last of a cycle. Returns whether it did."""
        self.calls += 1
        if self.calls % self.accum_steps:
            return False
        self.optimizer.step()
        self.scheduler.step()
        return True


def make_optimizer(cfg_optim, steps_per_epoch: int, params) -> TrainOptimizer:
    """Adam or SGD over ``params`` with the warmup-then-milestones schedule
    and ``cfg_optim.GRAD_ACCUM_STEPS`` (default 1) calls per update.

    ``cfg_optim`` carries the JAX package's keys: OPTIM ('adam' or 'sgd'),
    LR, WD (Adam's L2, added to the gradient), MOMENTUM (SGD's),
    WARMUP_EPOCH, WARMUP_FACTOR, MILESTONES. The schedule counts real
    updates, so with k > 1 an epoch is ``steps_per_epoch // k`` of them:
    exact when k divides ``steps_per_epoch``, and a warning says by how much
    the epochs drift when it does not.
    """
    accum = int(getattr(cfg_optim, "GRAD_ACCUM_STEPS", 1) or 1)
    if accum > 1 and steps_per_epoch % accum != 0:
        warnings.warn(
            f"GRAD_ACCUM_STEPS={accum} does not divide steps_per_epoch="
            f"{steps_per_epoch}: the LR schedule's epoch boundaries drift by "
            f"{steps_per_epoch % accum}/{accum} updates per epoch. Pick k "
            "dividing the per-epoch iteration count (or adjust "
            "num_iters_per_epoch) for an exact warmup/milestone schedule.",
            stacklevel=2)
    updates_per_epoch = max(1, steps_per_epoch // accum) if accum > 1 else steps_per_epoch
    name = cfg_optim.OPTIM.lower()
    if name == "adam":
        optimizer = torch.optim.Adam(params, lr=cfg_optim.LR, weight_decay=cfg_optim.WD)
    elif name == "sgd":
        optimizer = torch.optim.SGD(params, lr=cfg_optim.LR, momentum=cfg_optim.MOMENTUM)
    else:
        raise NotImplementedError(cfg_optim.OPTIM)
    # LambdaLR multiplies the base rate by the schedule of a unit rate
    scale = warmup_milestone_schedule(1.0, cfg_optim.WARMUP_EPOCH, cfg_optim.WARMUP_FACTOR,
                                      list(cfg_optim.MILESTONES), updates_per_epoch)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, scale)
    return TrainOptimizer(optimizer, scheduler, accum)


def make_train_step(model, optimizer: TrainOptimizer, smpl_model, loss_weights: LossWeights,
                    generator: torch.Generator | None = None, plain: bool = False):
    """``step(vid_batch, img_batch) -> metrics`` for a model in training mode.

    vid_batch: {'images' (Nv, T, H, W, 3), 'target_3d': {'kp_2d', 'kp_3d',
    'theta', 'w_smpl'}, 'target_2d': {'kp_2d'} or absent}, the 2D clips
    first; img_batch: {'image' (Ni, H, W, 3), 'kp_2d', 'kp_3d' (optional),
    'theta'}. Either may be None. The step runs the video forward, the image
    forward (clips of one frame), the loss weighted by frame counts (w_vid =
    nt_vid / (nt_vid + nt_img)), one backward and ``optimizer.step()``. Its
    dropout masks come from ``generator``; ``plain=True`` runs the kernels'
    plain versions. Returns the total loss and the merged terms as detached
    tensors on the device (reading them waits for the step).
    """

    def step(vid_batch: dict | None, img_batch: dict | None) -> dict:
        nt_vid = 0 if vid_batch is None else (
            vid_batch["images"].shape[0] * vid_batch["images"].shape[1])
        nt_img = 0 if img_batch is None else img_batch["image"].shape[0]
        w_vid = nt_vid / (nt_img + nt_vid)
        w_img = 1.0 - w_vid

        optimizer.zero_grad()
        loss_vid = loss_img = 0.0
        vid_dict, img_dict = {}, {}
        if vid_batch is not None:
            preds = model(vid_batch["images"], smpl_model, plain=plain, generator=generator)
            loss_vid, vid_dict = video_loss(preds, vid_batch["target_3d"],
                                            vid_batch.get("target_2d"), loss_weights)
        if img_batch is not None:
            preds_img = model(img_batch["image"][:, None], smpl_model, plain=plain,
                              generator=generator)
            loss_img, img_dict = image_loss(preds_img, img_batch, loss_weights)
        total = loss_vid * w_vid + loss_img * w_img
        (total / optimizer.accum_steps).backward()
        optimizer.step()

        _, merged = merge_loss(loss_vid, vid_dict, loss_img, img_dict, w_vid, w_img)
        return {"loss": total.detach(), **{k: v.detach() for k, v in merged.items()}}

    return step


def debug_nan_params(model) -> list[str]:
    """Names of the parameters whose gradient holds a NaN or an infinity
    (the companion of a trainer's stop on a non-finite loss)."""
    return [name for name, p in model.named_parameters()
            if p.grad is not None and not torch.isfinite(p.grad).all()]
