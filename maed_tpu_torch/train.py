"""Training CLI of the port:

    python -m maed_tpu_torch.train --cfg configs/config_stage1.yaml [KEY VALUE ...]
    python -m maed_tpu_torch.train --cfg configs/config_stage2.yaml \
        [--init_backbone in21k.npz|.pth] [--pretrained stage1.pth.tar] \
        [--allow_synthetic_smpl] [KEY VALUE ...]
    python -m torch.distributed.run --standalone --nproc_per_node W \
        -m maed_tpu_torch.train --cfg ... [KEY VALUE ...]
    MAED_MESH_TP=2 [MAED_MESH_DCN=d] python -m torch.distributed.run \
        --standalone --nproc_per_node W -m maed_tpu_torch.train --cfg ...

Port of the JAX package's ``train.py``. Under torchrun, W processes train
data parallel (``parallel.dist``: NCCL, one card a process; gloo with
``DEVICE cpu``), each on its shard of every loader, as one process on the
global batch of W times the config's batch sizes does; rank 0 alone logs
and writes, and every rank draws its dropout masks from a generator of its
own (rank 0's from the seed a single process uses). MAED_MESH_TP and
MAED_MESH_DCN lay the W ranks out as the JAX package's ``train.py`` reads
them (``parallel.mesh.make_mesh``: W = dcn x dp x tp): each ViT block is
split over the tp ranks, which hold the same batch and draw the same masks
(one generator a data rank), and the data goes over the dcn x dp data
ranks. MAED_MESH_TP must divide the heads and the MLP's width 4C. The
model from the config's MODEL section (``core.builder.build_train_model``
in f32: stage 1's ResNet-50 + KTD, stage 2's STE + KTD), then the published
encoder init (``--init_backbone``, ``utils.pretrained``) and a stage-1
checkpoint's encoder (``--pretrained``), in that order; the loaders
(``data.loaders.get_data_loaders``), Adam and its schedule
(``parallel.train_step.make_optimizer``), the step
(``parallel.train_step.make_train_step``) and ``core.trainer.Trainer``.
It runs on the card unless the config says ``DEVICE cpu``, and fails when
no card is visible. A SIGTERM stops it after the step in flight with
``preempt.pth.tar`` written; it then exits 0, or MAED_PREEMPT_EXIT when
that is set, and ``TRAIN.RESUME auto`` continues the run.
"""

from __future__ import annotations

import os
import sys

# data rank r > 0 seeds its dropout generator with SEED_VALUE + r * this
RANK_SEED_STRIDE = 1_000_003


def main(argv=None):
    """Returns the Trainer after its run (it exits on a preemption)."""
    # imported here, not at the top: loader workers started from a forkserver
    # import the main module, and should not pay for torch and the model
    import numpy as np
    import torch

    from maed_tpu_torch.core.builder import (build_train_model, configure_backends, device_of,
                                             load_weights, model_config)
    from maed_tpu_torch.core.config import parse_args
    from maed_tpu_torch.core.loss import LossWeights
    from maed_tpu_torch.core.trainer import Trainer
    from maed_tpu_torch.data.loaders import get_data_loaders
    from maed_tpu_torch.ops.image import apply_device_preproc
    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel.mesh import make_mesh
    from maed_tpu_torch.parallel.train_step import make_optimizer, make_train_step
    from maed_tpu_torch.utils.checkpoint import load_pretrained_state
    from maed_tpu_torch.utils.logging_utils import create_logger, prepare_output_dir
    from maed_tpu_torch.utils.pretrained import apply_pretrained_backbone

    args, cfg, _ = parse_args(argv)
    rank, world = dist.init_from_env(cpu=str(cfg.DEVICE).lower() == "cpu")
    # the JAX train.py's mesh from the environment (default: data parallel over every rank)
    mesh = make_mesh(tp=int(os.environ.get("MAED_MESH_TP", "1")),
                     dcn=int(os.environ.get("MAED_MESH_DCN", "1")))
    device = device_of(cfg)
    configure_backends(cfg)

    logdir, logger = "", None
    if rank == 0:
        logdir = prepare_output_dir(cfg.OUTPUT_DIR, cfg.EXP_NAME, cfg.dump())
        logger = create_logger(logdir)
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        logger.info(f"device: {device} ({name}), torch {torch.__version__}, process {rank} of "
                    f"{world}, mesh {mesh.shape}")
    # every rank enters the checkpoint writes, which rank 0 makes in its directory
    logdir = dist.broadcast_str_from_rank0(logdir)

    def log(msg):
        if logger is not None:
            logger.info(msg)

    seed = max(cfg.SEED_VALUE, 0)
    if cfg.SEED_VALUE >= 0:
        np.random.seed(cfg.SEED_VALUE)
        torch.manual_seed(cfg.SEED_VALUE)

    model, smpl = build_train_model(**model_config(cfg), device=device, seed=seed,
                                    allow_synthetic_smpl=args.allow_synthetic_smpl)
    if args.init_backbone:
        apply_pretrained_backbone(model, args.init_backbone)
        log(f"=> loaded the published backbone init from {args.init_backbone}")
    if args.pretrained:
        unused = load_pretrained_state(model, load_weights(args.pretrained), drop_decoder=True)
        log(f"=> loaded the pretrained encoder from {args.pretrained}"
            + (f"; {len(unused)} keys unused: {unused[:5]}" if unused else ""))
    dist.broadcast_module(model)  # every rank starts from rank 0's weights
    if mesh.tp > 1:  # then keeps its shards of them
        model, _ = build_train_model(**model_config(cfg), device=device,
                                     state_dict=model.state_dict(), mesh=mesh,
                                     allow_synthetic_smpl=args.allow_synthetic_smpl)

    loaders = get_data_loaders(cfg, rank=mesh.data_rank, world_size=mesh.data_world,
                               verbose=rank == 0)
    steps_per_epoch = (
        cfg.TRAIN.NUM_ITERS_PER_EPOCH
        if cfg.TRAIN.NUM_ITERS_PER_EPOCH > 0
        else max(len(ld) for k, ld in loaders.items() if k.startswith("train"))
    )
    optimizer = make_optimizer(cfg.TRAIN.OPTIM, steps_per_epoch, model.parameters())
    weights = LossWeights(
        kp_2d=cfg.LOSS.KP_2D_W, kp_3d=cfg.LOSS.KP_3D_W, shape=cfg.LOSS.SHAPE_W,
        pose=cfg.LOSS.POSE_W, norm=cfg.LOSS.SMPL_NORM, accl=cfg.LOSS.ACCL_W,
    )
    # each data rank its own masks; data rank 0 those of a single process
    generator = torch.Generator(device=device).manual_seed(
        seed + RANK_SEED_STRIDE * mesh.data_rank)
    train_step = make_train_step(model, optimizer, smpl, weights, generator)

    def eval_forward(images, J_regressor=None):
        # a DEVICE_CROP pack (raw frames and affines) is cropped on the device
        images = apply_device_preproc(images, cfg.DATASET.HEIGHT, cfg.DATASET.WIDTH)
        return model(images, smpl, J_regressor=J_regressor)

    trainer = Trainer(
        data_loaders=loaders, train_step=train_step, model=model, optimizer=optimizer,
        generator=generator, smpl_model=smpl, cfg=cfg, logdir=logdir,
        eval_forward=eval_forward, logger=logger,
        num_iters_per_epoch=cfg.TRAIN.NUM_ITERS_PER_EPOCH,
        allow_missing_regressor=args.allow_synthetic_smpl,
        log_freq=cfg.DEBUG_FREQ,
    )
    trainer.fit()
    dist.shutdown()
    if trainer.preempted:
        log(f"preempted — resume with TRAIN.RESUME={logdir}/preempt.pth.tar "
            "(or TRAIN.RESUME auto)")
        # 0 by default (pod managers read nonzero as a failure); a relaunch
        # loop that must tell "preempted" from "finished" sets MAED_PREEMPT_EXIT
        sys.exit(int(os.environ.get("MAED_PREEMPT_EXIT", "0")))
    return trainer


if __name__ == "__main__":
    main()
