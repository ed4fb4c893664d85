"""Evaluation CLI of the port:

    python -m maed_tpu_torch.eval --cfg <yaml> --checkpoint <ckpt.pth.tar> \
        --eval_ds 3dpw --eval_set test [--output_path <dir>] \
        [--allow_synthetic_smpl] [KEY VALUE ...]
    [MAED_MESH_TP=t] python -m torch.distributed.run --standalone \
        --nproc_per_node W -m maed_tpu_torch.eval --cfg ... [as above]

Port of the JAX package's ``eval.py``: the model from the config in f32
(the reference protocol) with the checkpoint's weights loaded strictly
(``core.builder.load_weights``: the port's ``.pth.tar`` files and the
reference-layout export of ``python -m maed_tpu.utils.torch_convert``),
the eval set's windows (``data.dataset.VideoDataset`` over
``<DB_DIR>/<eval_ds>_<eval_set>_db.pt``, ``data.loaders.ShardedLoader``)
and ``core.evaluate.Evaluator.run``, which prints the five metrics and,
with ``--output_path``, writes ``inference.pkl`` there. It runs on the card
unless the config says ``DEVICE cpu``.

Under torchrun (NCCL, one card a rank; gloo with ``DEVICE cpu``) the W
ranks split the set as the JAX ``eval.py`` splits its clip batch over every
local device: each data rank evaluates its windows (rank r of D takes
windows r, r + D, ..., none twice), and ``Evaluator.sync_metrics``
weights the ranks' metrics by their counts; MAED_MESH_TP splits the model
over tp ranks that evaluate the same windows (``parallel.mesh``). Every
rank returns the global metrics; rank 0 prints them, and with
``--output_path`` data rank r writes its predictions to
``<output_path>/rank<r>/inference.pkl`` (one process: ``inference.pkl``
itself).
"""

from __future__ import annotations

import os


def main(argv=None):
    """Returns (metrics, poses) of the run."""
    # imported here, not at the top: loader workers started from a forkserver
    # import the main module, and should not pay for torch and the model
    import torch

    from maed_tpu_torch.core.builder import (build_eval_model, configure_backends, device_of,
                                             load_weights, model_config)
    from maed_tpu_torch.core.config import parse_args
    from maed_tpu_torch.core.evaluate import Evaluator
    from maed_tpu_torch.data.dataset import VideoDataset
    from maed_tpu_torch.data.loaders import ShardedLoader
    from maed_tpu_torch.data.transforms import build_eval_transforms
    from maed_tpu_torch.ops.image import apply_device_preproc
    from maed_tpu_torch.parallel import dist
    from maed_tpu_torch.parallel.mesh import make_mesh

    args, cfg, _ = parse_args(argv)
    rank, _ = dist.init_from_env(cpu=str(cfg.DEVICE).lower() == "cpu")
    mesh = make_mesh(tp=int(os.environ.get("MAED_MESH_TP", "1")),
                     dcn=int(os.environ.get("MAED_MESH_DCN", "1")))
    device = device_of(cfg)
    configure_backends(cfg)

    ckpt_path = args.checkpoint or args.pretrained  # the reference CLI took --pretrained
    model, smpl = build_eval_model(
        **model_config(cfg), dtype=torch.float32, device=device,
        state_dict=load_weights(ckpt_path) if ckpt_path else None,
        allow_synthetic_smpl=args.allow_synthetic_smpl, mesh=mesh)

    d = cfg.DATASET
    dataset = VideoDataset(
        args.eval_ds, args.eval_set,
        build_eval_transforms(d.WIDTH, d.HEIGHT, device_normalize=bool(d.DEVICE_PREPROC),
                              device_crop=bool(d.DEVICE_CROP)),
        seqlen=0, sample_pool=cfg.EVAL.SAMPLE_POOL, overlap=0,
        random_sample=False, random_start=False,
    )
    loader = ShardedLoader(dataset, cfg.EVAL.BATCH_SIZE, shuffle=False, rank=mesh.data_rank,
                           world_size=mesh.data_world, drop_last=False, pad=False)

    def forward(images, J_regressor=None):
        # uint8 crops normalize in the model, f32 crops pass through, and a
        # DEVICE_CROP pack of raw frames and affines is cropped here, on the device
        images = apply_device_preproc(images, d.HEIGHT, d.WIDTH)
        return model(images, smpl, J_regressor=J_regressor)

    save_path = args.output_path
    if save_path and mesh.data_world > 1:
        save_path = os.path.join(save_path, f"rank{mesh.data_rank}") if mesh.tp_rank == 0 else ""
    try:
        return Evaluator(smpl).run(
            forward, loader, seqlen=cfg.EVAL.SEQLEN, interp=cfg.EVAL.INTERPOLATION,
            dataset_name=args.eval_ds, save_path=save_path,
            batch_size=cfg.EVAL.BATCH_SIZE, verbose=rank == 0,
            # the smoke runs' opt-in, as for the body: without the real h36m
            # regressor the metrics use the native joint bank
            allow_missing_regressor=args.allow_synthetic_smpl,
        )
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main()
